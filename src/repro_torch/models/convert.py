"""Move parameter trees between the JAX reference's layout and the
port's model, both ways.

The reference's ``init_params`` returns a nested dict whose per-block
leaves carry a leading scanned super-block axis
(``tree["blocks"]["b0_attn_mlp"]["wq"]`` is (n_super, d, h, dh)), and
an encoder-decoder's encoder layers stacked likewise under
``tree["enc_blocks"]["enc"]``. Given that tree as numpy arrays,
:func:`from_jax_params` builds a ``DecoderLM`` holding the same weights,
one block per layer (layer ``l = s·period + bi`` reads
``tree["blocks"][f"b{bi}_{kind}"][name][s]``), so both packages compute
from identical parameters in the tests. :func:`caches_from_jax` does
the same for a serving cache of any kind (K/V, int8 K/V, cross K/V,
Mamba, mLSTM and sLSTM states), so both packages can decode from the
same cache mid-sequence. The other way, :func:`to_jax_params` stacks a
model's weights back into the reference's tree, and :func:`to_jax_tree`
/ :func:`from_jax_tree` do the same for any per-parameter values (the
optimizer's moments, int8 ``{"q", "s"}`` pairs included), so a
checkpoint written by either package restores in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.schema import block_pattern, layer_kinds
from repro_torch.models.transformer import DecoderLM


def as_tensor(a) -> torch.Tensor:
    """A numpy array as a tensor (a tensor as itself). bfloat16 from
    ``ml_dtypes``, and the raw two-byte ``|V2`` records ``np.savez``
    writes for it, become bf16."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype.str == "|V2":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def host_array(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as a numpy array on the host (never a view of a
    live parameter, which a trainer updates in place); bf16 as the
    ``|V2`` records the reference's checkpoints hold for it (numpy has
    no bf16)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view("|V2")
    return t.numpy()


def _layer_slices(cfg: ArchConfig) -> list[tuple[str, int]]:
    """(block key, super-block index) of every decoder layer."""
    period = len(block_pattern(cfg))
    return [(key, layer // period)
            for layer, (key, _) in enumerate(layer_kinds(cfg))]


def _tree_slots(cfg: ArchConfig, model: DecoderLM) -> dict:
    """Each parameter's place in the reference tree: port name (as
    ``named_parameters`` gives it) → (tree path, index on the stacked
    axis, or None for an unstacked leaf)."""
    slots = {name: ((name,), None)
             for name, _ in model.named_parameters(recurse=False)}
    for i, ((key, s), blk) in enumerate(zip(_layer_slices(cfg),
                                            model.blocks)):
        for name, _ in blk.named_parameters():
            slots[f"blocks.{i}.{name}"] = (("blocks", key, name), s)
    for i, blk in enumerate(model.enc_blocks):
        for name, _ in blk.named_parameters():
            slots[f"enc_blocks.{i}.{name}"] = (("enc_blocks", "enc", name),
                                               i)
    return slots


def _take(v, idx: int | None) -> torch.Tensor:
    """Entry ``idx`` of a stacked leaf (the whole leaf for None) as a
    tensor; a numpy stack is sliced before it is copied."""
    if idx is None:
        return as_tensor(v)
    if isinstance(v, torch.Tensor):
        return v[idx]
    return as_tensor(np.asarray(v)[idx])


def _leaf(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def from_jax_tree(cfg: ArchConfig, model: DecoderLM, tree: dict) -> dict:
    """Per-parameter values of ``model`` (port name → tensor, or a dict of
    tensors such as an int8 moment's ``{"q", "s"}``) read from ``tree``,
    a tree in the reference's layout of numpy arrays or tensors: the
    inverse of :func:`to_jax_tree`. Tensors stay on their device."""
    out = {}
    for name, (path, idx) in _tree_slots(cfg, model).items():
        leaf = _leaf(tree, path)
        parts = leaf if isinstance(leaf, dict) else {None: leaf}
        got = {k: _take(v, idx) for k, v in parts.items()}
        out[name] = got if isinstance(leaf, dict) else got[None]
    return out


def to_jax_tree(cfg: ArchConfig, model: DecoderLM, values: dict) -> dict:
    """``values`` (port name → tensor, or a dict of tensors) as a tree in
    the reference's layout of numpy arrays: per-layer values stacked on
    the super-block axis under ``blocks/<key>/<name>``, the encoder's
    under ``enc_blocks/enc/<name>``, a dict of tensors as a sub-tree."""
    stacks: dict = {}
    for name, (path, idx) in _tree_slots(cfg, model).items():
        v = values[name]
        parts = v if isinstance(v, dict) else {None: v}
        for k, t in parts.items():
            full = path if k is None else path + (k,)
            if idx is None:
                stacks[full] = host_array(t)
            else:
                stacks.setdefault(full, {})[idx] = host_array(t)
    tree: dict = {}
    for full, v in stacks.items():
        if isinstance(v, dict):          # stacked: indices 0..n-1
            v = np.stack([v[i] for i in range(len(v))])
        node = tree
        for key in full[:-1]:
            node = node.setdefault(key, {})
        node[full[-1]] = v
    return tree


def to_jax_params(cfg: ArchConfig, model: DecoderLM) -> dict:
    """The reference's parameter tree (numpy arrays) of ``model``'s
    weights: the inverse of :func:`from_jax_params`."""
    return to_jax_tree(cfg, model, dict(model.named_parameters()))


def from_jax_params(cfg: ArchConfig, tree: dict,
                    device: str | torch.device | None = None) -> DecoderLM:
    """A ``DecoderLM`` holding the weights of the reference tree ``tree``
    (numpy arrays or tensors), on ``device`` (CUDA unless named), its
    parameters without a gradient."""
    dev = resolve_device(device)
    model = DecoderLM(cfg, dev)
    values = from_jax_tree(cfg, model, tree)
    with torch.no_grad():
        for name, t in model.named_parameters():
            t.copy_(values[name])
    return model


def caches_from_jax(cfg: ArchConfig, caches: dict,
                    device: str | torch.device | None = None) -> list:
    """The port's serving cache (one dict a layer) holding the reference
    cache tree ``caches`` (per-block dicts of numpy arrays with a leading
    super-block axis), on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    return [{name: as_tensor(np.asarray(x)[s]).to(dev)
             for name, x in caches[key].items()}
            for key, s in _layer_slices(cfg)]
