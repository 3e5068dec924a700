"""Load a parameter tree of the JAX reference into the port's model.

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
same cache mid-sequence.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.schema import block_pattern, layer_kinds
from repro_torch.models.transformer import DecoderLM


def _tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` included) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _layer_slices(cfg: ArchConfig) -> list[tuple[str, int]]:
    """(block key, super-block index) of every decoder layer."""
    period = len(block_pattern(cfg))
    return [(key, layer // period)
            for layer, (key, _) in enumerate(layer_kinds(cfg))]


def from_jax_params(cfg: ArchConfig, tree: dict,
                    device: str | torch.device | None = None) -> DecoderLM:
    """A ``DecoderLM`` holding the weights of the reference tree ``tree``
    (numpy arrays), on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    model = DecoderLM(cfg, dev)
    with torch.no_grad():
        for name, t in model.named_parameters(recurse=False):
            t.copy_(_tensor(tree[name]))
        for (key, s), blk in zip(_layer_slices(cfg), model.blocks):
            for name, t in blk.named_parameters():
                t.copy_(_tensor(np.asarray(tree["blocks"][key][name])[s]))
        for i, blk in enumerate(model.enc_blocks):
            for name, t in blk.named_parameters():
                t.copy_(_tensor(
                    np.asarray(tree["enc_blocks"]["enc"][name])[i]))
    return model


def caches_from_jax(cfg: ArchConfig, caches: dict,
                    device: str | torch.device | None = None) -> list:
    """The port's serving cache (one dict a layer) holding the reference
    cache tree ``caches`` (per-block dicts of numpy arrays with a leading
    super-block axis), on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    return [{name: _tensor(np.asarray(x)[s]).to(dev)
             for name, x in caches[key].items()}
            for key, s in _layer_slices(cfg)]
