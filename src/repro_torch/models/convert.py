"""Load a parameter tree of the JAX reference into the port's model.

The reference's ``init_params`` returns a nested dict whose per-block
leaves carry a leading scanned ``layers`` axis
(``tree["blocks"]["b0_attn_mlp"]["wq"]`` is (n_layers, d, h, dh)). Given
that tree as numpy arrays, :func:`from_jax_params` builds a
``DecoderLM`` holding the same weights, one block per layer, so both
packages compute from identical parameters in the tests.
:func:`caches_from_jax` does the same for a serving cache: the
reference's dict of per-block leaves stacked on the layer axis becomes
the port's list of one dict a layer, so both packages can decode from
the same cache mid-sequence.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.schema import block_pattern, param_schema
from repro_torch.models.transformer import DecoderLM


def _block_key(bi: int, kind: str) -> str:
    return f"b{bi}_{kind.replace('+', '_')}"


def from_jax_params(cfg: ArchConfig, tree: dict,
                    device: str | torch.device | None = None) -> DecoderLM:
    """A ``DecoderLM`` holding the weights of the reference tree ``tree``
    (numpy arrays), on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    model = DecoderLM(cfg, dev)
    schema = param_schema(cfg)
    block = schema.pop("block")
    stacked = tree["blocks"][_block_key(0, block_pattern(cfg)[0])]
    with torch.no_grad():
        for name in schema:
            getattr(model, name).copy_(torch.tensor(
                np.asarray(tree[name])))
        for layer, blk in enumerate(model.blocks):
            for name in block:
                getattr(blk, name).copy_(torch.tensor(
                    np.asarray(stacked[name][layer])))
    return model


def _tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` included) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def caches_from_jax(cfg: ArchConfig, caches: dict,
                    device: str | torch.device | None = None) -> list:
    """The port's serving cache (one dict a layer: ``k``, ``v`` and, for
    an int8 cache, ``k_s``, ``v_s``) holding the reference cache tree
    ``caches`` (numpy arrays with a leading layer axis), on ``device``
    (CUDA unless named)."""
    dev = resolve_device(device)
    stacked = caches[_block_key(0, block_pattern(cfg)[0])]
    return [{name: _tensor(x[layer]).to(dev) for name, x in stacked.items()}
            for layer in range(cfg.n_layers)]
