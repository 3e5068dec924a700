"""Load a parameter tree of the JAX reference into the port's model.

The reference's ``init_params`` returns a nested dict whose per-block
leaves carry a leading scanned ``layers`` axis
(``tree["blocks"]["b0_attn_mlp"]["wq"]`` is (n_layers, d, h, dh)). Given
that tree as numpy arrays, :func:`from_jax_params` builds a
``DecoderLM`` holding the same weights, one block per layer, so both
packages compute from identical parameters in the tests.
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
