"""Public model API: ``init_params`` and ``make_prefill``.

Counterpart of ``repro.models.model`` for what the serving engine
calls. ``init_params`` returns the model itself — an ``nn.Module`` whose
parameters play the role of the reference's parameter tree — with
random weights drawn on ``device`` from a seeded ``torch.Generator``
(the reference's ``jax.random`` draws are not reproduced; tests that
compare against it load the JAX weights through models/convert.py).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.schema import param_schema
from repro_torch.models.transformer import DecoderLM


def init_params(cfg: ArchConfig, seed: int = 0,
                device: str | torch.device | None = None) -> DecoderLM:
    """A randomly initialized model on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    model = DecoderLM(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    schema = param_schema(cfg)
    block = schema.pop("block")
    dtype = getattr(torch, cfg.param_dtype)
    with torch.no_grad():
        for name in sorted(schema):
            getattr(model, name).copy_(schema[name].make(gen, dtype, dev))
        for blk in model.blocks:
            for name in sorted(block):
                getattr(blk, name).copy_(block[name].make(gen, dtype, dev))
    return model


def make_prefill(cfg: ArchConfig) -> Callable:
    """(params, batch) → (logits, caches): the full-sequence forward the
    engine runs on its misses, with ``cfg`` — not the config ``params``
    was built with — deciding the attention (``use_flash_attention``),
    as in the reference. ``params`` is the model."""
    def prefill(params: DecoderLM, batch: dict):
        with torch.inference_mode():
            return params(batch["tokens"], batch.get("positions"), cfg=cfg)
    return prefill
