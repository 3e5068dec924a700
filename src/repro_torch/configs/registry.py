"""Architecture registry: public arch ids → full + smoke configs.

Counterpart of ``repro.configs.registry`` for the dense decoder family:
granite-3-2b (the serving engine's repository), phi3-medium-14b,
deepseek-coder-33b and deepseek-67b. The other families (MoE, SSM,
encoder-decoder, VLM) are ROADMAP queue 1 item 14.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (deepseek_67b, deepseek_coder_33b,
                                 granite_3_2b, phi3_medium_14b)
from repro_torch.configs.base import ArchConfig

_MODULES = {
    "deepseek-67b": deepseek_67b,
    "granite-3-2b": granite_3_2b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "phi3-medium-14b": phi3_medium_14b,
}


def list_archs() -> list[str]:
    return sorted(_MODULES)


def get_config(arch: str) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    mod = _MODULES[arch]
    if hasattr(mod, "SMOKE"):
        return mod.SMOKE
    return reduce_config(mod.CONFIG)


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Family-preserving tiny version of a dense config (the reference's
    reduction restricted to the dense family)."""
    from repro_torch.models.schema import block_pattern
    period = len(block_pattern(cfg))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=period * min(2, max(1, cfg.n_layers // period)),
        d_model=128,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        dense_ff=256 if cfg.dense_ff else 0,
        vocab=512,
        ssm_dt_rank=8,
        xlstm_chunk=16,
        param_dtype="float32",
        compute_dtype="float32",
    )
