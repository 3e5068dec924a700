"""Architecture registry: public arch ids → full + smoke configs.

Counterpart of ``repro.configs.registry``: the same ten architectures
— the dense decoders granite-3-2b (the serving engine's repository),
phi3-medium-14b, deepseek-coder-33b and deepseek-67b; the MoE decoders
granite-moe-3b-a800m and dbrx-132b; the Mamba/attention/MoE hybrid
jamba-1.5-large-398b; the recurrent xlstm-350m; the encoder-decoder
whisper-small; the M-RoPE VLM qwen2-vl-7b — each with a full config and
a family-preserving smoke config (the reference's reduction).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (dbrx_132b, deepseek_67b,
                                 deepseek_coder_33b, granite_3_2b,
                                 granite_moe_3b_a800m, jamba_1_5_large_398b,
                                 phi3_medium_14b, qwen2_vl_7b, whisper_small,
                                 xlstm_350m)
from repro_torch.configs.base import ArchConfig

_MODULES = {
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "deepseek-67b": deepseek_67b,
    "granite-3-2b": granite_3_2b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "phi3-medium-14b": phi3_medium_14b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "dbrx-132b": dbrx_132b,
    "xlstm-350m": xlstm_350m,
    "whisper-small": whisper_small,
    "qwen2-vl-7b": qwen2_vl_7b,
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
    """Family-preserving tiny version of a config (same block pattern),
    the reference's reduction field for field."""
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
        moe_experts=min(cfg.moe_experts, 4),
        moe_topk=min(cfg.moe_topk, 2),
        capacity_factor=-1.0 if cfg.moe_experts else cfg.capacity_factor,
        n_enc_layers=2 if cfg.is_encdec else 0,
        cross_len=64 if cfg.is_encdec else cfg.cross_len,
        ssm_dt_rank=8,
        xlstm_chunk=16,
        mrope_sections=(8, 4, 4) if cfg.mrope else cfg.mrope_sections,
        param_dtype="float32",
        compute_dtype="float32",
    )
