"""Declarative parameter schema of the dense decoder.

Counterpart of ``repro.models.schema`` for the dense family: the same
names, shapes and initializer scales, so a parameter tree of the JAX
reference maps one to one onto the port's modules (models/convert.py).
The reference stacks per-block parameters on a leading scanned
``layers`` axis; the port keeps one module per layer and unstacks.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    init: str = "normal"             # normal | zeros | ones
    scale: float = 0.02

    def make(self, gen: torch.Generator, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        out = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                          device=device)
        return out.mul_(self.scale).to(dtype)


def attn_specs(cfg: ArchConfig) -> dict:
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "attn_norm": ParamSpec((d,), "ones"),
        "wq": ParamSpec((d, h, dh)),
        "wk": ParamSpec((d, kh, dh)),
        "wv": ParamSpec((d, kh, dh)),
        "wo": ParamSpec((h, dh, d)),
    }


def mlp_specs(cfg: ArchConfig, ff: int) -> dict:
    d = cfg.d_model
    return {
        "mlp_norm": ParamSpec((d,), "ones"),
        "w_gate": ParamSpec((d, ff)),
        "w_up": ParamSpec((d, ff)),
        "w_down": ParamSpec((ff, d)),
    }


def block_pattern(cfg: ArchConfig) -> list[str]:
    """The per-super-block sequence of block kinds. Only the dense
    decoder (``attn+mlp`` on every layer) is ported."""
    dense = not (cfg.xlstm or cfg.attn_every or cfg.moe_experts
                 or cfg.is_encdec or cfg.mrope or cfg.qkv_bias
                 or cfg.frontend != "none")
    if not dense:
        raise NotImplementedError(
            f"{cfg.name}: only the dense decoder is ported; the other "
            "families arrive with ROADMAP queue 1 item 14")
    return ["attn+mlp"]


def block_specs(cfg: ArchConfig) -> dict:
    block_pattern(cfg)
    out = dict(attn_specs(cfg))
    out.update(mlp_specs(cfg, cfg.dense_ff if cfg.dense_ff else cfg.d_ff))
    return out


def param_schema(cfg: ArchConfig) -> dict:
    """Top-level specs (embedding, final norm, untied head) and the
    per-layer block specs under ``"block"``."""
    d, vp = cfg.d_model, cfg.padded_vocab
    schema: dict = {
        "embed": ParamSpec((vp, d)),
        "final_norm": ParamSpec((d,), "ones"),
        "block": block_specs(cfg),
    }
    if not cfg.tie_embeddings:
        schema["lm_head"] = ParamSpec((d, vp))
    return schema


def param_count(cfg: ArchConfig, padded: bool = False) -> int:
    """Total parameter count from the schema (vocab padding excluded by
    default so the number matches the published size). The block specs
    are one layer's, counted ``n_layers`` times (the reference's stack).
    Nothing is allocated."""
    schema = param_schema(cfg)
    block = schema.pop("block")
    vp, v = cfg.padded_vocab, cfg.vocab
    total = cfg.n_layers * sum(math.prod(s.shape) for s in block.values())
    for key, s in schema.items():
        n = math.prod(s.shape)
        if not padded and key in ("embed", "lm_head"):
            n = n // vp * v
        total += n
    return total


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters touched per token (MoE: only top-k experts active)."""
    total = param_count(cfg)
    if cfg.moe_experts:
        per_expert = 3 * cfg.d_model * cfg.d_ff
        n_moe = sum(1 for i in range(cfg.n_layers) if cfg.is_moe_layer(i))
        total -= n_moe * (cfg.moe_experts - cfg.moe_topk) * per_expert
    return total
