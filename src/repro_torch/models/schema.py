"""Declarative parameter schema of every architecture.

Counterpart of ``repro.models.schema``: the same names, shapes, logical
sharding axes and initializer scales, so a parameter tree of the JAX
reference maps one to one onto the port's modules (models/convert.py).
The reference stacks the parameters of each block of its super-block
pattern on a leading scanned ``layers`` axis; the port keeps one module
per layer: layer ``l = s·period + bi`` is super-block ``s``'s block
``bi`` (:func:`layer_kinds`). :func:`stacked_schema` gives the
reference's stacked tree, the layout of checkpoints and of the mesh
policy's spec trees (launch/sharding.py).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                      # logical axis names, len == len(shape)
    init: str = "normal"             # normal | zeros | ones | mamba_a | mamba_dt
    scale: float = 0.02

    def make(self, gen: torch.Generator, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if self.init == "mamba_a":        # A_log = log(1..N) per channel
            n = self.shape[-1]
            a = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                       device=device))
            return a.expand(self.shape).to(dtype).contiguous()
        if self.init == "mamba_dt":       # dt bias ~ softplus^-1(0.001..0.1)
            lo, hi = 1e-3, 1e-1
            u = torch.rand(self.shape, generator=gen, dtype=torch.float32,
                           device=device)
            dt = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
            return torch.log(torch.expm1(dt)).to(dtype)
        out = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                          device=device)
        return out.mul_(self.scale).to(dtype)


# ------------------------------------------------------------ block kinds
def attn_specs(cfg: ArchConfig, cross: bool = False) -> dict:
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pfx = "x" if cross else ""
    out = {
        f"{pfx}attn_norm": ParamSpec((d,), ("embed",), "ones"),
        f"{pfx}wq": ParamSpec((d, h, dh), ("embed", "heads", "head_dim")),
        f"{pfx}wk": ParamSpec((d, kh, dh),
                              ("embed", "kv_heads", "head_dim")),
        f"{pfx}wv": ParamSpec((d, kh, dh),
                              ("embed", "kv_heads", "head_dim")),
        f"{pfx}wo": ParamSpec((h, dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias and not cross:
        out["bq"] = ParamSpec((h, dh), ("heads", "head_dim"), "zeros")
        out["bk"] = ParamSpec((kh, dh), ("kv_heads", "head_dim"), "zeros")
        out["bv"] = ParamSpec((kh, dh), ("kv_heads", "head_dim"), "zeros")
    return out


def mlp_specs(cfg: ArchConfig, ff: int) -> dict:
    d = cfg.d_model
    return {
        "mlp_norm": ParamSpec((d,), ("embed",), "ones"),
        "w_gate": ParamSpec((d, ff), ("embed", "ff")),
        "w_up": ParamSpec((d, ff), ("embed", "ff")),
        "w_down": ParamSpec((ff, d), ("ff", "embed")),
    }


def gelu_mlp_specs(cfg: ArchConfig, ff: int) -> dict:
    d = cfg.d_model
    return {
        "mlp_norm": ParamSpec((d,), ("embed",), "ones"),
        "mlp_norm_b": ParamSpec((d,), ("embed",), "zeros"),
        "w_up": ParamSpec((d, ff), ("embed", "ff")),
        "b_up": ParamSpec((ff,), ("ff",), "zeros"),
        "w_down": ParamSpec((ff, d), ("ff", "embed")),
        "b_down": ParamSpec((d,), ("embed",), "zeros"),
    }


def moe_specs(cfg: ArchConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    return {
        "moe_norm": ParamSpec((d,), ("embed",), "ones"),
        "router": ParamSpec((d, e), ("embed", None)),
        "we_gate": ParamSpec((e, d, f), ("experts", "embed", "ff")),
        "we_up": ParamSpec((e, d, f), ("experts", "embed", "ff")),
        "we_down": ParamSpec((e, f, d), ("experts", "ff", "embed")),
    }


def mamba_specs(cfg: ArchConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    n, dtr, cw = cfg.ssm_state, cfg.ssm_dt_rank, cfg.ssm_conv
    return {
        "m_norm": ParamSpec((d,), ("embed",), "ones"),
        "in_proj": ParamSpec((d, 2 * di), ("embed", "ff")),
        "conv_w": ParamSpec((cw, di), (None, "ff")),
        "conv_b": ParamSpec((di,), ("ff",), "zeros"),
        "x_proj": ParamSpec((di, dtr + 2 * n), ("ff", None)),
        "dt_w": ParamSpec((dtr, di), (None, "ff")),
        "dt_b": ParamSpec((di,), ("ff",), "mamba_dt"),
        "A_log": ParamSpec((di, n), ("ff", None), "mamba_a"),
        "Dskip": ParamSpec((di,), ("ff",), "ones"),
        "out_proj": ParamSpec((di, d), ("ff", "embed")),
    }


def mlstm_specs(cfg: ArchConfig) -> dict:
    """mLSTM block in a ``ssm_expand``×-projected space (di = expand·d)."""
    d, nh = cfg.d_model, cfg.n_heads
    di = cfg.ssm_expand * d
    dh = di // nh
    return {
        "m_norm": ParamSpec((d,), ("embed",), "ones"),
        "wq": ParamSpec((d, nh, dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, nh, dh), ("embed", "heads", "head_dim")),
        "wv": ParamSpec((d, nh, dh), ("embed", "heads", "head_dim")),
        "w_if": ParamSpec((d, 2, nh), ("embed", None, "heads")),
        "w_og": ParamSpec((d, di), ("embed", "ff")),
        "w_out": ParamSpec((di, d), ("ff", "embed")),
    }


def slstm_specs(cfg: ArchConfig) -> dict:
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    return {
        "s_norm": ParamSpec((d,), ("embed",), "ones"),
        "w_izfo": ParamSpec((d, 4, nh, dh),
                            ("embed", None, "heads", "head_dim")),
        "r_izfo": ParamSpec((4, nh, dh, dh),
                            (None, "heads", "head_dim", None), scale=0.01),
        "b_izfo": ParamSpec((4, nh, dh), (None, "heads", "head_dim"),
                            "zeros"),
        "w_sout": ParamSpec((d, d), ("ff", "embed")),
    }


# ----------------------------------------------------------- block layout
def block_pattern(cfg: ArchConfig) -> list[str]:
    """The per-super-block sequence of block kinds, the same in every
    super-block. Kinds: attn+mlp | attn+moe | mamba+mlp | mamba+moe |
    mlstm | slstm. Raises ``ValueError`` where ``n_layers`` is not a
    whole number of super-blocks (the reference asserts)."""
    if cfg.xlstm:
        pat = ["slstm" if (i + 1) % cfg.slstm_every == 0 else "mlstm"
               for i in range(cfg.slstm_every)]
    else:
        period = max(cfg.attn_every, 1) if cfg.attn_every else 1
        period = int(np.lcm(period,
                            cfg.moe_every if cfg.moe_experts else 1))
        pat = [("attn" if cfg.is_attn_layer(i) else "mamba") + "+"
               + ("moe" if cfg.is_moe_layer(i) else "mlp")
               for i in range(period)]
    if cfg.n_layers % len(pat):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a "
                         f"whole number of {len(pat)}-block super-blocks")
    return pat


def block_key(bi: int, kind: str) -> str:
    """The reference's key of block ``bi`` of the pattern."""
    return f"b{bi}_{kind.replace('+', '_')}"


def layer_kinds(cfg: ArchConfig) -> list[tuple[str, str]]:
    """(block key, kind) of every decoder layer, in order."""
    pattern = block_pattern(cfg)
    return [(block_key(i % len(pattern), pattern[i % len(pattern)]),
             pattern[i % len(pattern)]) for i in range(cfg.n_layers)]


def block_specs(cfg: ArchConfig, kind: str) -> dict:
    """One layer's specs of block ``kind`` (with the decoder's cross
    attention, ``x…``, in an encoder-decoder)."""
    if kind == "mlstm":
        out = mlstm_specs(cfg)
    elif kind == "slstm":
        out = slstm_specs(cfg)
    else:
        mixer, ffn = kind.split("+")
        out = dict(attn_specs(cfg) if mixer == "attn" else mamba_specs(cfg))
        if ffn == "moe":
            out.update(moe_specs(cfg))
        else:
            out.update(mlp_specs(cfg, cfg.dense_ff if cfg.dense_ff
                                 else cfg.d_ff))
    if cfg.is_encdec:
        out.update(attn_specs(cfg, cross=True))
    return out


def enc_block_specs(cfg: ArchConfig) -> dict:
    """One encoder layer's specs: attention and a GELU MLP."""
    out = dict(attn_specs(cfg))
    out.update(gelu_mlp_specs(cfg, cfg.d_ff))
    return out


def param_schema(cfg: ArchConfig) -> dict:
    """Top-level specs (embedding, final norm, untied head, the stubs'
    projections, the encoder's final norm), one layer's specs of each
    block of the pattern under ``"blocks"`` (keyed as the reference's)
    and, in an encoder-decoder, one encoder layer's under
    ``"enc_blocks"``."""
    d, vp = cfg.d_model, cfg.padded_vocab
    schema: dict = {
        "embed": ParamSpec((vp, d), ("vocab", "embed")),
        "final_norm": ParamSpec((d,), ("embed",), "ones"),
        "blocks": {block_key(bi, kind): block_specs(cfg, kind)
                   for bi, kind in enumerate(block_pattern(cfg))},
    }
    if not cfg.tie_embeddings:
        schema["lm_head"] = ParamSpec((d, vp), ("embed", "vocab"))
    if cfg.is_encdec:
        schema["enc_blocks"] = {"enc": enc_block_specs(cfg)}
        schema["enc_final_norm"] = ParamSpec((d,), ("embed",), "ones")
    if cfg.frontend == "vision_stub":
        schema["vision_proj"] = ParamSpec((1280, d), (None, "embed"))
    if cfg.frontend == "audio_stub":
        schema["audio_proj"] = ParamSpec((128, d), (None, "embed"))
    return schema



def _stack(specs: dict, n: int) -> dict:
    """Add the scanned leading "layers" axis to every spec."""
    return {k: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init,
                         s.scale) for k, s in specs.items()}


def stacked_schema(cfg: ArchConfig) -> dict:
    """The reference's ``param_schema``: :func:`param_schema` with every
    block's specs stacked over the ``n_super`` super-blocks and the
    encoder's over its ``n_enc_layers`` layers."""
    schema = param_schema(cfg)
    n_super = cfg.n_layers // len(block_pattern(cfg))
    schema["blocks"] = {k: _stack(v, n_super)
                        for k, v in schema["blocks"].items()}
    if "enc_blocks" in schema:
        schema["enc_blocks"] = {"enc": _stack(schema["enc_blocks"]["enc"],
                                              cfg.n_enc_layers)}
    return schema

def param_count(cfg: ArchConfig, padded: bool = False) -> int:
    """Total parameter count from the schema (vocab padding excluded by
    default so the number matches the published size): each block's
    specs counted once a super-block, the encoder's once an encoder
    layer (the reference's stacks). Nothing is allocated."""
    schema = param_schema(cfg)
    n_super = cfg.n_layers // len(block_pattern(cfg))
    reps = {"blocks": n_super, "enc_blocks": cfg.n_enc_layers}
    vp, v = cfg.padded_vocab, cfg.vocab
    total = 0
    for key, s in schema.items():
        if key in reps:
            total += reps[key] * sum(math.prod(x.shape) for specs in
                                     s.values() for x in specs.values())
            continue
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
