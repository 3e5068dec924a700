"""Transformer building blocks: RMS and layer norm, RoPE and M-RoPE,
grouped-query attention, SwiGLU and GELU MLPs.

Counterpart of ``repro.models.layers``. Softmax and normalization
statistics are computed in f32 whatever the compute dtype (bf16 on the
card).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """Standard (rotate-half) RoPE. x: (B, S, H, Dh); positions: (B, S)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)       # (Dh/2,)
    ang = positions[..., None].float() * inv             # (B, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections: tuple,
                theta: float = 1e4) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL). x: (B, S, H, Dh); ``positions`` (3, B,
    S): temporal, height and width ids. The Dh/2 frequency pairs are
    split into ``sections`` (e.g. (16, 24, 24) for Dh 128), each rotated
    by its own position stream."""
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover "
                         f"head_dim / 2 = {dh // 2}")
    inv = rope_freqs(dh, theta, x.device)                # (Dh/2,)
    sec_ids = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.as_tensor(sections, device=x.device),
        output_size=dh // 2)                              # (Dh/2,)
    pos_per_freq = positions.float()[sec_ids]            # (Dh/2, B, S)
    ang = pos_per_freq.movedim(0, -1) * inv              # (B, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  kv_len: int | torch.Tensor | None = None) -> torch.Tensor:
    """Grouped-query attention. q: (B, Sq, H, Dh); k, v: (B, Skv, KH, Dh)
    with H % KH == 0. Causal is top-left (key t ≤ query s); ``kv_len``
    masks out keys at t ≥ kv_len. Masked scores are −1e30, as in the
    reference. Returns (B, Sq, H, Dh); softmax in f32."""
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KH, H // KH, Dh)
    scale = 1.0 / math.sqrt(Dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) * scale            # (B,KH,G,Sq,Skv)
    tpos = torch.arange(Skv, device=q.device)[None, :]
    if causal:
        keep = tpos <= torch.arange(Sq, device=q.device)[:, None]
        scores = torch.where(keep, scores, -1e30)
    if kv_len is not None:
        scores = torch.where(tpos < kv_len, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x·Wg) ⊙ (x·Wu))·Wd. Weights: (D, F), (D, F), (F, D)."""
    g = F.silu(torch.einsum("bsd,df->bsf", x, w_gate.to(x.dtype)))
    u = torch.einsum("bsd,df->bsf", x, w_up.to(x.dtype))
    return torch.einsum("bsf,fd->bsd", g * u, w_down.to(x.dtype))


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """Whisper-style GELU MLP with biases. The GELU is the tanh form,
    ``jax.nn.gelu``'s default (the exact erf form differs by ~1e-3)."""
    h = F.gelu(torch.einsum("bsd,df->bsf", x, w_up.to(x.dtype))
               + b_up.to(x.dtype), approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, w_down.to(x.dtype)) \
        + b_down.to(x.dtype)
