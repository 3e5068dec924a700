"""Plain PyTorch versions of the flash-attention kernel.

:func:`flash_ref` is standard (unfused) GQA attention with the kernel's
semantics (f32 softmax, masks at −1e30, top-left causal). It is the
counterpart of ``repro.kernels.flash_attention.ref``, what
``flash_attention`` runs on CPU tensors, and what kernel E (flash.py) is
held against on the card.

:func:`flash_blocked` walks the KV tiles as kernel E's bf16 path does,
with the online softmax in f32, and rounds p to a given type before the
PV product: the one rounding that path adds. With ``p_dtype=float32`` it
computes :func:`flash_ref`'s function; with ``bfloat16`` it is the bf16
kernel's plain counterpart step for step, which the card holds it to
within one bf16 output step.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import gqa_attention

BLOCK_K = 128          # keys per KV tile of kernel E's bf16 path (kBN)
P_REL = 2.0 ** -13     # how far that kernel's f32 p may sit from this one's
LOG2E = 1.4426950408889634
NEG = -1.0e30


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              kv_len: int | torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Skv, KH, Dh) → (B, Sq, H, Dh)."""
    return gqa_attention(q, k, v, causal=causal, kv_len=kv_len)


def flash_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, kv_len: int | None = None, *,
                  p_dtype: torch.dtype = torch.float32, p_rel: float = 0.0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The online softmax over KV tiles of :data:`BLOCK_K` keys, in order.

    q: (B, Sq, H, Dh); k, v: (B, Skv, KH, Dh). Per tile, in f32: scores
    scaled by scale·log₂e after the dot product (masked keys at −1e30),
    running max m, p = 2^(t − m), l = l·2^(m_prev − m) + Σ p (f32 p), and
    o = o·2^(m_prev − m) + round(p)·v, with round to ``p_dtype``; at the
    end o / max(l, 1e-30), in q.dtype.

    Returns (o, slack). slack (B, Sq, H, Dh), f32, is Σ_t w_t·|v_t| / l,
    where w_t is the gap between the ``p_dtype`` values that
    p_t·(1 − p_rel) and p_t·(1 + p_rel) round to: the most that p's
    rounding can move o when p itself is known only to a relative
    ``p_rel`` (as the kernel's p, from other f32 sums and a hardware
    exponential, is: :data:`P_REL`). It is zero where no such rounding
    can flip, and everywhere when ``p_rel`` is 0.
    """
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    dev, f32 = q.device, torch.float32
    kv_len = Skv if kv_len is None else int(kv_len)
    # the kernel's factor: scale and log2(e), each f32, multiplied in f32
    sl2 = (torch.tensor(1.0 / math.sqrt(Dh), dtype=f32)
           * torch.tensor(LOG2E, dtype=f32)).to(dev)
    qg = q.float().reshape(B, Sq, KH, G, Dh)
    rows = torch.arange(Sq, device=dev)[:, None]
    m = torch.full((B, KH, G, Sq), NEG, dtype=f32, device=dev)
    l = torch.zeros((B, KH, G, Sq), dtype=f32, device=dev)
    acc = torch.zeros((B, KH, G, Sq, Dh), dtype=f32, device=dev)
    slack = torch.zeros_like(acc)
    for k0 in range(0, min(kv_len, Skv), BLOCK_K):
        kt = k[:, k0:k0 + BLOCK_K].float()
        vt = v[:, k0:k0 + BLOCK_K].float()
        t = torch.einsum("bskgd,btkd->bkgst", qg, kt) * sl2
        cols = torch.arange(k0, k0 + kt.shape[1], device=dev)[None, :]
        keep = cols < kv_len
        if causal:
            keep = keep & (cols <= rows)
        t = torch.where(keep, t, NEG)
        m_new = torch.maximum(m, t.amax(-1))
        corr = torch.exp2(m - m_new)[..., None]
        p = torch.exp2(t - m_new[..., None])
        l = l * corr[..., 0] + p.sum(-1)
        pr = p.to(p_dtype).float()
        acc = acc * corr + torch.einsum("bkgst,btkd->bkgsd", pr, vt)
        if p_rel:
            w = ((p * (1 + p_rel)).to(p_dtype).float()
                 - (p * (1 - p_rel)).to(p_dtype).float())
            slack = slack * corr + torch.einsum("bkgst,btkd->bkgsd", w,
                                                vt.abs())
        m = m_new
    den = l.clamp_min(1e-30)[..., None]

    def public(x):                        # (B, KH, G, Sq, Dh) → (B, Sq, H, Dh)
        return x.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh)

    return public(acc / den).to(q.dtype), public(slack / den)
