"""Plain PyTorch version of the flash-attention kernel: standard
(unfused) GQA attention with the same semantics (f32 softmax, masks at
−1e30, top-left causal). Counterpart of
``repro.kernels.flash_attention.ref``; kernel E (flash.py) is held
against it on the card, and it is what ``flash_attention`` runs on CPU
tensors."""
from __future__ import annotations

import torch

from repro_torch.models.layers import gqa_attention


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              kv_len: int | torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Skv, KH, Dh) → (B, Sq, H, Dh)."""
    return gqa_attention(q, k, v, causal=causal, kv_len=kv_len)
