"""Public flash-attention entry: ``flash_attention``.

Counterpart of ``repro.kernels.flash_attention.ops``. The layout is the
public (B, S, H, Dh) one. For CUDA tensors it launches kernel E
(flash.py), which masks the ragged edge itself and reads the strided
layout directly, so none of the reference's transpose-and-pad copies
remain; it raises on what the kernel cannot take. For CPU tensors it
runs the plain version, ``flash_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash import flash_cuda


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Fused GQA attention forward. q: (B, Sq, H, Dh); k, v:
    (B, Skv, KH, Dh), H % KH == 0. Returns (B, Sq, H, Dh) in q.dtype."""
    return flash_cuda(q, k, v, causal=causal)
