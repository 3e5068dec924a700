"""Public flash-attention entry: ``flash_attention``.

Counterpart of ``repro.kernels.flash_attention.ops``. The layout is the
public (B, S, H, Dh) one. For CUDA tensors it launches kernel E
(flash.py), which masks the ragged edge itself and reads the strided
layout directly, so none of the reference's transpose-and-pad copies
remain; it raises on what the kernel cannot take. For CPU tensors it
runs the plain version, ``flash_ref``.

Kernel E is a forward only, as the reference's Pallas kernel (whose
``jax.grad`` fails): its output carries no ``grad_fn``, so a gradient
through it would vanish without a word. ``flash_attention`` therefore
refuses, on every device, an input that requires a gradient while grad
mode is on; training runs with ``use_flash_attention=False``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash import flash_cuda


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Fused GQA attention forward. q: (B, Sq, H, Dh); k, v:
    (B, Skv, KH, Dh), H % KH == 0. Returns (B, Sq, H, Dh) in q.dtype.
    Raises ``RuntimeError`` where grad mode is on and q, k or v requires
    a gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "kernel E (flash_attention) has no backward: train with "
            "use_flash_attention=False (the reference's default), or run "
            "the forward under torch.no_grad()")
    return flash_cuda(q, k, v, causal=causal)
