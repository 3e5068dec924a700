"""Flash-attention forward: the wrapper of kernel E.

Kernel E (``kernels/csrc/flash.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention/flash.py::_flash_kernel``: the GQA
attention forward with an online softmax, whose running (max m,
normalizer l, accumulator o) per query row stay on chip so that device
memory sees only q, k, v and o. One thread block owns a query tile of
one (batch, head) and walks the KV tiles in order; query head h reads
KV head h // (H / KH), with no repeated KV. Masks are the reference's:
keys at k ≥ kv_len and, when causal, keys k > q (top-left, no offset)
score −1e30; the output is o / max(l, 1e-30), rounded once to the
input dtype. Causal KV tiles wholly above the diagonal are skipped,
which is exact (key 0 is unmasked for every row, so a skipped tile
would add exp(−1e30 − m) = 0).

The input type picks the kernel, with no fall-through between them:

- bf16 runs on the tensor cores (wgmma, f32 sums), with K and V staged
  by TMA in tiles of ``ref.BLOCK_K`` keys. Its one rounding beyond the
  plain version's is p to bf16 before the PV product; its plain
  counterpart step for step is
  :func:`~repro_torch.kernels.flash_attention.ref.flash_blocked`.
- f32 runs on the CUDA cores in IEEE f32 (the tensor cores would round
  f32 to TF32, which the port forbids).

:func:`flash_cuda` reads the public (B, S, H, Dh) layout through its
strides, in place of the reference's transpose-and-pad copies. For CPU
tensors it runs the plain version,
:func:`~repro_torch.kernels.flash_attention.ref.flash_ref`.
``flash_cuda.launches`` counts kernel launches and nothing else;
``flash_cuda.launches_by_dtype`` splits them by input type.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LIBRARY, check, stream_ptr
from repro_torch.kernels.flash_attention.ref import flash_ref

HEAD_DIMS = (16, 32, 64, 128)     # head widths the kernel is built for
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as kernel E reads it: a unit-stride last axis and, for bf16
    (whose tiles TMA copies), a 16-byte-aligned address and 16-byte
    batch, sequence and head strides. A view that lacks them is copied
    into a fresh contiguous tensor; any other is read in place."""
    if t.stride(-1) != 1:
        return t.contiguous()
    if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(s * 2 % 16 for s in t.stride()[:3])):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = True, kv_len: int | None = None
               ) -> torch.Tensor:
    """Kernel E. q: (B, Sq, H, Dh); k, v: (B, Skv, KH, Dh), all f32 or
    all bf16, H % KH == 0. Returns (B, Sq, H, Dh) in q.dtype; keys at
    positions ≥ ``kv_len`` (default Skv) are masked."""
    if not q.is_cuda:
        return flash_ref(q, k, v, causal=causal, kv_len=kv_len)
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in DTYPE_IDS:
        raise ValueError(f"kernel E takes f32 or bf16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != Dh or KH == 0 or H % KH:
        raise ValueError(f"bad attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"kernel E is built for head_dim in {HEAD_DIMS}, "
                         f"got {Dh}")
    kv_len = Skv if kv_len is None else int(kv_len)
    if Skv == 0 or not 1 <= kv_len <= Skv:
        raise ValueError(f"kernel E needs 1 <= kv_len <= Skv, got kv_len "
                         f"{kv_len}, Skv {Skv}")
    q, k, v = _operand(q), _operand(k), _operand(v)
    o = torch.empty((B, Sq, H, Dh), dtype=q.dtype, device=dev)
    if B * Sq * H == 0:
        return o
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    check(LIBRARY.fn("simcache_flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        DTYPE_IDS[q.dtype], B, Sq, Skv, H, KH, Dh, *strides,
        1.0 / float(Dh) ** 0.5, int(bool(causal)), kv_len, stream_ptr(q)),
        "simcache_flash_fwd")
    flash_cuda.launches += 1
    flash_cuda.launches_by_dtype[q.dtype] += 1
    return o


flash_cuda.launches = 0
flash_cuda.launches_by_dtype = dict.fromkeys(DTYPE_IDS, 0)
