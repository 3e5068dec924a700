"""Kernel E's bf16 (tensor-core) path, checked on the CPU through its
plain counterpart ``flash_blocked``.

The bf16 kernel walks KV tiles of 128 keys with the online softmax in
f32 and rounds each p to bf16 before the PV product. ``flash_blocked``
does the same in plain PyTorch; the card holds the kernel to it within
one bf16 output step (tests/test_torch_gpu.py, chip_smoke.py). Here,
with inputs drawn by numpy from a seed:

- with ``p_dtype=float32`` it computes the reference's function: it
  equals ``flash_ref`` and the JAX package's Pallas kernel (interpret
  mode) to 3e-5, the reference's own f32 tolerance;
- with ``p_dtype=bfloat16`` its error against the Pallas kernel (bf16
  inputs, output rounded to bf16) stays inside the bound derived from
  the one new rounding: 2^-7·|ref| + 2^-7·flash_ref(q, k, |v|) + 1e-4
  (p rounded once, |δp| ≤ 2^-8·p, so the PV sum moves by at most
  2^-8·Σ p·|v| / l; both outputs rounded once; twice each term, and
  1e-4 for f32 sums near zero) — on every element, with a ragged S,
  ``kv_len`` < Skv and Dh 16 and 128;
- its slack bounds what a p known only to a relative ``p_rel`` can do
  to the output, which is what the card's tight comparison relies on.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention.flash import flash_pallas
from repro_torch.kernels.flash_attention import flash_blocked, flash_ref
from repro_torch.kernels.flash_attention.flash import _operand
from repro_torch.kernels.flash_attention.ref import P_REL

CASES = [
    # (B, Sq, Skv, H, KH, Dh, causal): tests/test_torch_flash.py's cases
    (2, 64, 64, 4, 2, 32, True),
    (1, 100, 100, 8, 8, 64, True),
    (2, 37, 37, 4, 1, 16, True),
    (1, 64, 128, 4, 2, 32, False),
    (2, 256, 256, 8, 2, 128, True),
    (1, 1, 64, 4, 4, 32, False),
]
BF16_CASES = CASES + [
    # (..., kv_len): three KV tiles, the last ragged; kv_len < Skv
    (1, 300, 300, 4, 2, 64, True, None),
    (2, 70, 200, 4, 2, 32, False, 150),
    (2, 70, 200, 4, 2, 32, True, 150),
    (1, 150, 260, 2, 1, 128, False, 131),
]
U7 = 2.0 ** -7


def _qkv(seed, B, Sq, Skv, H, KH, Dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, Sq, H, Dh), (B, Skv, KH, Dh), (B, Skv, KH, Dh)))


def _pad(x, mult):
    pad = (-x.shape[1]) % mult
    return jnp.pad(x, ((0, 0), (0, pad), (0, 0))) if pad else x


def _pallas(q, k, v, causal, kv_len=None, bq=32, bk=32):
    """The reference's Pallas kernel in interpret mode, on numpy or bf16
    jax inputs, with an explicit ``kv_len`` (the reference's wrapper
    always passes Skv); the output in the inputs' type."""
    q, k, v = (jnp.asarray(a) for a in (q, k, v))
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    if kv_len is None:
        return jflash(q, k, v, causal=causal, bq=bq, bk=bk)
    flat = [_pad(a.transpose(0, 2, 1, 3).reshape(-1, a.shape[1], Dh), m)
            for a, m in ((q, bq), (k, bk), (v, bk))]
    o = flash_pallas(*flat, n_groups=H // KH, scale=1.0 / math.sqrt(Dh),
                     causal=causal, kv_len=kv_len, bq=bq, bk=bk,
                     interpret=True)
    return (o[:, :Sq].reshape(B, H, Sq, Dh).transpose(0, 2, 1, 3)
            .astype(q.dtype))


def _split(case):
    *shape, causal = case[:7]
    return shape, causal, (case[7] if len(case) > 7 else None)


@pytest.mark.parametrize("case", CASES)
def test_blocked_f32_matches_reference(case):
    shape, causal, _ = _split(case)
    q, k, v = _qkv(shape[1] * 7 + shape[2], *shape)
    got, slack = flash_blocked(*(torch.as_tensor(a) for a in (q, k, v)),
                               causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert not slack.any()                       # p_rel = 0
    ref = flash_ref(*(torch.as_tensor(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=3e-5,
                               atol=3e-5)
    pallas = np.asarray(_pallas(q, k, v, causal))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("case", BF16_CASES)
def test_blocked_bf16_inside_derived_bound(case):
    shape, causal, kv_len = _split(case)
    q, k, v = _qkv(shape[1] * 11 + shape[2], *shape)
    tq, tk, tv = (torch.as_tensor(a).bfloat16() for a in (q, k, v))
    got, _ = flash_blocked(tq, tk, tv, causal=causal, kv_len=kv_len,
                           p_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(_pallas(jq, jk, jv, causal, kv_len), np.float32)
    abs_v = flash_ref(tq.float(), tk.float(), tv.float().abs(),
                      causal=causal, kv_len=kv_len).numpy()
    err = np.abs(got.float().numpy() - ref)
    tol = U7 * np.abs(ref) + U7 * abs_v + 1e-4
    assert (err <= tol).all(), float((err / tol).max())
    assert float((err / tol).max()) > 0.05       # p's rounding does show
    # and the reference's own bf16 tolerance, which the bound lies inside
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("case", BF16_CASES[4:])
def test_blocked_slack_covers_a_perturbed_p(case):
    """Two runs whose p differ by f32 noise only (q scaled by 1 + 2^-20,
    in f32): their bf16-p outputs agree within one bf16 step plus the
    slack for ``P_REL``, the comparison the card makes between
    kernel E and ``flash_blocked``; and that slack is a small part of
    the derived bound's p term."""
    shape, causal, kv_len = _split(case)
    q, k, v = (torch.as_tensor(a) for a in
               _qkv(shape[1] * 13 + shape[2], *shape))
    kw = dict(causal=causal, kv_len=kv_len, p_dtype=torch.bfloat16)
    a, slack = flash_blocked(q, k, v, p_rel=P_REL, **kw)
    b, _ = flash_blocked(q * (1 + 2.0 ** -20), k, v, **kw)
    a16, b16 = a.bfloat16().float(), b.bfloat16().float()
    tol = U7 * a16.abs() + slack + 1e-4
    assert ((a16 - b16).abs() <= tol).all()
    abs_v = flash_ref(q, k, v.abs(), causal=causal, kv_len=kv_len)
    assert float(slack.mean()) < 0.125 * U7 * float(abs_v.mean())


def test_blocked_skips_nothing_a_kernel_block_would_skip():
    """Causal KV tiles wholly above a row are exact zeros: a blocked run
    that stops at the diagonal tile equals one over every tile."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(4, 1, 256, 256, 2, 1, 32))
    full, _ = flash_blocked(q, k, v, causal=True, p_dtype=torch.bfloat16)
    short, _ = flash_blocked(q[:, :128], k[:, :128], v[:, :128],
                             causal=True, p_dtype=torch.bfloat16)
    assert torch.equal(full[:, :128], short)


def test_operand_copies_only_what_tma_cannot_read():
    """bf16 views with a 16-byte-aligned address and strides are read in
    place; one with a 72-byte head stride or an 8-byte-offset address is
    copied into a fresh contiguous tensor; f32 needs only a unit last
    stride."""
    big = torch.zeros(2, 50, 6, 32, dtype=torch.bfloat16)
    padded = big[:, :, :4]                        # head axis padded
    assert not padded.is_contiguous() and _operand(padded) is padded
    odd = torch.zeros(2, 50, 4, 36, dtype=torch.bfloat16)[..., :32]
    offset = torch.zeros(2 * 50 * 4 * 32 + 4,
                         dtype=torch.bfloat16)[4:].view(2, 50, 4, 32)
    assert offset.data_ptr() % 16 == 8
    for view in (odd, offset):
        op = _operand(view)
        assert op is not view and op.is_contiguous()
        assert op.data_ptr() % 16 == 0 and torch.equal(op, view)
    odd32 = torch.zeros(2, 50, 4, 36)[..., :32]
    assert _operand(odd32) is odd32
    strided = torch.zeros(2, 50, 4, 64, dtype=torch.bfloat16)[..., ::2]
    assert _operand(strided).stride(-1) == 1
