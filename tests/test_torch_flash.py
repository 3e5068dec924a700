"""The port's flash-attention entry against the JAX reference, on the CPU.

Mirrors tests/test_kernels_flash.py: the same cases, inputs drawn with
numpy from the same seeds, the reference's Pallas kernel run in
interpret mode, the port's ``flash_attention`` on CPU tensors (its plain
version, ``flash_ref``). Kernel E itself is held against ``flash_ref``
on the card in tests/test_torch_gpu.py.

Tolerances are the reference's own: 3e-5 on the cases and 5e-5 on the
property sweep in f32 (two f32 softmaxes, one online and one not,
summed in different orders), 2e-2 in bf16 (one rounding of an output
of order 1 to 8 mantissa bits), and 1e-4 on smoke-width logits (the
whole model in f32, as tests/test_torch_model.py).

It also holds the repair of ``make_prefill(cfg)``: the attention follows
the ``cfg`` handed to ``make_prefill``, not the config the weights were
built with, as in the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.registry import get_smoke_config as jget_smoke
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention import flash_ref as jflash_ref
from repro.models import model as jmodel
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.flash_attention import (flash_attention, flash_cuda,
                                                 flash_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import convert, layers
from repro_torch.models import model as model_api

CASES = [
    # (B, Sq, Skv, H, KH, Dh, causal)
    (2, 64, 64, 4, 2, 32, True),
    (1, 100, 100, 8, 8, 64, True),
    (2, 37, 37, 4, 1, 16, True),
    (1, 64, 128, 4, 2, 32, False),     # cross-attention shape
    (2, 256, 256, 8, 2, 128, True),
    (1, 1, 64, 4, 4, 32, False),       # single query row
]


def _qkv(rng, B, Sq, Skv, H, KH, Dh, draw=None):
    draw = draw or (lambda shape: rng.standard_normal(shape))
    return tuple(draw(s).astype(np.float32) for s in
                 ((B, Sq, H, Dh), (B, Skv, KH, Dh), (B, Skv, KH, Dh)))


def _both(q, k, v, causal, bq, bk):
    ref = jflash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                 bq=bq, bk=bk)
    got = flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                          causal=causal)
    return np.asarray(ref), got


@pytest.mark.parametrize("case", CASES)
def test_flash_matches_reference(case):
    B, Sq, Skv, H, KH, Dh, causal = case
    rng = np.random.default_rng(Sq * 7 + Skv)
    q, k, v = _qkv(rng, B, Sq, Skv, H, KH, Dh)
    ref, got = _both(q, k, v, causal, 32, 32)
    assert got.shape == (B, Sq, H, Dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=3e-5, atol=3e-5)
    # and the reference's own oracle, which the port's plain version
    # mirrors op for op
    oracle = np.asarray(jflash_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=causal))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dtypes(dtype):
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal(s) for s in
            ((1, 48, 4, 32), (1, 48, 2, 32), (1, 48, 2, 32))]
    ref = jflash(*(jnp.asarray(a).astype(getattr(jnp, dtype))
                   for a in arrs), bq=16, bk=16)
    tdt = getattr(torch, dtype)
    got = flash_attention(*(torch.as_tensor(a).to(tdt) for a in arrs))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


@settings(max_examples=12, deadline=None)
@given(sq=st.integers(1, 70), h=st.sampled_from([2, 4, 8]),
       kh_div=st.sampled_from([1, 2]), dh=st.sampled_from([8, 16, 32]),
       causal=st.booleans())
def test_flash_property_sweep(sq, h, kh_div, dh, causal):
    kh = max(h // kh_div, 1)
    rng = np.random.default_rng(sq * 31 + h * 7 + dh)
    q, k, v = _qkv(rng, 1, sq, sq, h, kh, dh,
                   draw=lambda s: rng.uniform(-2, 2, s))
    ref, got = _both(q, k, v, causal, 16, 16)
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-5, atol=5e-5)


def test_kv_len_masks_like_reference():
    """``flash_ref``'s ``kv_len`` (the reference's decode-style length
    mask, which kernel E applies to its ragged edge) masks the same
    keys as the reference's ``gqa_attention``."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 5, 40, 4, 2, 16)
    for causal in (True, False):
        ref = jflash_ref(*(jnp.asarray(a) for a in (q, k, v)),
                         causal=causal, kv_len=23)
        got = flash_ref(*(torch.as_tensor(a) for a in (q, k, v)),
                        causal=causal, kv_len=23)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=3e-5, atol=3e-5)


def test_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(a) for a in _qkv(rng, 1, 9, 9, 4, 2, 16))
    n0 = flash_cuda.launches
    assert torch.equal(flash_attention(q, k, v), flash_ref(q, k, v))
    assert flash_cuda.launches == n0          # no kernel ran


def _smoke_pair():
    jcfg = dataclasses.replace(jget_smoke("granite-3-2b"),
                               use_flash_attention=True)
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"),
                              use_flash_attention=True)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    params = jmodel.init_params(jcfg, 0)
    model = convert.from_jax_params(cfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, cfg, params, model


def test_model_level_flash_parity():
    """granite's smoke config with ``use_flash_attention=True``: the
    port's prefill logits against the reference's flash prefill on the
    same weights."""
    jcfg, cfg, params, model = _smoke_pair()
    toks = np.random.default_rng(5).integers(0, cfg.vocab,
                                             (2, 32)).astype(np.int32)
    ref, _ = jax.jit(jmodel.make_prefill(jcfg))(params,
                                                {"tokens": jnp.asarray(toks)})
    got, _ = model_api.make_prefill(cfg)(
        model, {"tokens": torch.as_tensor(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_array_equal(got[:, -1].argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(ref[:, -1], -1)))


def test_make_prefill_follows_its_cfg(monkeypatch):
    """The same weights, ``make_prefill`` with the flag on and off: each
    run reaches its own attention function, once per layer. (The port
    used to run the weights' build-time config, so the flag was
    ignored.)"""
    cfg = get_smoke_config("granite-3-2b")
    model = model_api.init_params(cfg, 0, device="cpu")
    calls = {"plain": 0, "flash": 0}
    plain, fused = layers.gqa_attention, flash_ops.flash_attention

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(layers, "gqa_attention", count("plain", plain))
    monkeypatch.setattr(flash_ops, "flash_attention", count("flash", fused))
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 12)))
    logits = {}
    for flag in (False, True):
        calls.update(plain=0, flash=0)
        run_cfg = dataclasses.replace(cfg, use_flash_attention=flag)
        logits[flag], _ = model_api.make_prefill(run_cfg)(
            model, {"tokens": toks})
        n = cfg.n_layers
        assert calls == ({"plain": 0, "flash": n} if flag
                         else {"plain": n, "flash": 0}), (flag, calls)
    assert not model.cfg.use_flash_attention   # the weights' own config
    np.testing.assert_allclose(logits[True].numpy(), logits[False].numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("field,value", [("n_layers", 1), ("norm_eps", 1e-3),
                                         ("rope_theta", 500.0)])
def test_forward_refuses_a_cfg_of_other_weights(field, value):
    """Only ``use_flash_attention`` and ``compute_dtype`` may differ from
    the weights' own config; any other field raises, where it would
    otherwise run silently with numbers the weights were not built for."""
    cfg = get_smoke_config("granite-3-2b")
    model = model_api.init_params(cfg, 0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    ok_cfg = dataclasses.replace(cfg, use_flash_attention=True,
                                 compute_dtype="bfloat16")
    model_api.make_prefill(ok_cfg)(model, {"tokens": toks})
    with pytest.raises(ValueError, match="other weights"):
        model_api.make_prefill(dataclasses.replace(cfg, **{field: value}))(
            model, {"tokens": toks})
