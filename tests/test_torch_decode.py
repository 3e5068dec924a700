"""The port's decode path against the JAX reference: granite-3-2b at smoke
width, the same weights (the JAX ``init_params`` tree loaded through
repro_torch.models.convert), the same caches (``convert.caches_from_jax``)
and the same tokens, drawn from a numpy seed.

Tolerances (those of tests/test_torch_model.py):
* f32 compute: 1e-4 absolute on logits and cached K/V of order 1 — two
  f32 implementations of the same ops, summed in different orders;
* bf16 compute: 3e-2 absolute — bf16 keeps 8 bits of mantissa and the
  two frameworks round to bf16 at different points of each block;
* int8 caches: the scale is max|x| / 127, so two scales of K/V that
  agree to ``atol`` agree to ``atol / 127``; each dequantized element
  lies within half a step (scale / 2) of its input, so two payloads
  dequantize to within ``atol + (s_port + s_ref) / 2`` of each other
  (a payload may move by a step or two where the inputs straddle a
  rounding boundary);
* ``_kv_quant`` on the same input: bit for bit;
* the loss (f32): 1e-5 relative;
* greedy tokens (f32): equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jget_smoke
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import convert
from repro_torch.models import model as model_api
from repro_torch.models.transformer import _kv_quant

ATOL = {"float32": 1e-4, "bfloat16": 3e-2}
B, S_PROMPT, MAX_LEN = 2, 10, 16


def _pair(compute_dtype="float32", kv="compute"):
    jcfg = dataclasses.replace(jget_smoke("granite-3-2b"),
                               compute_dtype=compute_dtype,
                               kv_cache_dtype=kv)
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"),
                              compute_dtype=compute_dtype,
                              kv_cache_dtype=kv)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


@pytest.fixture(scope="module")
def weights():
    """The reference's smoke weights (built under the f32 compute config,
    as the reference's int8 test builds them) and the port's model of
    them; every other config of this file runs on these weights."""
    jcfg, cfg = _pair()
    params = jmodel.init_params(jcfg, 0)
    return params, convert.from_jax_params(
        cfg, jax.tree.map(np.asarray, params), device="cpu")


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def _to_port(cfg, jcaches):
    return convert.caches_from_jax(cfg, jax.tree.map(np.asarray, jcaches),
                                   device="cpu")


def _hold_caches(got, ref, atol):
    """Port caches ``got`` against the reference's ``ref`` (both in the
    port's layout), by the rules of the module docstring."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for key in ("k", "v"):
            assert g[key].dtype == r[key].dtype
            gk, rk = g[key].float(), r[key].float()
            if key + "_s" in g:
                gs, rs = g[key + "_s"], r[key + "_s"]
                assert gs.dtype == torch.float32
                assert (gs - rs).abs().max() <= atol / 127
                tol = atol + (gs + rs) / 2
                assert ((gk * gs - rk * rs).abs() <= tol).all()
            else:
                assert (gk - rk).abs().max() <= atol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quant_bitwise(dtype):
    """Payloads and scales of ``_kv_quant`` are the reference's bit for
    bit, on rows of mixed magnitude, an all-zero row (the 1e-10 floor)
    and values that sit on a half step (round half to even)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    x *= 10.0 ** rng.uniform(-3, 2, (2, 9, 3, 1)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2, 1] = np.arange(32, dtype=np.float32) - 15.5   # scale 0.125
    jx = jnp.asarray(x).astype(dtype)
    jq, js = jtransformer._kv_quant(jx)
    q, s = _kv_quant(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (2, 9, 3, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))


@pytest.mark.parametrize("kv", ["compute", "int8"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_serve_step_matches_reference(weights, compute_dtype, kv):
    """Two serve steps from the same padded prefill cache: logits and the
    updated caches as the reference's."""
    params, model = weights
    jcfg, cfg = _pair(compute_dtype, kv)
    atol = ATOL[compute_dtype]
    toks = _tokens(cfg, (B, S_PROMPT + 2))
    _, jc = jax.jit(jmodel.make_prefill(jcfg))(
        params, {"tokens": jnp.asarray(toks[:, :S_PROMPT])})
    jc = jmodel._pad_caches(jcfg, jc, MAX_LEN)
    caches = _to_port(cfg, jc)
    jstep = jax.jit(jmodel.make_serve_step(jcfg))
    step = model_api.make_serve_step(cfg)
    for t in range(2):
        pos = S_PROMPT + t
        tok = toks[:, pos:pos + 1]
        jl, jc = jstep(params, jnp.asarray(tok), jc, pos)
        got, out = step(model, torch.as_tensor(tok).long(), caches, pos)
        assert out is caches                  # written in place
        assert got.shape == (B, 1, cfg.padded_vocab)
        assert got.dtype == getattr(torch, compute_dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(jl, np.float32), atol=atol)
        _hold_caches(caches, _to_port(cfg, jc), atol)


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_greedy_generate_matches_reference(weights, kv):
    params, model = weights
    jcfg, cfg = _pair("float32", kv)
    prompt = _tokens(cfg, (B, S_PROMPT), seed=1)
    ref = jmodel.greedy_generate(jcfg, params, jnp.asarray(prompt), 8)
    got = model_api.greedy_generate(cfg, model,
                                    torch.as_tensor(prompt).long(), 8)
    assert got.shape == (B, 8) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kv", ["compute", "int8"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cache_layouts_map_one_to_one(weights, compute_dtype, kv):
    """``init_cache`` and ``_pad_caches``: the reference's stacked leaves
    are the port's per-layer tensors, with the same names, shapes (less
    the layer axis) and dtypes, and the padding is zero."""
    params, model = weights
    jcfg, cfg = _pair(compute_dtype, kv)
    ref = jmodel.init_cache(jcfg, B, MAX_LEN)["b0_attn_mlp"]
    got = model_api.init_cache(cfg, B, MAX_LEN, device="cpu")
    toks = _tokens(cfg, (B, S_PROMPT))
    _, jc = jax.jit(jmodel.make_prefill(jcfg))(
        params, {"tokens": jnp.asarray(toks)})
    jpad = jmodel._pad_caches(jcfg, jc, MAX_LEN)["b0_attn_mlp"]
    _, pc = model_api.make_prefill(cfg)(
        model, {"tokens": torch.as_tensor(toks).long()})
    padded = model_api._pad_caches(cfg, pc, MAX_LEN)
    for port, jtree in ((got, ref), (padded, jpad)):
        assert len(port) == jtree["k"].shape[0] == cfg.n_layers
        for layer in port:
            assert sorted(layer) == sorted(jtree)
            for name, x in layer.items():
                assert tuple(x.shape) == jtree[name].shape[1:]
                assert str(x.dtype).removeprefix("torch.") == \
                    jtree[name].dtype.name
    for layer in got:
        assert all(not x.any() for x in layer.values())
    for layer in padded:
        assert all(not x[:, S_PROMPT:].any() for x in layer.values())
    _hold_caches(padded, _to_port(cfg, jmodel._pad_caches(jcfg, jc,
                                                          MAX_LEN)),
                 ATOL[compute_dtype])


@pytest.mark.parametrize("variant", ["plain", "loss_mask", "short_labels"])
def test_loss_fn_matches_reference(weights, variant):
    params, model = weights
    jcfg, cfg = _pair()
    rng = np.random.default_rng(3)
    S = 12
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if variant == "loss_mask":
        batch["loss_mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
    if variant == "short_labels":
        batch["labels"] = batch["labels"][:, :5]
        batch["loss_mask"] = np.ones((B, 5), np.float32)
        batch["loss_mask"][0, 1:3] = 0.0
    ref_total, ref = jax.jit(jmodel.make_train_forward(jcfg))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    total, got = model_api.make_train_forward(cfg)(
        model, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert total.dtype == torch.float32 and total.shape == ()
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-5)
    for name in ("ce", "zloss"):
        np.testing.assert_allclose(float(got[name]), float(ref[name]),
                                   rtol=1e-5)
    assert float(got["aux"]) == float(ref["aux"]) == 0.0


def test_loss_mask_all_zero_floors_the_denominator(weights):
    _, model = weights
    _, cfg = _pair()
    toks = torch.as_tensor(_tokens(cfg, (B, 6))).long()
    total, m = model_api.loss_fn(cfg, model, {
        "tokens": toks, "labels": toks, "loss_mask": torch.zeros(B, 6)})
    assert float(total) == float(m["ce"]) == float(m["zloss"]) == 0.0


@pytest.mark.parametrize("pos", [MAX_LEN, MAX_LEN + 3, -1])
def test_pos_outside_the_cache_raises(weights, pos):
    """The reference's ``dynamic_update_slice`` clamps a position past the
    cache; the port refuses it."""
    _, model = weights
    _, cfg = _pair()
    caches = model_api.init_cache(cfg, B, MAX_LEN, device="cpu")
    step = model_api.make_serve_step(cfg)
    tok = torch.zeros((B, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="outside the cache"):
        step(model, tok, caches, pos)
    with pytest.raises(ValueError, match="outside the cache"):
        model_api.greedy_generate(cfg, model, torch.zeros(
            (B, MAX_LEN), dtype=torch.long), 3, max_len=MAX_LEN)
    step(model, tok, caches, MAX_LEN - 1)     # the last slot is fine


def test_int8_kv_decode_close_to_full_forward(weights):
    """Twin of tests/test_system.py::test_int8_kv_decode_close_to_bf16:
    weights built under the compute-cache config, decoded with
    ``kv_cache_dtype="int8"`` within 0.05 of the full forward; beside it
    the reference's errors on the same weights and tokens, which the
    port's match to 1e-4."""
    params, model = weights
    jcfg, cfg = _pair()
    jcfg8, cfg8 = _pair("float32", "int8")
    toks = _tokens(cfg, (B, 24), seed=1)
    Sp = 20
    jfull, _, _ = jtransformer.forward(jcfg, params,
                                       {"tokens": jnp.asarray(toks)},
                                       mode="train")
    _, jc = jax.jit(jmodel.make_prefill(jcfg8))(
        params, {"tokens": jnp.asarray(toks[:, :Sp])})
    jc = jmodel._pad_caches(jcfg8, jc, 24)
    jstep = jax.jit(jmodel.make_serve_step(jcfg8))
    full, _ = model(torch.as_tensor(toks).long(), cfg=cfg, mode="train")
    _, caches = model_api.make_prefill(cfg8)(
        model, {"tokens": torch.as_tensor(toks[:, :Sp]).long()})
    caches = model_api._pad_caches(cfg8, caches, 24)
    step = model_api.make_serve_step(cfg8)
    errs, ref_errs = [], []
    for t in range(4):
        tok = toks[:, Sp + t:Sp + t + 1]
        jl, jc = jstep(params, jnp.asarray(tok), jc, Sp + t)
        lg, caches = step(model, torch.as_tensor(tok).long(), caches,
                          Sp + t)
        errs.append(float((lg[:, 0] - full[:, Sp + t]).abs().max()))
        ref_errs.append(float(jnp.max(jnp.abs(jl[:, 0]
                                              - jfull[:, Sp + t]))))
    assert max(errs) < 0.05, errs
    np.testing.assert_allclose(errs, ref_errs, atol=1e-4)
