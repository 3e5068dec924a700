"""The port's recurrent mixers (models/ssm.py) and the two recurrent
families against the JAX reference (repro.models.ssm), on the CPU.

The mixers run on one block's parameters of the reference's smoke
weights (jamba-1.5-large-398b's Mamba block, xlstm-350m's mLSTM and sLSTM
blocks; constants redrawn, tests/family_cases.py) and on inputs drawn
with numpy, in "train", "prefill" and "decode", the states included:

* Mamba over S 256 (two chunks of 128), S 2 (the conv state
  left-padded) and S 385, whose three chunks do not divide it — the
  reference asserts there, the port raises ``ValueError``;
* mLSTM over S 48 (three chunks of 16) and S 40 (the chunk shrinks to
  10); sLSTM over S 24;
* decode: four steps after the prefill, the port's each from the
  reference's state before it (converted), so no error compounds.

Then jamba's and xlstm's smoke models: prefill logits and caches, and
decode steps from the reference's padded cache (``caches_from_jax``).

Tolerances: the mixers' outputs and states within 1e-5 of the tensor's
largest magnitude (f32; the port's log-step scan and the reference's
``associative_scan`` combine the same maps in other trees, so they agree
to f32 rounding, not bit for bit); model logits 1e-4 (f32) and 3e-2
(bf16) absolute, caches 1e-4 (f32), as tests/test_torch_decode.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from family_cases import (ATOL, configs, hold_caches, reference_pair,
                          to_port_caches)
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro_torch.models import model as model_api
from repro_torch.models import ssm

REL = 1e-5


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * scale)


@pytest.fixture(scope="module")
def jamba():
    return reference_pair("jamba-1.5-large-398b")


@pytest.fixture(scope="module")
def xlstm():
    return reference_pair("xlstm-350m")


def _block(pair, key):
    """(reference params, port params) of the first layer of block
    ``key``."""
    params = pair[2]["blocks"][key]
    jp = {k: jnp.asarray(v)[0] for k, v in params.items()}
    return jp, {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}


def _x(S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (2, S, 128)).astype(np.float32)


def _mixer_differential(pair, key, jfn, fn, S):
    """train and prefill over S tokens, then four decode steps from the
    prefill's state: every output and state against the reference's."""
    jcfg, cfg = pair[0], pair[1]
    jp, p = _block(pair, key)
    x = _x(S + 4)
    jy, _ = jfn(jnp.asarray(x[:, :S]), jp, jcfg, mode="train")
    y, st = fn(torch.as_tensor(x[:, :S]), p, cfg, mode="train")
    _close(y, jy)
    assert st is None
    jy, jst = jfn(jnp.asarray(x[:, :S]), jp, jcfg, mode="prefill")
    y, st = fn(torch.as_tensor(x[:, :S]), p, cfg, mode="prefill")
    _close(y, jy)
    assert sorted(st) == sorted(jst)
    for k in st:
        _close(st[k], jst[k])
    for t in range(S, S + 4):
        xt = x[:, t:t + 1]
        # the port steps from the reference's state, converted
        prev = {k: torch.as_tensor(np.array(v)) for k, v in jst.items()}
        jy, jst = jfn(jnp.asarray(xt), jp, jcfg, state=jst, mode="decode")
        y, st = fn(torch.as_tensor(xt), p, cfg, state=prev, mode="decode")
        _close(y, jy)
        assert sorted(st) == sorted(jst)
        for k in st:
            _close(st[k], jst[k])


@pytest.mark.parametrize("S", [256, 2])
def test_mamba_mixer_matches_reference(jamba, S):
    _mixer_differential(jamba, "b1_mamba_moe", jssm.mamba_mixer,
                        ssm.mamba_mixer, S)


def test_mamba_conv_state_is_the_last_rows():
    """The prefill's conv state: the last CW − 1 rows of x1, or x1
    left-padded with zeros when S < CW − 1."""
    cfg = configs("jamba-1.5-large-398b")[1]
    x = torch.as_tensor(_x(8))
    w = torch.randn(128, 2 * cfg.d_inner, generator=torch.Generator()
                    .manual_seed(0))
    p = {"in_proj": w, "conv_w": torch.ones(4, cfg.d_inner),
         "conv_b": torch.zeros(cfg.d_inner),
         "x_proj": torch.zeros(cfg.d_inner, 8 + 32),
         "dt_w": torch.zeros(8, cfg.d_inner),
         "dt_b": torch.zeros(cfg.d_inner),
         "A_log": torch.zeros(cfg.d_inner, 16),
         "Dskip": torch.ones(cfg.d_inner),
         "out_proj": torch.zeros(cfg.d_inner, 128)}
    x1 = (x @ w)[..., :cfg.d_inner]
    for S in (8, 3, 2, 1):
        _, st = ssm.mamba_mixer(x[:, :S], p, cfg, mode="prefill")
        want = torch.nn.functional.pad(x1[:, :S], (0, 0, 3, 0))[:, -3:]
        torch.testing.assert_close(st["conv"], want, rtol=1e-6, atol=1e-6)


def test_mamba_chunks_that_do_not_divide_raise(jamba):
    """S 385 at chunk 128: three chunks, which do not divide 385. The
    reference asserts; the port raises ``ValueError``."""
    jcfg, cfg = jamba[0], jamba[1]
    jp, p = _block(jamba, "b1_mamba_moe")
    x = _x(385)
    with pytest.raises(AssertionError):
        jssm.mamba_mixer(jnp.asarray(x), jp, jcfg, mode="train")
    with pytest.raises(ValueError, match="chunks"):
        ssm.mamba_mixer(torch.as_tensor(x), p, cfg, mode="train")
    with pytest.raises(ValueError, match="one token"):
        ssm.mamba_mixer(torch.as_tensor(x[:, :2]), p, cfg, mode="decode",
                        state={})


@pytest.mark.parametrize("S", [48, 40])
def test_mlstm_mixer_matches_reference(xlstm, S):
    _mixer_differential(xlstm, "b0_mlstm", jssm.mlstm_mixer,
                        ssm.mlstm_mixer, S)


def test_slstm_mixer_matches_reference(xlstm):
    _mixer_differential(xlstm, "b7_slstm", jssm.slstm_mixer,
                        ssm.slstm_mixer, 24)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-350m"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrent_model_prefill_matches_reference(jamba, xlstm, arch,
                                                   dtype):
    """The smoke model's prefill logits and its caches of every kind
    (attention K/V, Mamba h and conv; mLSTM C, n; sLSTM c, n, h)."""
    pair = jamba if arch.startswith("jamba") else xlstm
    jcfg, cfg = (dataclasses.replace(c, compute_dtype=dtype)
                 for c in pair[:2])
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 20))
    ref, jc = jax.jit(jmodel.make_prefill(jcfg))(
        pair[2], {"tokens": jnp.asarray(toks, jnp.int32)})
    got, caches = model_api.make_prefill(cfg)(
        pair[3], {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=ATOL[dtype])
    hold_caches(caches, to_port_caches(cfg, jc), ATOL[dtype])


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-350m"])
def test_recurrent_model_decode_from_reference_cache(jamba, xlstm, arch):
    """Three serve steps from the reference's padded prefill cache,
    converted: logits and the updated caches as the reference's (f32)."""
    pair = jamba if arch.startswith("jamba") else xlstm
    jcfg, cfg, params, model = pair
    S, max_len = 20, 24
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, S + 3))
    _, jc = jax.jit(jmodel.make_prefill(jcfg))(
        params, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)})
    jc = jmodel._pad_caches(jcfg, jc, max_len)
    caches = to_port_caches(cfg, jc)
    jstep = jax.jit(jmodel.make_serve_step(jcfg))
    step = model_api.make_serve_step(cfg)
    for t in range(3):
        tok = toks[:, S + t:S + t + 1]
        jl, jc = jstep(params, jnp.asarray(tok, jnp.int32), jc, S + t)
        got, out = step(model, torch.as_tensor(tok), caches, S + t)
        assert out is caches
        np.testing.assert_allclose(got.numpy(), np.asarray(jl),
                                   atol=ATOL["float32"])
        hold_caches(caches, to_port_caches(cfg, jc), ATOL["float32"])
