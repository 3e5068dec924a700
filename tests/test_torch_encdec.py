"""The port's encoder-decoder (models/encdec.py and its layers) against the
JAX reference (repro.models.encdec), on the CPU: whisper-small's smoke
config on the reference's weights (constants redrawn,
tests/family_cases.py), 64 audio frames, inputs drawn with numpy.

* ``sinusoidal_positions`` at the smoke and the full width (1,500
  frames, d 768), ``layer_norm`` and ``gelu_mlp`` (the tanh GELU, as
  ``jax.nn.gelu``'s default) in f32 and bf16;
* ``encode`` with flash off and on — on, the reference runs its Pallas
  kernel in interpret mode and the port its plain version
  (``flash_ref``), both non-causal;
* ``encdec_forward`` in "train" and "prefill" (logits, and the caches:
  self K/V and the cross K/V of the encoder output);
* the prefill then four serve steps, the port stepping from the
  reference's padded cache (``caches_from_jax``), logits and caches held
  at every step;
* ``greedy_generate`` refuses an encoder-decoder, as the reference.

Tolerances: sinusoids within one f32 ulp of the largest angle, S·2^-23
(the two frameworks' pow of 10000^(2i/d) may round an ulp apart, which
the position multiplies, e.g. 3.05e-5 at S 1,500); layer norm 1e-6
(f32) and one bf16 step (2^-8 relative); the MLP, encoder and logits 1e-4 (f32) and 3e-2 (bf16)
absolute, caches 1e-4 (f32), as tests/test_torch_decode.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from family_cases import (ATOL, hold_caches, make_batch, reference_pair,
                          to_jax, to_port_caches, to_torch)
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.models import encdec, layers
from repro_torch.models import model as model_api

ARCH = "whisper-small"


@pytest.fixture(scope="module")
def pair():
    return reference_pair(ARCH)


def _with(pair, **fields):
    jcfg, cfg = (dataclasses.replace(c, **fields) for c in pair[:2])
    return jcfg, cfg, pair[2], pair[3]


@pytest.mark.parametrize("S,d", [(64, 128), (1500, 768)])
def test_sinusoidal_positions_match_reference(S, d):
    ref = np.asarray(jencdec.sinusoidal_positions(S, d, jnp.float32))
    got = encdec.sinusoidal_positions(S, d, torch.float32)
    assert got.shape == (S, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=S * 2.0 ** -23)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 7, 128)) + 1).astype(np.float32)
    scale, bias = (rng.standard_normal(128).astype(np.float32)
                   for _ in range(2))
    ref = jlayers.layer_norm(jnp.asarray(x).astype(getattr(jnp, dtype)),
                             jnp.asarray(scale), jnp.asarray(bias))
    got = layers.layer_norm(torch.as_tensor(x).to(getattr(torch, dtype)),
                            torch.as_tensor(scale), torch.as_tensor(bias))
    assert got.dtype == getattr(torch, dtype)
    ref = np.asarray(ref, np.float32)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8 * np.abs(ref) + 1e-6
    assert (np.abs(got.float().numpy() - ref) <= tol).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype):
    """The tanh GELU: the exact (erf) form would move these outputs by
    more than the f32 tolerance."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    w_up, w_down = (0.1 * rng.standard_normal(s).astype(np.float32)
                    for s in ((64, 96), (96, 64)))
    b_up, b_down = (0.5 * rng.standard_normal(n).astype(np.float32)
                    for n in (96, 64))
    args = (x, w_up, b_up, w_down, b_down)
    ref = np.asarray(jlayers.gelu_mlp(
        jnp.asarray(x).astype(getattr(jnp, dtype)),
        *(jnp.asarray(a) for a in args[1:])), np.float32)
    t = [torch.as_tensor(a) for a in args]
    t[0] = t[0].to(getattr(torch, dtype))
    got = layers.gelu_mlp(*t).float().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL[dtype])
    if dtype == "float32":
        h = torch.nn.functional.gelu(t[0] @ t[1] + t[2])    # erf form
        erf = (h @ t[3] + t[4]).numpy()
        assert np.abs(erf - ref).max() > 2 * ATOL[dtype]


@pytest.mark.parametrize("flash", [False, True])
def test_encode_matches_reference(pair, flash):
    jcfg, cfg, params, model = _with(pair, use_flash_attention=flash)
    audio = make_batch(cfg, np.random.default_rng(2))["audio_embeds"]
    ref = jencdec.encode(jcfg, params, jnp.asarray(audio))
    got = encdec.encode(cfg, model, torch.as_tensor(audio))
    assert got.shape == (2, cfg.cross_len, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATOL["float32"])


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("dtype,flash", [("float32", False),
                                         ("float32", True),
                                         ("bfloat16", True)])
def test_encdec_forward_matches_reference(pair, mode, dtype, flash):
    jcfg, cfg, params, model = _with(pair, compute_dtype=dtype,
                                     use_flash_attention=flash)
    batch = make_batch(cfg, np.random.default_rng(3))
    del batch["labels"]
    ref, jc, _ = jencdec.encdec_forward(jcfg, params, to_jax(batch),
                                        mode=mode)
    with torch.inference_mode():
        got, caches, aux = encdec.encdec_forward(cfg, model,
                                                 to_torch(batch), mode=mode)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=ATOL[dtype])
    assert float(aux) == 0.0
    if mode == "train":
        assert caches is None
    else:
        assert all(sorted(c) == ["k", "v", "xk", "xv"] for c in caches)
        hold_caches(caches, to_port_caches(cfg, jc), ATOL[dtype])


def test_whisper_serve_steps_match_reference(pair):
    """The prefill of 16 tokens against 64 frames, its cache padded to 24,
    then four serve steps; the port steps from the reference's padded
    cache (the cross K/V unpadded, as the reference keeps them), f32."""
    jcfg, cfg, params, model = pair
    batch = make_batch(cfg, np.random.default_rng(4), S=20)
    toks, Sp = batch["tokens"], 16
    pre = {"tokens": toks[:, :Sp], "audio_embeds": batch["audio_embeds"]}
    jl, jc = jax.jit(jmodel.make_prefill(jcfg))(params, to_jax(pre))
    got, caches = model_api.make_prefill(cfg)(model, to_torch(pre))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl),
                               atol=ATOL["float32"])
    jc = jmodel._pad_caches(jcfg, jc, 24)
    padded = model_api._pad_caches(cfg, caches, 24)
    hold_caches(padded, to_port_caches(cfg, jc), ATOL["float32"])
    assert padded[0]["xk"].shape[1] == cfg.cross_len
    caches = to_port_caches(cfg, jc)
    jstep = jax.jit(jmodel.make_serve_step(jcfg))
    step = model_api.make_serve_step(cfg)
    for t in range(4):
        tok = toks[:, Sp + t:Sp + t + 1]
        jl, jc = jstep(params, jnp.asarray(tok), jc, Sp + t)
        lg, out = step(model, torch.as_tensor(tok).long(), caches, Sp + t)
        assert out is caches
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   atol=ATOL["float32"])
        hold_caches(caches, to_port_caches(cfg, jc), ATOL["float32"])


def test_greedy_generate_refuses_encdec(pair):
    cfg, model = pair[1], pair[3]
    with pytest.raises(NotImplementedError, match="enc-dec"):
        model_api.greedy_generate(cfg, model, torch.zeros((1, 4),
                                                          dtype=torch.long), 2)
    with pytest.raises(ValueError, match="encoder output"):
        model(torch.zeros((1, 4), dtype=torch.long), cfg=cfg, mode="train")
