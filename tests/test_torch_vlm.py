"""The port's M-RoPE VLM (qwen2-vl-7b) against the JAX reference, on the
CPU: ``layers.apply_mrope`` with distinct temporal / height / width ids,
then the smoke model on the reference's weights (QKV biases and norm
scales redrawn, tests/family_cases.py) with 8 image patches before the
text and a patch grid of M-RoPE ids (``family_cases.mrope_grid``):
prefill logits and caches, the loss, serve steps from the reference's
cache, and ``greedy_generate``.

Tolerances: the rotation 1e-5 absolute on inputs of order 1 (f32
sin/cos of the same angles); logits 1e-4 (f32) and 3e-2 (bf16), caches
1e-4 (f32), as tests/test_torch_decode.py; the loss 1e-5 relative;
greedy tokens equal (f32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from family_cases import (ATOL, hold_caches, make_batch, reference_pair,
                          to_jax, to_port_caches, to_torch)
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.models import layers
from repro_torch.models import model as model_api

ARCH = "qwen2-vl-7b"


@pytest.fixture(scope="module")
def pair():
    return reference_pair(ARCH)


@pytest.mark.parametrize("dh,sections,theta", [(32, (8, 4, 4), 1e4),
                                               (128, (16, 24, 24), 1e6)])
def test_apply_mrope_matches_reference(dh, sections, theta):
    rng = np.random.default_rng(dh)
    B, S, H = 2, 12, 3
    x = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    ids = rng.integers(0, 64, (3, B, S)).astype(np.int32)
    ref = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(ids), sections,
                              theta)
    got = layers.apply_mrope(torch.as_tensor(x), torch.as_tensor(ids),
                             sections, theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # equal streams: plain RoPE on those positions
    same = np.repeat(ids[:1], 3, axis=0)
    np.testing.assert_allclose(
        layers.apply_mrope(torch.as_tensor(x), torch.as_tensor(same),
                           sections, theta).numpy(),
        layers.apply_rope(torch.as_tensor(x), torch.as_tensor(ids[0]),
                          theta).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(torch.as_tensor(x), torch.as_tensor(ids),
                           (8, 8, 8), theta)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", [False, True])
def test_vlm_prefill_with_image_matches_reference(pair, dtype, flash):
    """8 image patches projected by ``vision_proj`` before 24 tokens, the
    patch grid's M-RoPE ids: logits over all 32 positions and the caches
    (QKV biases applied before the rotation)."""
    jcfg, cfg = (dataclasses.replace(c, compute_dtype=dtype,
                                     use_flash_attention=flash)
                 for c in pair[:2])
    batch = make_batch(cfg, np.random.default_rng(0), grid=True)
    del batch["labels"]
    ref, jc = jax.jit(jmodel.make_prefill(jcfg))(pair[2], to_jax(batch))
    got, caches = model_api.make_prefill(cfg)(pair[3], to_torch(batch))
    assert got.shape == (2, 32, cfg.padded_vocab)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=ATOL[dtype])
    hold_caches(caches, to_port_caches(cfg, jc), ATOL[dtype])


def test_vlm_loss_matches_reference(pair):
    """The loss scores the text positions only (the labels cover the last
    24 of 32), f32."""
    jcfg, cfg, params, model = pair
    batch = make_batch(cfg, np.random.default_rng(1), grid=True)
    ref_total, ref = jax.jit(jmodel.make_train_forward(jcfg))(
        params, to_jax(batch))
    total, got = model_api.loss_fn(cfg, model, to_torch(batch))
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-5)
    for name in ("ce", "zloss"):
        np.testing.assert_allclose(float(got[name]), float(ref[name]),
                                   rtol=1e-5)


def test_vlm_serve_steps_match_reference(pair):
    """Three serve steps (M-RoPE ids ``pos`` on all three streams) from the
    reference's padded cache of a text prefill, f32."""
    jcfg, cfg, params, model = pair
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 19))
    S = 16
    _, jc = jax.jit(jmodel.make_prefill(jcfg))(
        params, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)})
    jc = jmodel._pad_caches(jcfg, jc, 20)
    caches = to_port_caches(cfg, jc)
    jstep = jax.jit(jmodel.make_serve_step(jcfg))
    step = model_api.make_serve_step(cfg)
    for t in range(3):
        tok = toks[:, S + t:S + t + 1]
        jl, jc = jstep(params, jnp.asarray(tok, jnp.int32), jc, S + t)
        lg, caches = step(model, torch.as_tensor(tok), caches, S + t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   atol=ATOL["float32"])
        hold_caches(caches, to_port_caches(cfg, jc), ATOL["float32"])


def test_vlm_greedy_generate_matches_reference(pair):
    jcfg, cfg, params, model = pair
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, (2, 10))
    ref = jmodel.greedy_generate(jcfg, params, jnp.asarray(prompt,
                                                           jnp.int32), 6)
    got = model_api.greedy_generate(cfg, model, torch.as_tensor(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
