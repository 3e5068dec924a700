"""Twins of tests/test_arch_smoke.py for all ten of the port's
architectures, on the CPU: the dense decoders (granite-3-2b,
phi3-medium-14b, deepseek-coder-33b, deepseek-67b), the MoE decoders
(granite-moe-3b-a800m, dbrx-132b), the hybrid jamba-1.5-large-398b, the
recurrent xlstm-350m, the encoder-decoder whisper-small and the M-RoPE
VLM qwen2-vl-7b.

* The registry and the configs: the reference's arch list, and every
  field equal to the reference's, full and smoke.
* Forward: the port's train-mode loss on its own smoke weights is finite
  and its cross-entropy within 15 % of log(padded vocab), the reference
  test's rule for random weights; beside it, on the reference's weights
  with their constants redrawn (``family_cases.randomize_constants``),
  the port's loss equals the reference's to 1e-5 relative and its
  logits to 1e-4 (f32) and 3e-2 (bf16) absolute (two implementations
  summing in other orders; bf16 rounded at other points). In bf16 a
  position whose router gap is below ``BF16_ROUTER_GAP`` in some MoE
  layer is a near-tie the two bf16 runs may break apart (a whole expert
  swaps): it is skipped, named in the log, and at most a quarter of the
  positions may be.
* Prefill → decode parity: the prefill's logits and four serve steps
  against the full forward, within 2e-3 (the reference test's bound; f32
  compute at smoke width); whisper's with its audio frames (the
  reference's ``test_whisper_parity``).
* Parameter counts at the full configs, computed from the schema without
  allocating anything: within the reference test's bounds of the
  published sizes (5 %; xlstm 40 %, whisper 20 %), the active counts of
  the MoE archs within 15 %, and equal, integer for integer, to the
  reference's ``schema.param_count`` (padded and not) and
  ``active_param_count``.
* The subquadratic flags: xlstm and jamba only.

The gradient step of the reference suite is a later slice (training).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from family_cases import (ATOL, BF16_ROUTER_GAP, make_batch, near_ties,
                          reference_pair, router_gaps, to_jax, to_torch)
from repro.configs import registry as jregistry
from repro.models import model as jmodel
from repro.models import schema as jschema
from repro_torch.configs.registry import (get_config, get_smoke_config,
                                          list_archs)
from repro_torch.models import encdec, schema
from repro_torch.models import model as model_api

ARCHS = list_archs()

PUBLISHED_SIZES = {           # the reference test's
    "jamba-1.5-large-398b": 398e9,
    "deepseek-67b": 67e9,
    "granite-3-2b": 2.5e9,
    "deepseek-coder-33b": 33e9,
    "phi3-medium-14b": 14e9,
    "granite-moe-3b-a800m": 3.3e9,
    "dbrx-132b": 132e9,
    "xlstm-350m": 0.35e9,
    "whisper-small": 0.244e9,
    "qwen2-vl-7b": 7.6e9,
}
SIZE_TOL = {"xlstm-350m": 0.4, "whisper-small": 0.2}    # else 5 %

ACTIVE_SIZES = {              # ±15 %, the reference test's
    "jamba-1.5-large-398b": 94e9,
    "granite-moe-3b-a800m": 0.8e9,
    "dbrx-132b": 36e9,
}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return reference_pair(request.param)


def test_the_registry_is_the_references():
    assert ARCHS == jregistry.list_archs()
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for port, ref in ((get_config(arch), jregistry.get_config(arch)),
                      (get_smoke_config(arch),
                       jregistry.get_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_forward_shapes_and_finiteness(pair):
    """The port's own smoke weights: a finite loss near log(V); the
    reference's weights: the loss (with the MoE aux) as the
    reference's."""
    jcfg, cfg, params, model = pair
    batch = make_batch(cfg, np.random.default_rng(0))
    own = model_api.init_params(cfg, 0, device="cpu")
    loss, metrics = model_api.make_train_forward(cfg)(own, to_torch(batch))
    assert np.isfinite(float(loss)), cfg.name
    assert float(metrics["ce"]) == pytest.approx(np.log(cfg.padded_vocab),
                                                 rel=0.15)
    ref, rm = jax.jit(jmodel.make_train_forward(jcfg))(params, to_jax(batch))
    got, gm = model_api.loss_fn(cfg, model, to_torch(batch))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(gm["aux"]), float(rm["aux"]),
                               rtol=1e-5)
    assert (float(gm["aux"]) > 0) == bool(cfg.moe_experts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(pair, dtype):
    """The prefill's logits over the whole batch (the image patches and
    the audio frames where the family takes them) on the reference's
    weights."""
    jcfg, cfg = (dataclasses.replace(c, compute_dtype=dtype)
                 for c in pair[:2])
    batch = make_batch(cfg, np.random.default_rng(1))
    del batch["labels"]
    ref, _ = jax.jit(jmodel.make_prefill(jcfg))(pair[2], to_jax(batch))
    with router_gaps() as gaps:
        got, _ = model_api.make_prefill(cfg)(pair[3], to_torch(batch))
    assert got.dtype == getattr(torch, dtype)
    skip = near_ties(gaps, got.shape[:2], BF16_ROUTER_GAP) \
        if dtype == "bfloat16" else np.zeros(got.shape[:2], bool)
    print(f"{cfg.name} {dtype}: near-ties skipped at (row, position) "
          f"{[tuple(map(int, p)) for p in np.argwhere(skip)]}")
    assert skip.mean() <= 0.25
    np.testing.assert_allclose(got.float().numpy()[~skip],
                               np.asarray(ref, np.float32)[~skip],
                               atol=ATOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_parity(arch):
    cfg = get_smoke_config(arch)
    model = model_api.init_params(cfg, 0, device="cpu")
    B, S = 2, 24
    rng = np.random.default_rng(1)
    batch = to_torch(make_batch(cfg, rng, B, S))
    toks = batch["tokens"]
    if cfg.is_encdec:          # the reference's test_whisper_parity
        with torch.inference_mode():
            full, _, _ = encdec.encdec_forward(cfg, model, batch,
                                               mode="train")
        extra = {"audio_embeds": batch["audio_embeds"]}
    else:
        full, _ = model(toks, cfg=cfg, mode="train")
        extra = {}
    Sp = S - 4
    logits, caches = model_api.make_prefill(cfg)(
        model, {"tokens": toks[:, :Sp], **extra})
    caches = model_api._pad_caches(cfg, caches, S)
    step = model_api.make_serve_step(cfg)
    errs = [float((logits - full[:, :Sp]).abs().max())]
    for t in range(4):
        lg, caches = step(model, toks[:, Sp + t:Sp + t + 1], caches, Sp + t)
        errs.append(float((lg[:, 0] - full[:, Sp + t]).abs().max()))
    assert max(errs) < 2e-3, (arch, errs)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_published_and_reference(arch):
    cfg, jcfg = get_config(arch), jregistry.get_config(arch)
    n = schema.param_count(cfg)
    target = PUBLISHED_SIZES[arch]
    assert abs(n - target) / target < SIZE_TOL.get(arch, 0.05), \
        (arch, n, target)
    assert n == jschema.param_count(jcfg)
    assert schema.param_count(cfg, padded=True) == \
        jschema.param_count(jcfg, padded=True)
    active = schema.active_param_count(cfg)
    assert active == jschema.active_param_count(jcfg)
    if arch in ACTIVE_SIZES:
        assert abs(active - ACTIVE_SIZES[arch]) / ACTIVE_SIZES[arch] < 0.15
    else:
        assert active == n                      # no experts: all active


@pytest.mark.parametrize("arch", ARCHS)
def test_subquadratic_flags(arch):
    assert get_config(arch).subquadratic == (
        arch in ("xlstm-350m", "jamba-1.5-large-398b"))
