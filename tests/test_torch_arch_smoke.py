"""Twins of tests/test_arch_smoke.py for the port's dense decoders
(granite-3-2b, phi3-medium-14b, deepseek-coder-33b, deepseek-67b), on the
CPU.

* Forward: the port's train-mode loss on its own smoke weights is finite
  and its cross-entropy within 15 % of log(padded vocab), the reference
  test's rule for random weights; beside it, the port's loss on the
  reference's weights (``convert.from_jax_params``) equals the
  reference's to 1e-5 relative (f32: two implementations summing in
  different orders).
* Prefill → decode parity: the prefill's logits and four serve steps
  against the full forward, within 2e-3 (the reference test's bound; f32
  compute at smoke width).
* Parameter counts at the full configs, computed from the schema without
  allocating anything: within 5 % of the published sizes, and equal,
  integer for integer, to the reference's ``schema.param_count`` (padded
  and not) and ``active_param_count``.
* The configs: every field equal to the reference's, full and smoke.

The gradient step of the reference suite is a later slice (training).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import model as jmodel
from repro.models import schema as jschema
from repro_torch.configs.registry import (get_config, get_smoke_config,
                                          list_archs)
from repro_torch.models import convert, schema
from repro_torch.models import model as model_api

ARCHS = list_archs()

PUBLISHED_SIZES = {           # ±5 %, as the reference test
    "deepseek-67b": 67e9,
    "granite-3-2b": 2.5e9,
    "deepseek-coder-33b": 33e9,
    "phi3-medium-14b": 14e9,
}


def make_batch(cfg, rng, B=2, S=24):
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.as_tensor(v).long() for k, v in batch.items()}


def test_the_dense_family_is_registered():
    assert ARCHS == sorted(PUBLISHED_SIZES)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for port, ref in ((get_config(arch), jregistry.get_config(arch)),
                      (get_smoke_config(arch),
                       jregistry.get_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_and_finiteness(arch):
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(0)
    batch = make_batch(cfg, rng)
    model = model_api.init_params(cfg, 0, device="cpu")
    loss, metrics = model_api.make_train_forward(cfg)(model,
                                                      _torch_batch(batch))
    assert np.isfinite(float(loss)), arch
    assert float(metrics["ce"]) == pytest.approx(np.log(cfg.padded_vocab),
                                                 rel=0.15)
    params = jmodel.init_params(jregistry.get_smoke_config(arch), 0)
    ref, _ = jax.jit(jmodel.make_train_forward(
        jregistry.get_smoke_config(arch)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    twin = convert.from_jax_params(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    got, _ = model_api.loss_fn(cfg, twin, _torch_batch(batch))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_parity(arch):
    cfg = get_smoke_config(arch)
    model = model_api.init_params(cfg, 0, device="cpu")
    B, S = 2, 24
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S))).long()
    full, _ = model(toks, cfg=cfg, mode="train")
    Sp = S - 4
    logits, caches = model_api.make_prefill(cfg)(model,
                                                 {"tokens": toks[:, :Sp]})
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
    assert abs(n - target) / target < 0.05, (arch, n, target)
    assert n == jschema.param_count(jcfg)
    assert schema.param_count(cfg, padded=True) == \
        jschema.param_count(jcfg, padded=True)
    assert schema.active_param_count(cfg) == jschema.active_param_count(jcfg)
    assert schema.active_param_count(cfg) == n      # dense: all active
