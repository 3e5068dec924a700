"""The port's serving engine against the JAX reference engine, on the CPU.

Both engines get the same model weights (the JAX tree loaded through
repro_torch.models.convert), the same catalog (byte-equal), the same
config and the same request trace. Mirrors tests/test_serve_engine.py.

What must match:
* the solved allocation (the cascade on the device control plane) and
  the hits of every phase — discrete outputs, exactly;
* the repository's responses on misses — argmax tokens of f32 logits
  that agree to 1e-4 (tests/test_torch_model.py), exactly;
* total serving cost to 0.1 per hit plus 1e-5 relative: a hit on a
  stored object has d ≈ 0, where the matmul-form l2 distance carries
  sqrt(eps·(|q|² + |k|²)) ≈ 0.08 of cancellation noise at this
  catalog's radii (~240), in either framework.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jget_smoke
from repro.core import catalog as jcat
from repro.models import model as jmodel
from repro.serve import EngineConfig as JConfig
from repro.serve import SimCacheEngine as JEngine
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import catalog as catalog_api
from repro_torch.core import demand as demand_api
from repro_torch.core.topology import chain
from repro_torch.models import convert
from repro_torch.models import model as model_api
from repro_torch.serve import EngineConfig, SimCacheEngine

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=256)
ECFG = dict(k_device=16, k_pod=24, k_global=32, h_ici=1.0, h_dcn=10.0,
            h_model=100.0, metric="l2")


def make_engine(algo="cascade", **kw):
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), **SMALL)
    params = model_api.init_params(cfg, 0, device="cpu")
    cat = catalog_api.embedding_catalog(n=400, dim=16, seed=1)
    eng = SimCacheEngine(cfg, params, EngineConfig(algo=algo, **ECFG, **kw),
                         cat.coords, device="cpu")
    return eng, cfg, cat


def trace(n_batches, batch=16, seed=0, cat=None):
    """(ids, prompts) per batch from the reference suite's zipf(1.1)."""
    cat = cat or catalog_api.embedding_catalog(n=400, dim=16, seed=1)
    dem = demand_api.zipf(cat, alpha=1.1, seed=3)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        ids, _ = dem.sample(batch, rng)
        out.append((ids, rng.integers(0, 256, (batch, 8)).astype(np.int32)))
    return out


def run(eng, batches, to_prompts=np.asarray):
    outs = []
    for ids, prompts in batches:
        o, _ = eng.serve(ids, to_prompts(prompts))
        outs.append([None if x is None else int(np.asarray(x)[0])
                     for x in o])
    stats, eng.stats = eng.stats, type(eng.stats)()
    return stats, outs


def test_engine_matches_reference_cold_refresh_warm():
    jcfg = dataclasses.replace(jget_smoke("granite-3-2b"), **SMALL)
    jparams = jmodel.init_params(jcfg, 0)
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), **SMALL)
    model = convert.from_jax_params(cfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    coords = jcat.embedding_catalog(n=400, dim=16, seed=1).coords
    jeng = JEngine(jcfg, jparams, JConfig(**ECFG), coords)
    eng = SimCacheEngine(cfg, model, EngineConfig(**ECFG), coords,
                         device="cpu")
    cold, warm = trace(4), trace(8, seed=1)
    results = []
    for e, conv in ((jeng, jnp.asarray), (eng, np.asarray)):
        s_cold, o_cold = run(e, cold, conv)
        pred = e.refresh_placement()
        s_warm, o_warm = run(e, warm, conv)
        results.append((s_cold, o_cold, pred, e.placement.slots, s_warm,
                        o_warm))
    (jc, joc, jpred, jslots, jw, jow), (c, oc, pred, slots, w, ow) = results
    np.testing.assert_array_equal(slots, jslots)
    assert pred == pytest.approx(jpred, rel=1e-4)
    for a, b in ((c, jc), (w, jw)):
        assert (a.n_requests, a.n_hits, a.model_calls) == \
            (b.n_requests, b.n_hits, b.model_calls)
        assert abs(a.total_cost - b.total_cost) <= \
            0.1 * a.n_hits + 1e-5 * b.total_cost
    assert w.hit_rate > 0.5 and c.hit_rate == 0.0
    assert oc == joc and ow == jow


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
def test_engine_warm_start_matches_reference(device):
    """``EngineConfig(warm_start=True)``: the hierarchy reduces to a §4
    chain, so every refresh is the continuous-limit warm start (NumPy
    solve and map, then the polish on the device control plane or the
    host). Cold, refresh, warm, then one background refresh on the
    window: the same slots, hits, responses and costs as the reference's
    engine, within this file's tolerance; the background refresh installs
    what a synchronous refresh of the same window gives."""
    jcfg = dataclasses.replace(jget_smoke("granite-3-2b"), **SMALL)
    jparams = jmodel.init_params(jcfg, 0)
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), **SMALL)
    model = convert.from_jax_params(cfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    coords = jcat.embedding_catalog(n=400, dim=16, seed=1).coords
    kw = dict(ECFG, warm_start=True, device_placement=device)
    jeng = JEngine(jcfg, jparams, JConfig(**kw), coords)
    eng = SimCacheEngine(cfg, model, EngineConfig(**kw), coords,
                         device="cpu")
    cold, warm = trace(4), trace(8, seed=1)
    results = []
    for e, conv in ((jeng, jnp.asarray), (eng, np.asarray)):
        s_cold, o_cold = run(e, cold, conv)
        pred = e.refresh_placement()
        slots = e.placement.slots.copy()
        s_warm, o_warm = run(e, warm, conv)
        assert e.request_refresh() and e.wait_refresh(timeout=300)
        assert e.poll_refresh()
        results.append((s_cold, o_cold, pred, slots, s_warm, o_warm,
                        e.placement.slots.copy(), e.last_predicted_cost))
    (jc, joc, jpred, jslots, jw, jow, jbg, jbg_pred), \
        (c, oc, pred, slots, w, ow, bg, bg_pred) = results
    np.testing.assert_array_equal(slots, jslots)
    np.testing.assert_array_equal(bg, jbg)
    # C(A) is Σ λ·cost with Σ λ = 1: the per-hit 0.1 bounds it whole (the
    # host evaluator prices hits with the matmul form's noise)
    assert abs(pred - jpred) <= 0.1 + 1e-5 * jpred
    assert abs(bg_pred - jbg_pred) <= 0.1 + 1e-5 * jbg_pred
    for a, b in ((c, jc), (w, jw)):
        assert (a.n_requests, a.n_hits, a.model_calls) == \
            (b.n_requests, b.n_hits, b.model_calls)
        assert abs(a.total_cost - b.total_cost) <= \
            0.1 * a.n_hits + 1e-5 * b.total_cost
    assert w.hit_rate > 0.5 and c.hit_rate == 0.0
    assert oc == joc and ow == jow
    t = eng.solve_timings
    assert set(t) == {"warm_solve_s", "warm_map_s", "warm_polish_s",
                      "warm_swaps", "solve_s"}
    assert t["warm_swaps"] >= 0 and min(t.values()) >= 0.0
    assert eng.refresh_placement() == pytest.approx(bg_pred, rel=0, abs=0)
    np.testing.assert_array_equal(eng.placement.slots, bg)


def test_observed_placement_tail_matches():
    """Never-requested objects keep an exact-zero rate, so once the real
    gains are exhausted the f64 host GREEDY and the f32 device GREEDY
    stop at the same pick and leave the same slots empty (mirrors the
    reference's test of the same name)."""
    from repro_torch.core.objective import DeviceInstance
    from repro_torch.core.placement import device_greedy, greedy
    eng, cfg, cat = make_engine(algo="greedy")
    eng.counts[0, :12] = 2.0 ** np.arange(12)
    inst = eng.observed_instance()
    host = greedy(inst)
    dinst = DeviceInstance.from_instance(inst, materialize_ca=False,
                                         device="cpu")
    for scan in (True, False):
        np.testing.assert_array_equal(host, device_greedy(dinst, scan=scan))
    assert (host < 0).sum() > 0          # the tail regime was entered
    pred_dev = eng.refresh_placement(device=True)
    slots_dev = eng.placement.slots.copy()
    pred_host = eng.refresh_placement(device=False)
    np.testing.assert_array_equal(slots_dev, eng.placement.slots)
    assert abs(pred_dev - pred_host) < 1e-3 * eng.ecfg.h_model


@pytest.mark.parametrize("algo", ["greedy", "localswap"])
def test_other_algorithms_serve(algo):
    eng, cfg, cat = make_engine(algo=algo)
    run(eng, trace(4))
    assert eng.refresh_placement() > 0
    stats, _ = run(eng, trace(8, seed=2))
    assert stats.mean_cost < eng.ecfg.h_model


@pytest.mark.parametrize("variant", [dict(fused=False), dict(bucket=False)])
def test_looped_and_unbucketed_serve_identically(variant):
    """fused ≡ looped and bucketed ≡ unbucketed, stat for stat."""
    runs = []
    for kw in ({}, variant):
        eng, cfg, cat = make_engine(**kw)
        run(eng, trace(4))
        eng.refresh_placement()
        runs.append(run(eng, trace(6, batch=13, seed=5)))
    (a, oa), (b, ob) = runs
    assert (a.n_hits, a.model_calls, a.total_cost, a.total_approx_cost) == \
        (b.n_hits, b.model_calls, b.total_cost, b.total_approx_cost)
    assert oa == ob


def test_calibrate_rebuilds_simcache():
    eng, cfg, cat = make_engine(algo="greedy")
    run(eng, trace(4))
    eng.refresh_placement()
    keys_before = [lv.keys.clone() for lv in eng.simcache.levels]
    v0 = eng.placement.version
    ms = eng.calibrate(np.zeros((4, 8), np.int32))
    assert ms > 0 and eng.ecfg.h_model == ms
    assert eng.ecfg.h_ici < eng.ecfg.h_dcn < eng.ecfg.h_model
    assert [lv.h for lv in eng.simcache.levels] == \
        [0.0, eng.ecfg.h_ici, eng.ecfg.h_dcn]
    assert eng.simcache.h_repo == ms
    assert eng.placement.version > v0
    for a, lv in zip(keys_before, eng.simcache.levels):
        assert torch.equal(a, lv.keys)
    stats, _ = run(eng, trace(4, seed=7))
    assert stats.n_requests == 64


def test_background_refresh_cycle():
    eng, cfg, cat = make_engine()
    run(eng, trace(4))
    v0 = eng.placement_version
    assert eng.request_refresh()
    assert not eng.request_refresh()          # one in flight at a time
    assert eng.wait_refresh(timeout=300)
    assert eng.refresh_in_flight
    assert eng.poll_refresh()
    assert not eng.refresh_in_flight and not eng.poll_refresh()
    assert eng.placement_version == v0 + 1 and eng.swap_count == 1
    assert eng.last_predicted_cost > 0
    assert set(eng.solve_timings) >= {"greedy_s", "polish_s", "solve_s"}
    stats, _ = run(eng, trace(4, seed=3))
    assert stats.n_hits > 0


def test_engine_counts_duplicates_in_batch():
    eng, cfg, cat = make_engine()
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 5, size=32) for _ in range(6)]
    for ids in batches:
        eng.serve(ids, rng.integers(0, cfg.vocab, (len(ids), 8)))
    expected = np.zeros(cat.n)
    for ids in batches:
        for o in ids:
            expected[int(o)] += 1.0
    np.testing.assert_array_equal(eng.counts[0], expected)
    assert eng.counts[0, :5].sum() == 6 * 32


def test_observed_instance_cold_uniform_and_unfloored():
    eng, cfg, cat = make_engine()
    inst = eng.observed_instance()
    np.testing.assert_allclose(inst.lam, 1.0 / cat.n)
    eng.counts[0, :3] = [1.0, 2.0, 5.0]
    lam = eng.observed_instance().lam
    np.testing.assert_array_equal(lam[0, :3], np.array([1, 2, 5]) / 8.0)
    assert np.all(lam[0, 3:] == 0.0)


@pytest.mark.parametrize("flag", [
    dict(prune="lsh"), dict(verify=True), dict(quantize=True), dict(sharded=True)])
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        make_engine(**flag)


def test_multi_ingress_net_raises():
    """Without a strategy plane a multi-ingress network fails where the
    reference's does: at the install, since the fused simcache serves one
    ingress row of H (cold serving prices repository misses first)."""
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), **SMALL)
    cat = catalog_api.embedding_catalog(n=50, dim=4, seed=1)
    from repro_torch.core.topology import tandem_both
    params = model_api.init_params(cfg, 0, device="cpu")
    eng = SimCacheEngine(cfg, params, EngineConfig(), cat.coords,
                         net=tandem_both(2, 2, 1.0, 5.0), device="cpu")
    assert eng.routing is None
    ids, prompts = trace(1, cat=cat)[0]
    eng.serve(ids % 50, prompts, ingress_ids=ids % 2)
    assert eng.stats.n_hits == 0 and eng.counts.shape == (2, 50)
    assert eng.stats.total_cost == eng.ecfg.h_model * len(ids)
    with pytest.raises(ValueError, match="multi-ingress"):
        eng.refresh_placement()
    assert eng.simcache is None and eng.placement.version == 0
    # a custom single-ingress net serves with its own costs
    eng = SimCacheEngine(cfg, model_api.init_params(cfg, 0, device="cpu"),
                         EngineConfig(), cat.coords,
                         net=chain(2, [3, 4], [0.0, 2.0], 50.0),
                         device="cpu")
    for ids, prompts in trace(3, cat=cat):
        eng.serve(ids % 50, prompts)
    eng.refresh_placement()
    assert [lv.h for lv in eng.simcache.levels] == [0.0, 2.0]


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no card an entry point asked for the default device raises;
    it never slides onto the CPU."""
    from repro_torch.core.objective import DeviceInstance
    from repro_torch.core.simcache import SimCacheNetwork
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), **SMALL)
    cat = catalog_api.embedding_catalog(n=20, dim=4, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimCacheEngine(cfg, None, EngineConfig(), cat.coords)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_api.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimCacheNetwork.from_placement(cat.coords, np.zeros(2, np.int64),
                                       np.zeros(2, np.int64), [0.0], 1.0)
    eng, _, _ = make_engine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceInstance.from_instance(eng.observed_instance())
