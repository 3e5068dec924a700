"""The engine's refresh gate and its multi-ingress strategy serving,
against the JAX reference's engine, on the CPU. Mirrors the refresh-gate
part of tests/test_streaming.py and the engine's ``strategy`` branch.

* The gate (``EngineConfig.refresh_min_gain``): stationary demand skips
  the cadence's refresh requests, a drift of the demand's shape
  (``StreamDriver.set_streams`` to uniform demand) triggers them; off by
  default, with no baseline ever set. Where the gate's outcome is
  compared with the reference's, each request's background solve is
  waited for where it starts (``_synced``), so the swap points, and with
  them every count, do not depend on thread timing; the reference's own
  copy of the no-regression test depends on that timing and fails under
  load.
* A multi-ingress scenario served through each of the five strategies:
  hits, model calls and responses equal to the reference engine's on the
  same trace and weights, and the total cost bitwise (the strategy plane
  prices in host f64, copied line for line).

Tolerances: the surrogate's cost to 1e-5 relative (tests/
test_torch_hitrate.py); the placement engine's total cost to 0.1 per
hit plus 1e-5 relative (tests/test_torch_engine.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import get_smoke_config as jget_smoke
from repro.core import catalog as jcatalog
from repro.core import demand as jdemand
from repro.core import scenarios as jscenarios
from repro.models import model as jmodel
from repro.serve import EngineConfig as JConfig
from repro.serve import SimCacheEngine as JEngine
from repro.serve import StreamDriver as JDriver
from repro.serve import StreamSpec as JSpec
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import catalog as catalog_api
from repro_torch.core import demand as demand_api
from repro_torch.core import scenarios
from repro_torch.core.routing import STRATEGIES
from repro_torch.models import convert
from repro_torch.models import model as model_api
from repro_torch.serve import (EngineConfig, SimCacheEngine, StreamDriver,
                               StreamSpec)
from torch_threads import one_thread  # noqa: F401

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=256)
ECFG = dict(k_device=8, k_pod=12, k_global=16, h_ici=1.0, h_dcn=10.0,
            h_model=100.0, metric="l2", algo="greedy")
GATE = 10.0                  # the reference test's gate at h_model 100


def make_engine(**ecfg_kw):
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), **SMALL)
    params = model_api.init_params(cfg, 0, device="cpu")
    cat = catalog_api.embedding_catalog(n=300, dim=16, seed=1)
    eng = SimCacheEngine(cfg, params, EngineConfig(**ECFG, **ecfg_kw),
                         cat.coords, device="cpu")
    return eng, cfg, cat


def twin_engines(net=None, jnet=None, coords=None, **ecfg_kw):
    """The reference's engine and the port's, on the same weights (the
    JAX tree loaded through repro_torch.models.convert) and catalog."""
    jcfg = dataclasses.replace(jget_smoke("granite-3-2b"), **SMALL)
    jparams = jmodel.init_params(jcfg, 0)
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), **SMALL)
    model = convert.from_jax_params(cfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    if coords is None:
        coords = jcatalog.embedding_catalog(n=300, dim=16, seed=1).coords
    jeng = JEngine(jcfg, jparams, JConfig(**ECFG, netduel=False, **ecfg_kw),
                   coords, net=jnet)
    eng = SimCacheEngine(cfg, model, EngineConfig(**ECFG, **ecfg_kw),
                         coords, net=net, device="cpu")
    return jeng, eng


def _streams(cat, api=demand_api, spec=StreamSpec, n=3):
    rates = [5.0, 9.0, 2.0]
    return [spec(demand=api.zipf(cat, alpha=1.1, seed=s + 1),
                 rate=rates[s % len(rates)], seed=s + 1, name=f"user{s}")
            for s in range(n)]


def _synced(eng):
    """Make every started background solve finish where it starts: the
    driver's next ``poll_refresh`` (right after the request) swaps it
    in, so the swap points are fixed batches."""
    request = eng.request_refresh

    def request_and_wait(*args, **kw):
        started = request(*args, **kw)
        assert eng.wait_refresh(timeout=300)
        return started
    eng.request_refresh = request_and_wait


# ===================================================================
# the refresh gate
# ===================================================================
def test_refresh_gate_skips_stationary_triggers_on_drift():
    """Under stationary demand the cadence's requests are skipped (no
    solve starts, nothing swaps); after the stream population turns
    uniform the predicted cost moves past the gate and solves start and
    swap again. Background solves run as the driver leaves them."""
    eng, cfg, cat = make_engine(refresh_min_gain=GATE)
    drv = StreamDriver(eng, _streams(cat), max_batch=32, batch_window=2.0)
    drv.run(300)
    eng.refresh_placement()
    base = eng._surrogate_baseline
    assert base is not None and 0.0 < base < eng.ecfg.h_model
    drv.refresh_every = 4
    st1 = drv.run(300)
    drv.drain_refresh()
    assert st1.refresh_skipped > 0
    assert st1.refresh_triggered == 0 and st1.refreshes_started == 0
    assert eng.swap_count == 0 and eng._surrogate_baseline == base
    drv.set_streams([StreamSpec(demand=demand_api.uniform(cat), rate=5.0,
                                seed=99)])
    st2 = drv.run(600)
    drv.drain_refresh()
    assert st2.refresh_triggered > 0
    assert st2.refreshes_started == st2.refresh_triggered
    assert eng.swap_count > 0
    assert eng._surrogate_baseline != base
    assert eng.stats.refresh_skipped >= st1.refresh_skipped
    assert eng.stats.refresh_triggered == st2.refresh_triggered


def test_refresh_gate_matches_reference():
    """The gated engine and driver against the reference's, every solve
    waited for where it starts: the same skipped and triggered counts in
    the stationary and the drifted window, the same swaps, the same
    surrogate baselines (to 1e-5), hits and model calls."""
    jeng, eng = twin_engines(refresh_min_gain=GATE)
    jcat = jcatalog.embedding_catalog(n=300, dim=16, seed=1)
    cat = catalog_api.embedding_catalog(n=300, dim=16, seed=1)
    runs = []
    for e, drv_cls, spec, api, c in (
            (jeng, JDriver, JSpec, jdemand, jcat),
            (eng, StreamDriver, StreamSpec, demand_api, cat)):
        _synced(e)
        drv = drv_cls(e, _streams(c, api, spec), max_batch=32,
                      batch_window=2.0)
        drv.run(300)
        e.refresh_placement()
        bases = [e._surrogate_baseline]
        drv.refresh_every = 4
        st1 = drv.run(300)
        drv.set_streams([spec(demand=api.uniform(c), rate=5.0, seed=99)])
        st2 = drv.run(600)
        drv.drain_refresh()
        bases.append(e._surrogate_baseline)
        runs.append(dict(
            counts=[(s.refresh_skipped, s.refresh_triggered,
                     s.refreshes_started, s.swaps, s.batch_sizes)
                    for s in (st1, st2)],
            bases=bases, slots=np.asarray(e.placement.slots),
            stats=e.stats))
    ref, got = runs
    assert got["counts"] == ref["counts"]
    (sk1, tr1, *_), (sk2, tr2, *_) = got["counts"]
    assert sk1 > 0 and tr1 == 0 and tr2 > 0
    np.testing.assert_allclose(got["bases"], ref["bases"], rtol=1e-5)
    np.testing.assert_array_equal(got["slots"], ref["slots"])
    a, b = got["stats"], ref["stats"]
    assert (a.n_requests, a.n_hits, a.model_calls, a.refresh_skipped,
            a.refresh_triggered) == (b.n_requests, b.n_hits, b.model_calls,
                                     b.refresh_skipped, b.refresh_triggered)
    assert abs(a.total_cost - b.total_cost) <= \
        0.1 * a.n_hits + 1e-5 * b.total_cost


def test_refresh_gate_off_by_default():
    eng, cfg, cat = make_engine()
    assert eng.ecfg.refresh_min_gain == 0.0
    drv = StreamDriver(eng, _streams(cat), max_batch=32, batch_window=2.0,
                       refresh_every=4)
    drv.run(64)
    eng.refresh_placement()
    st = drv.run(256)
    drv.drain_refresh()
    assert st.refreshes_started > 0
    assert st.refresh_skipped == 0 and st.refresh_triggered == 0
    assert eng.stats.refresh_skipped == eng.stats.refresh_triggered == 0
    assert eng._surrogate_baseline is None


def test_refresh_gate_no_serving_cost_regression():
    """Skipped solves cost no serving quality: on the same stationary
    trace the gated engine's mean cost stays within 5 % of the
    always-refresh engine's. Every started solve is waited for where it
    starts, so both runs swap at fixed batches."""
    costs, solves = {}, {}
    for gain in (0.0, GATE):
        eng, cfg, cat = make_engine(refresh_min_gain=gain)
        _synced(eng)
        drv = StreamDriver(eng, _streams(cat), max_batch=32,
                           batch_window=2.0, refresh_every=4)
        drv.run(300)
        eng.refresh_placement()
        st = drv.run(500)
        drv.drain_refresh()
        costs[gain] = eng.stats.mean_cost
        solves[gain] = st.refreshes_started
    assert solves[0.0] > 0 and solves[GATE] < solves[0.0]
    assert costs[GATE] <= costs[0.0] * 1.05, \
        f"gated serving cost {costs[GATE]:.3f} regressed vs " \
        f"always-refresh {costs[0.0]:.3f}"


# ===================================================================
# multi-ingress strategy serving
# ===================================================================
def _scenario_trace(n_batches=6, batch=24, seed=0):
    sc = scenarios.scenario("scale_free", cache_budget=40,
                            placement="degree", n_ingress=4, seed=3)
    jsc = jscenarios.scenario("scale_free", cache_budget=40,
                              placement="degree", n_ingress=4, seed=3)
    cat = catalog_api.embedding_catalog(n=300, dim=16, seed=1)
    # C_a on the network's cost scale: the 2 % quantile of the pairwise
    # distances at half the median on-path slack, so approximate hits
    # happen beside exact ones
    H = np.asarray(sc.net.H, np.float64)
    slack = (np.asarray(sc.net.h_repo)[:, None] - H)[np.isfinite(H)]
    d = np.sqrt(((cat.coords[:, None] - cat.coords[None]) ** 2).sum(-1))
    scale = 0.5 * np.median(slack) / np.quantile(d[d > 0], 0.02)
    coords = (cat.coords * scale).astype(np.float32)
    dem = demand_api.zipf(cat, alpha=1.0, n_ingress=4, seed=5)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        ids, ings = dem.sample(batch, rng)
        batches.append((ids, ings, rng.integers(0, 256, (batch, 8)).astype(
            np.int32)))
    return sc, jsc, coords, batches


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_engine_matches_reference(strategy):
    sc, jsc, coords, batches = _scenario_trace()
    jeng, eng = twin_engines(net=sc.net, jnet=jsc.net, coords=coords,
                             strategy=strategy, strategy_threshold=None,
                             strategy_seed=3)
    outs = []
    for e, conv in ((jeng, jnp.asarray), (eng, np.asarray)):
        got = []
        for ids, ings, prompts in batches:
            o, _ = e.serve(ids, conv(prompts), ingress_ids=ings)
            got.append([None if x is None else int(np.asarray(x)[0])
                        for x in o])
        outs.append(got)
    assert outs[1] == outs[0]
    a, b = eng.stats, jeng.stats
    assert (a.n_requests, a.n_hits, a.model_calls, a.total_cost,
            a.total_approx_cost) == (b.n_requests, b.n_hits, b.model_calls,
                                     b.total_cost, b.total_approx_cost)
    assert a.n_hits > 0 and a.total_approx_cost > 0.0
    np.testing.assert_array_equal(eng.counts, jeng.counts)
    for keys, jkeys in zip(eng.routing.contents(), jeng.routing.contents()):
        np.testing.assert_array_equal(keys, jkeys)
    assert eng.simcache is None and eng.duel is None
    # the fused simcache cannot take the multi-ingress net: installing a
    # solve fails as the reference's does
    with pytest.raises(ValueError, match="multi-ingress"):
        eng.refresh_placement()


def test_strategy_threshold_reaches_the_plane():
    sc, _, coords, batches = _scenario_trace(n_batches=3)
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), **SMALL)
    eng = SimCacheEngine(
        cfg, model_api.init_params(cfg, 0, device="cpu"),
        EngineConfig(**ECFG, strategy="sim-lru", strategy_threshold=0.0,
                     strategy_seed=2),
        coords, net=sc.net, device="cpu")
    assert (eng.routing.threshold, eng.routing.strategy) == (0.0, "sim-lru")
    for ids, ings, prompts in batches:
        eng.serve(ids, prompts, ingress_ids=ings)
    assert eng.stats.n_hits > 0 and eng.stats.total_approx_cost == 0.0
