"""The port's on-path strategy plane (``repro_torch.core.routing``)
against the JAX reference's, on the CPU. Mirrors the strategy half of
tests/test_scenarios.py.

The module is NumPy only and copied line for line, and its coins come
from ``np.random.default_rng(seed)``, so a trace served by both planes
with the same seed is held bitwise: every field of every
``RouteDecision``, the LRU contents of every cache in LRU → MRU order,
and the insert, evict and serve counters. The reference suite's
conservation contract and edge cases (empty forwarding path, zero
capacity, duplicates in a batch, the RND-LRU clamps) run on the port's
copy, each against the reference's plane as well.
"""
import numpy as np
import pytest

from repro.core import routing as jrouting
from repro.core import scenarios as jscenarios
from repro.core import topology as jtopology
from repro_torch.core import routing, scenarios, topology
from repro_torch.core.routing import (STRATEGIES, RouteDecision,
                                      StrategyPlane, rnd_lru_serve_prob)


def test_strategy_names_are_the_references():
    assert STRATEGIES == jrouting.STRATEGIES


def _planes(net, jnet, coords, **kw):
    return (StrategyPlane(net, coords, **kw),
            jrouting.StrategyPlane(jnet, coords, **kw))


def _same_state(pl, jpl):
    assert (pl.n_served, pl.n_inserted, pl.n_evicted) == \
        (jpl.n_served, jpl.n_inserted, jpl.n_evicted)
    np.testing.assert_array_equal(pl.occupancy(), jpl.occupancy())
    for keys, jkeys in zip(pl.contents(), jpl.contents(), strict=True):
        np.testing.assert_array_equal(keys, jkeys)
    for p, jp in zip(pl.paths, jpl.paths, strict=True):
        np.testing.assert_array_equal(p, jp)


def _same_decision(dec, jdec):
    assert isinstance(dec, RouteDecision)
    for f in ("cost", "approx_cost", "hit", "cache", "payload"):
        a, b = getattr(dec, f), getattr(jdec, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _serve_both(pl, jpl, batches):
    for objs, ings in batches:
        dec, jdec = pl.serve(objs, ings), jpl.serve(objs, ings)
        _same_decision(dec, jdec)
        _same_state(pl, jpl)
        yield dec


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("threshold", [None, 2.5])
@pytest.mark.parametrize("family", ["watts_strogatz", "isp"])
def test_strategy_trace_bitwise(strategy, threshold, family):
    """One multi-ingress trace served by both planes: the same decisions
    and LRU contents after every batch; the conservation contract on
    the port's."""
    sc = scenarios.scenario(family, cache_budget=36, placement="degree",
                            n_ingress=5, seed=3)
    jsc = jscenarios.scenario(family, cache_budget=36, placement="degree",
                              n_ingress=5, seed=3)
    rng = np.random.default_rng(11)
    coords = rng.normal(size=(250, 6)).astype(np.float32)
    pl, jpl = _planes(sc.net, jsc.net, coords, strategy=strategy,
                      threshold=threshold, seed=5)
    # a skewed draw, so that exact repeats hit too
    batches = [(np.minimum(rng.zipf(1.3, size=64) - 1, 249),
                rng.integers(0, sc.net.n_ingress, size=64))
               for _ in range(6)]
    n_hits = 0
    for (objs, ings), dec in zip(batches, _serve_both(pl, jpl, batches)):
        assert np.all((dec.cache >= 0) == dec.hit)
        assert np.all(dec.payload[~dec.hit] == -1)
        assert np.all(dec.cost <= sc.net.h_repo[ings] + 1e-9)
        assert np.all(dec.cost[~dec.hit] == sc.net.h_repo[ings[~dec.hit]])
        if threshold is not None:
            assert np.all(dec.approx_cost[dec.hit] <= threshold + 1e-9)
        assert np.all(pl.occupancy() <= sc.net.capacities)
        n_hits += int(dec.hit.sum())
    assert n_hits > 0
    assert pl.n_served == 6 * 64
    for keys in pl.contents():
        assert len(keys) == len(set(keys.tolist()))


@pytest.mark.parametrize("metric,gamma", [("l1", 1.0), ("l2sq", 1.0),
                                          ("l2", 0.5)])
def test_strategy_metrics_bitwise(metric, gamma):
    sc = scenarios.scenario("scale_free", cache_budget=30, n_ingress=4,
                            seed=2)
    jsc = jscenarios.scenario("scale_free", cache_budget=30, n_ingress=4,
                              seed=2)
    rng = np.random.default_rng(4)
    coords = rng.normal(size=(120, 5)).astype(np.float32)
    for strategy in ("lcd", "probcache"):
        pl, jpl = _planes(sc.net, jsc.net, coords, metric=metric,
                          gamma=gamma, strategy=strategy, seed=1)
        batches = [(rng.integers(0, 120, size=40),
                    rng.integers(0, 4, size=40)) for _ in range(4)]
        for _ in _serve_both(pl, jpl, batches):
            pass


def test_strategy_exact_hit_zero_approx_cost():
    sc = scenarios.scenario("isp", cache_budget=30, placement="degree",
                            n_ingress=3, seed=0)
    coords = np.random.default_rng(0).normal(size=(50, 4)).astype(
        np.float32)
    pl = StrategyPlane(sc.net, coords, strategy="lce", seed=0)
    first = pl.serve(np.array([7]), np.array([0]))
    assert not first.hit[0]
    again = pl.serve(np.array([7]), np.array([0]))
    assert again.hit[0] and again.approx_cost[0] == 0.0
    assert again.payload[0] == 7 and again.cost[0] < first.cost[0]


def test_strategy_unknown_name_raises():
    sc = scenarios.scenario("isp", cache_budget=10, n_ingress=2, seed=0)
    with pytest.raises(ValueError, match="unknown strategy"):
        StrategyPlane(sc.net, np.zeros((10, 2)), strategy="mru")
    pl = StrategyPlane(sc.net, np.zeros((10, 2)), metric="cos")
    with pytest.raises(ValueError, match="unknown metric"):
        pl._ca(0, np.array([1]))


def test_build_strategy_is_the_plane():
    sc = scenarios.scenario("isp", cache_budget=20, n_ingress=2, seed=0)
    coords = np.random.default_rng(2).normal(size=(30, 3))
    pl = routing.build_strategy("rnd-lru", sc.net, coords, threshold=1.5,
                                seed=3)
    assert isinstance(pl, StrategyPlane)
    assert (pl.strategy, pl.threshold, pl.metric) == ("rnd-lru", 1.5, "l2")


# ===================================================================
# RND-LRU serving probability
# ===================================================================
def test_rnd_serve_prob_equals_reference_everywhere():
    for ca in np.linspace(0.0, 8.0, 33):
        for th in np.linspace(-2.0, 8.0, 41):
            q = rnd_lru_serve_prob(float(ca), float(th))
            assert q == jrouting.rnd_lru_serve_prob(float(ca), float(th))
            assert 0.0 <= q <= 1.0
    assert rnd_lru_serve_prob(2.0, 1.0) == 0.0
    assert rnd_lru_serve_prob(0.5, 0.0) == 0.0
    assert rnd_lru_serve_prob(0.5, -3.0) == 0.0
    assert rnd_lru_serve_prob(0.0, 0.0) == 1.0
    assert rnd_lru_serve_prob(1.0, 4.0) == pytest.approx(0.75)


def test_rnd_lru_exact_hit_threshold_zero_still_serves():
    net = topology.single_cache(4, 10.0)
    jnet = jtopology.single_cache(4, 10.0)
    coords = np.random.default_rng(0).normal(size=(20, 3))
    pl, jpl = _planes(net, jnet, coords, strategy="rnd-lru",
                      threshold=0.0, seed=0)
    batches = [(np.array([3]), np.array([0]))] * 6
    decs = list(_serve_both(pl, jpl, batches))
    assert not decs[0].hit[0]
    assert all(d.hit[0] and d.approx_cost[0] == 0.0 for d in decs[1:])


def test_rnd_lru_boundary_q_zero_falls_through_to_repo():
    """A key at exactly C_a = θ serves with q = 0: never; a key at
    C_a = θ/4 serves with q = 0.75 — the same coin outcomes as the
    reference's plane, seed by seed."""
    coords = np.zeros((3, 1))
    coords[1, 0] = 1.0
    coords[2, 0] = 0.25
    net = topology.single_cache(4, 100.0)
    jnet = jtopology.single_cache(4, 100.0)

    def first_serve_hits(obj, n_trials):
        hits = []
        for t in range(n_trials):
            pl, jpl = _planes(net, jnet, coords, strategy="rnd-lru",
                              threshold=1.0, seed=t)
            decs = list(_serve_both(pl, jpl, [
                (np.array([0]), np.array([0])),
                (np.array([obj]), np.array([0]))]))
            hits.append(int(decs[1].hit[0]))
        return np.mean(hits)

    assert first_serve_hits(1, 60) == 0.0
    assert 0.65 < first_serve_hits(2, 400) < 0.85


# ===================================================================
# edge cases: empty paths, zero capacity, duplicates
# ===================================================================
def _custom_nets(H, h_repo, capacities):
    H = np.asarray(H, np.float64)
    return [mod.CacheNetwork(
        n_caches=H.shape[1], capacities=np.asarray(capacities, np.int64),
        ingress=np.arange(H.shape[0]), H=H,
        h_repo=np.asarray(h_repo, np.float64), name="edge")
        for mod in (topology, jtopology)]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_empty_forwarding_path(strategy):
    net, jnet = _custom_nets(H=[[np.inf, np.inf], [0.5, 1.5]],
                             h_repo=[4.0, 6.0], capacities=[2, 2])
    coords = np.random.default_rng(1).normal(size=(30, 3))
    pl, jpl = _planes(net, jnet, coords, strategy=strategy, seed=2)
    assert len(pl.paths[0]) == 0
    rng = np.random.default_rng(5)
    batches = [(rng.integers(0, 30, 40), np.zeros(40, np.int64)),
               (rng.integers(0, 30, 40), np.ones(40, np.int64))]
    dec, dec2 = _serve_both(pl, jpl, batches)
    assert not dec.hit.any() and np.all(dec.cost == 4.0)
    assert np.all(dec2.cost <= 6.0 + 1e-9)
    assert np.all(pl.occupancy() <= net.capacities)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_zero_capacity_caches(strategy):
    net, jnet = _custom_nets(H=[[0.5, 1.0, 2.0]], h_repo=[8.0],
                             capacities=[0, 3, 0])
    coords = np.random.default_rng(2).normal(size=(40, 3))
    pl, jpl = _planes(net, jnet, coords, strategy=strategy, seed=1)
    rng = np.random.default_rng(9)
    batches = [(rng.integers(0, 40, 50), np.zeros(50, np.int64))
               for _ in range(4)]
    for dec in _serve_both(pl, jpl, batches):
        occ = pl.occupancy()
        assert occ[0] == 0 and occ[2] == 0 and occ[1] <= 3
        assert np.all((dec.cache == -1) | (dec.cache == 1))
    net0, jnet0 = _custom_nets(H=[[0.5]], h_repo=[8.0], capacities=[0])
    pl0, jpl0 = _planes(net0, jnet0, coords, strategy=strategy, seed=1)
    dec, = _serve_both(pl0, jpl0, [(rng.integers(0, 40, 30),
                                    np.zeros(30, np.int64))])
    assert not dec.hit.any() and np.all(dec.cost == 8.0)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_duplicate_objects_in_batch(strategy):
    sc = scenarios.scenario("isp", cache_budget=24, placement="degree",
                            n_ingress=2, seed=1)
    jsc = jscenarios.scenario("isp", cache_budget=24, placement="degree",
                              n_ingress=2, seed=1)
    coords = np.random.default_rng(3).normal(size=(60, 4))
    pl, jpl = _planes(sc.net, jsc.net, coords, strategy=strategy, seed=4)
    objs = np.array([7, 7, 7, 12, 12, 7, 3, 3, 3, 3])
    dec, = _serve_both(pl, jpl, [(objs, np.zeros(len(objs), np.int64))])
    assert pl.n_served == len(objs)
    assert np.all((dec.cache >= 0) == dec.hit)
    if strategy in ("lce", "sim-lru", "rnd-lru"):
        assert dec.hit[1] and dec.approx_cost[1] == 0.0
    for keys in pl.contents():
        assert len(keys) == len(set(keys.tolist()))
