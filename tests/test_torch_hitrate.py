"""The port's Che hit-rate plane (``repro_torch.core.analysis``) against
the JAX reference's, on the CPU (``device="cpu"``). Mirrors
tests/test_hitrate.py.

What is held, and to what:

* the ball structure of :func:`similarity_balls` (exact mode): ``idx``
  and ``q`` equal (``q`` to 1e-6 in the RND-LRU mode, where it is
  computed from ``dist``), ``dist`` to one f32 step (2^-23 relative):
  both enumerate in f64 by direct differences, summed in different
  orders;
* T from :func:`solve_characteristic_time` to ``T_RTOL`` = 1e-4
  relative, with its +inf and 0 edges exact: both solve in f32 (the
  reference's jitted solve with x64 off), but torch's ``expm1`` and sum
  order are not XLA's, and the bisection turns an ulp of Σπ into a few
  ulps of T;
* the network fixed point's occupancies and hit probabilities to
  ``P_ATOL`` = 1e-5 absolute, and the aggregate hit rate and mean cost
  of :func:`predict_hitrates` and :func:`surrogate_cost` to
  ``AGG_RTOL`` = 1e-5 relative: what moves them is T and the f32
  passes, a few f32 ulps each;
* the LSH enumeration is not ported: ``mode="lsh"`` and ``mode="auto"``
  past 20,000 objects raise ``NotImplementedError`` naming item 10.
"""
import numpy as np
import pytest

from repro.core import topology as jtopology
from repro.core import scenarios as jscenarios
from repro.core.analysis import hitrate as R
from repro.core.routing import StrategyPlane as JStrategyPlane
from repro_torch.core import catalog as catalog_api
from repro_torch.core import demand as demand_api
from repro_torch.core import scenarios, topology
from repro_torch.core.analysis import (HitRatePrediction, exact_hit_balls,
                                       predict_hitrates, rescaled_coords,
                                       similarity_balls,
                                       solve_characteristic_time,
                                       surrogate_cost)
from repro_torch.core.analysis import hitrate as P
from repro_torch.core.routing import StrategyPlane

T_RTOL = 1e-4
P_ATOL = 1e-5
AGG_RTOL = 1e-5
CPU = dict(device="cpu")


def _zipf_rates(n, alpha=0.8, seed=0):
    rng = np.random.default_rng(seed)
    lam = 1.0 / (rng.permutation(n) + 1.0) ** alpha
    return lam / lam.sum()


def _same_T(T, jT):
    T, jT = np.atleast_1d(T), np.atleast_1d(jT)
    np.testing.assert_array_equal(np.isinf(T), np.isinf(jT))
    np.testing.assert_array_equal(T == 0.0, jT == 0.0)
    fin = np.isfinite(jT)
    np.testing.assert_allclose(T[fin], jT[fin], rtol=T_RTOL)


def _same_prediction(p, jp):
    assert isinstance(p, HitRatePrediction)
    _same_T(p.T, jp.T)
    for f in ("occupancy", "hit_prob", "serve_prob", "ingress_hit_rate",
              "cache_hit_rate"):
        np.testing.assert_allclose(getattr(p, f), getattr(jp, f), rtol=0,
                                   atol=P_ATOL, err_msg=f)
    assert p.hit_rate == pytest.approx(jp.hit_rate, rel=AGG_RTOL)
    assert p.mean_cost == pytest.approx(jp.mean_cost, rel=AGG_RTOL)
    assert p.n_sweeps == jp.n_sweeps


# ===================================================================
# characteristic-time solver
# ===================================================================
@pytest.mark.parametrize("n,cap,alpha", [(300, 25.0, 0.8), (300, 3.0, 0.8),
                                         (50, 49.0, 0.8), (2000, 400, 1.2),
                                         (1000, 1, 0.5)])
def test_solver_matches_reference(n, cap, alpha):
    lam = _zipf_rates(n, alpha)
    T = solve_characteristic_time(lam, cap, **CPU)
    assert isinstance(T, float)
    _same_T(T, R.solve_characteristic_time(lam, cap))
    # the constraint itself is met tightly
    assert np.sum(-np.expm1(-lam * T)) == pytest.approx(cap, rel=1e-3)


def test_solver_edges_match_reference():
    lam = _zipf_rates(50)
    for cap in (50, 80, 0):
        T = solve_characteristic_time(lam, cap, **CPU)
        assert T == R.solve_characteristic_time(lam, cap)
    assert np.isinf(solve_characteristic_time(lam, 50, **CPU))
    assert solve_characteristic_time(lam, 0, **CPU) == 0.0
    lam3 = np.stack([lam, lam, lam])
    caps = np.array([10.0, 0.0, 50.0])
    T = solve_characteristic_time(lam3, caps, **CPU)
    assert T.shape == (3,) and T.dtype == np.float64
    assert 0.0 < T[0] < np.inf and T[1] == 0.0 and np.isinf(T[2])
    _same_T(T, R.solve_characteristic_time(lam3, caps))
    # an object with zero rate never counts toward the reachable set
    lam_z = lam.copy()
    lam_z[:10] = 0.0
    for cap in (40, 41, 20):
        _same_T(solve_characteristic_time(lam_z, cap, **CPU),
                R.solve_characteristic_time(lam_z, cap))


def test_two_rate_solver_matches_reference():
    rng = np.random.default_rng(3)
    mu = rng.random((4, 500)) * _zipf_rates(500, seed=3)
    nu = rng.random((4, 500)) * _zipf_rates(500, seed=4)
    nu[:, :50] = 0.0
    caps = np.array([5.0, 30.0, 450.0, 0.0])
    _same_T(solve_characteristic_time(mu, caps, entry_rates=nu, **CPU),
            R.solve_characteristic_time(mu, caps, entry_rates=nu))
    lam = _zipf_rates(200, seed=3)
    assert solve_characteristic_time(lam, 20, **CPU) == \
        solve_characteristic_time(lam, 20, entry_rates=lam, **CPU)


def test_solver_scale_invariance():
    lam = _zipf_rates(150, seed=5)
    T1 = solve_characteristic_time(lam, 12, **CPU)
    T2 = solve_characteristic_time(100.0 * lam, 12, **CPU)
    assert T2 == pytest.approx(T1 / 100.0, rel=1e-3)


# ===================================================================
# similarity balls
# ===================================================================
def _same_balls(b, jb, q_atol=0.0):
    assert (b.n_objects, b.theta, b.truncated, b.max_size) == \
        (jb.n_objects, jb.theta, jb.truncated, jb.max_size)
    assert b.idx.dtype == jb.idx.dtype and b.q.dtype == jb.q.dtype
    np.testing.assert_array_equal(b.idx, jb.idx)
    np.testing.assert_allclose(b.q, jb.q, rtol=0, atol=q_atol)
    np.testing.assert_allclose(b.dist, jb.dist, rtol=2.0 ** -23, atol=0)
    assert b.mean_size == jb.mean_size


def test_exact_hit_balls_are_the_references():
    _same_balls(exact_hit_balls(7), R.exact_hit_balls(7))
    coords = np.random.default_rng(0).normal(size=(7, 3)).astype(np.float32)
    for theta in (0.0, -1.0, None):
        _same_balls(similarity_balls(coords, theta, **CPU),
                    R.exact_hit_balls(7))


@pytest.mark.parametrize("metric,gamma", [("l2", 1.0), ("l1", 1.0),
                                          ("l2sq", 1.0), ("l2", 0.7)])
@pytest.mark.parametrize("q_mode", ["hard", "rnd"])
def test_similarity_balls_match_reference(metric, gamma, q_mode):
    cat = catalog_api.embedding_catalog(n=250, dim=4, seed=2)
    # θ at the 2 % quantile of this metric's off-diagonal C_a
    d = np.asarray(R._block_ca_np(cat.coords, cat.coords, metric, gamma))
    theta = float(np.quantile(d[d > 0], 0.02))
    b = similarity_balls(cat.coords, theta, metric=metric, gamma=gamma,
                         q_mode=q_mode, mode="exact", block=96, **CPU)
    jb = R.similarity_balls(cat.coords, theta, metric=metric, gamma=gamma,
                            q_mode=q_mode, mode="exact")
    assert b.mean_size > 1.0
    _same_balls(b, jb, q_atol=1e-6 if q_mode == "rnd" else 0.0)
    assert np.all(b.idx[:, 0] == np.arange(250))
    assert np.all(b.dist[:, 0] == 0.0)


def test_similarity_balls_auto_and_max_ball_match_reference():
    cat = catalog_api.embedding_catalog(n=200, dim=4, seed=6)
    for max_ball in (None, 3):
        b = similarity_balls(cat.coords, theta=120.0, max_ball=max_ball,
                             **CPU)
        jb = R.similarity_balls(cat.coords, theta=120.0, max_ball=max_ball)
        _same_balls(b, jb)
    assert b.max_size == 3 and b.truncated > 0


def test_lsh_enumeration_raises_naming_item_10():
    coords = np.zeros((30, 2), np.float32)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        similarity_balls(coords, 1.0, mode="lsh", **CPU)
    big = np.zeros((P.EXACT_MAX_OBJECTS + 1, 2), np.float32)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        similarity_balls(big, 1.0, **CPU)
    with pytest.raises(ValueError, match="unknown mode"):
        similarity_balls(coords, 1.0, mode="ann", **CPU)
    with pytest.raises(ValueError, match="unknown metric"):
        similarity_balls(coords, 1.0, metric="cos", mode="exact", **CPU)


# ===================================================================
# the network fixed point
# ===================================================================
def _rescaled(n, dim, net, seed):
    """The bench's rescaled ``embedding_catalog(n, dim, seed)``."""
    cat = catalog_api.embedding_catalog(n=n, dim=dim, seed=seed)
    coords, theta = rescaled_coords(net, cat.coords, seed)
    return coords, theta, cat


@pytest.mark.parametrize("family", ["scale_free", "isp"])
def test_rescaled_coords_are_the_benchs(family):
    """``rescaled_coords`` against the reference bench's own rescaling
    (benchmarks/hitrate_bench.py ``_rescaled_catalog``, which draws an
    8-wide ``embedding_catalog``): θ and the coordinates bitwise."""
    from benchmarks import hitrate_bench
    sc = scenarios.scenario(family, cache_budget=32, placement="degree",
                            n_ingress=4, seed=3)
    jsc = jscenarios.scenario(family, cache_budget=32, placement="degree",
                              n_ingress=4, seed=3)
    jcat, jtheta = hitrate_bench._rescaled_catalog(600, jsc.net, 2)
    coords, theta, _ = _rescaled(600, 8, sc.net, seed=2)
    assert theta == jtheta
    np.testing.assert_array_equal(coords, jcat.coords)


def test_single_cache_exact_hit_matches_reference():
    cat = catalog_api.embedding_catalog(n=300, dim=8, seed=1)
    net = topology.single_cache(30, 150.0)
    dem = demand_api.zipf(cat, alpha=0.9, seed=2)
    p = predict_hitrates(net, dem.lam, exact_hit_balls(300), **CPU)
    _same_prediction(p, R.predict_hitrates(
        jtopology.single_cache(30, 150.0), dem.lam, R.exact_hit_balls(300)))
    assert p.occupancy.sum() == pytest.approx(30.0, rel=1e-2)


@pytest.mark.parametrize("q_mode", ["hard", "rnd"])
def test_single_cache_similarity_matches_reference(q_mode):
    cat = catalog_api.embedding_catalog(n=400, dim=8, seed=0)
    coords = np.asarray(cat.coords, np.float64)
    d = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    theta = float(np.quantile(d[d > 0], 0.02))
    dem = demand_api.zipf(cat, alpha=0.9, seed=2)
    b = similarity_balls(cat.coords, theta, q_mode=q_mode, mode="exact",
                         **CPU)
    jb = R.similarity_balls(cat.coords, theta, q_mode=q_mode, mode="exact")
    assert b.mean_size > 2.0
    p = predict_hitrates(topology.single_cache(30, 1e9), dem.lam, b, **CPU)
    _same_prediction(p, R.predict_hitrates(
        jtopology.single_cache(30, 1e9), dem.lam, jb))


@pytest.mark.parametrize("family", ["scale_free", "isp"])
@pytest.mark.parametrize("q_mode", [None, "hard", "rnd"])
def test_multi_ingress_scenario_matches_reference(family, q_mode):
    """The composition over a multi-ingress scenario, with exact-hit
    balls and with similarity balls on the bench's rescaled catalog
    (where the per-(ingress, cache) slack pruning binds)."""
    sc = scenarios.scenario(family, cache_budget=32, placement="degree",
                            n_ingress=4, seed=3)
    jsc = jscenarios.scenario(family, cache_budget=32, placement="degree",
                              n_ingress=4, seed=3)
    coords, theta, cat = _rescaled(400, 8, sc.net, seed=1)
    dem = demand_api.zipf(cat, alpha=1.0, n_ingress=4, seed=5)
    if q_mode is None:
        b, jb = exact_hit_balls(400), R.exact_hit_balls(400)
    else:
        b = similarity_balls(coords, theta, q_mode=q_mode, **CPU)
        jb = R.similarity_balls(coords, theta, q_mode=q_mode)
        assert b.mean_size > 1.5
    p = predict_hitrates(sc.net, dem.lam, b, **CPU)
    jp = R.predict_hitrates(jsc.net, dem.lam, jb)
    _same_prediction(p, jp)
    assert p.residual == pytest.approx(jp.residual, abs=1e-4)
    assert p.cache_hit_rate.sum() == pytest.approx(p.hit_rate, abs=1e-9)
    assert 0.0 < p.mean_cost <= float(sc.net.h_repo.max()) + 1e-9


def test_prediction_tracks_a_replay():
    """The reference suite's validity claim on the port's own pieces:
    exact-hit prediction against a SIM-LRU replay of 40,000 requests on
    a multi-ingress scenario, within 5 points (the reference's bound);
    the port's replay is the reference's, decision for decision."""
    sc = scenarios.scenario("scale_free", cache_budget=32,
                            placement="degree", n_ingress=4, seed=3)
    cat = catalog_api.embedding_catalog(n=400, dim=8, seed=1)
    dem = demand_api.zipf(cat, alpha=1.0, n_ingress=4, seed=5)
    pred = predict_hitrates(sc.net, dem.lam, exact_hit_balls(400), **CPU)
    pl = StrategyPlane(sc.net, cat.coords, strategy="sim-lru",
                       threshold=0.0, seed=7)
    jpl = JStrategyPlane(jscenarios.scenario(
        "scale_free", cache_budget=32, placement="degree", n_ingress=4,
        seed=3).net, cat.coords, strategy="sim-lru", threshold=0.0, seed=7)
    objs, ings = dem.sample(40_000, np.random.default_rng(7))
    dec, jdec = pl.serve(objs, ings), jpl.serve(objs, ings)
    np.testing.assert_array_equal(dec.hit, jdec.hit)
    measured = float(dec.hit[20_000:].mean())
    assert abs(pred.hit_rate - measured) < 0.05


def test_balls_object_count_mismatch_raises():
    with pytest.raises(ValueError, match="enumerated over"):
        predict_hitrates(topology.single_cache(5, 10.0),
                         np.ones((1, 20)) / 20.0, exact_hit_balls(10), **CPU)


# ===================================================================
# the engine surrogate
# ===================================================================
def test_surrogate_cost_matches_reference_and_tracks_drift():
    cat = catalog_api.embedding_catalog(n=250, dim=6, seed=0)
    net = topology.chain(3, [8, 8, 8], [1.0, 2.0, 4.0], 100.0)
    jnet = jtopology.chain(3, [8, 8, 8], [1.0, 2.0, 4.0], 100.0)
    lam_a = demand_api.zipf(cat, alpha=1.0, seed=1).lam
    lam_b = demand_api.zipf(cat, alpha=1.0, seed=9).lam
    c_a = surrogate_cost(net, lam_a, **CPU)
    assert c_a == pytest.approx(R.surrogate_cost(jnet, lam_a), rel=AGG_RTOL)
    assert c_a == surrogate_cost(net, lam_a.copy(), **CPU)
    assert abs(c_a - surrogate_cost(net, lam_b, **CPU)) > 0.0
    big = topology.chain(3, [32, 32, 32], [1.0, 2.0, 4.0], 100.0)
    assert surrogate_cost(big, lam_a, **CPU) < c_a
    assert 0.0 < c_a < 100.0
    uni = demand_api.uniform(cat).lam
    assert surrogate_cost(net, uni, **CPU) == pytest.approx(
        R.surrogate_cost(jnet, uni), rel=AGG_RTOL)


def test_surrogate_on_empirical_counts_matches_reference():
    """The refresh gate's input: an empirical demand window with many
    exact-zero rates, on the engine's three-level hierarchy."""
    net = topology.tpu_hierarchy(16, 24, 32, 1.0, 10.0, 100.0)
    jnet = jtopology.tpu_hierarchy(16, 24, 32, 1.0, 10.0, 100.0)
    cat = catalog_api.embedding_catalog(n=2000, dim=4, seed=0)
    objs, _ = demand_api.zipf(cat, alpha=1.0, seed=3).sample(
        700, np.random.default_rng(0))
    counts = np.zeros((1, 2000))
    np.add.at(counts, (0, objs), 1.0)
    lam = counts / counts.sum()
    assert surrogate_cost(net, lam, **CPU) == pytest.approx(
        R.surrogate_cost(jnet, lam), rel=AGG_RTOL)


def test_entry_points_default_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_characteristic_time(_zipf_rates(10), 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        surrogate_cost(topology.single_cache(3, 10.0), np.ones((1, 10)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        similarity_balls(np.zeros((5, 2), np.float32), 1.0)
