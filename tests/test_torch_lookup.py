"""The port's lookup data plane against the JAX reference, on the CPU.

Mirrors tests/test_kernels_knn.py and tests/test_fused_lookup.py. The
JAX side runs its Pallas kernels in interpret mode (the default off the
TPU); the port's wrappers run their plain PyTorch versions for CPU
tensors.

What must match, and to what tolerance:
* winners (index, level, slot, payload, hit) are equal wherever the
  reference's decision is not an f32 near-tie: a differing winner is
  accepted only when the port's own cost at the reference's winner lies
  within 2·tol of its minimum (:func:`assert_winners_agree`);
* costs agree within ``tol``: for l2 the matmul form's cancellation
  bound (tests/test_torch_costs.py::l2_tol) carried through γ, else
  1e-5 relative;
* inside the port the reference's own contracts hold exactly: fused ≡
  looped ≡ plain ref, costs bitwise for γ = 1 (1e-6 otherwise, as the
  reference allows).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.simcache import CacheLevel as JLevel
from repro.core.simcache import SimCacheNetwork as JNet
from repro.kernels.knn import fused_lookup as jfused
from repro.kernels.knn import nearest_approximizer as jknn
from repro.kernels.knn import pad_for_knn as jpad
from repro_torch.core.simcache import (REPO_LEVEL, SENTINEL_COORD,
                                       CacheLevel, SimCacheNetwork)
from repro_torch.kernels.knn import (fused_lookup, fused_lookup_ref,
                                     knn_ref, nearest_approximizer,
                                     pad_for_knn)
from repro_torch.kernels.knn.ref import _dense_ca

U32 = 2.0 ** -24


def cost_tol(q, k, ca, metric, gamma):
    """Per-query tolerance on a winning C_a near ``ca``."""
    if metric == "l1":
        return 1e-5 * np.abs(ca) + 1e-5
    t2 = 16 * U32 * ((q * q).sum(1) + (k * k).sum(1).max())
    d = ca ** (1.0 / gamma)
    if metric == "l2sq":
        tol_d = t2
    else:
        tol_d = t2 / (d + np.sqrt(t2))
    slope = gamma * np.maximum(d, 1e-3) ** (gamma - 1)
    return tol_d * np.maximum(slope, 1.0) + 1e-5 * np.abs(ca) + 1e-5


def assert_winners_agree(cost_rows, got, ref, ref_cost, tol):
    """``got`` may differ from ``ref`` only on a near-tie: the port's
    cost at the reference's winner within 2·tol of the port's min."""
    diff = np.nonzero(got != ref)[0]
    for r in diff:
        assert cost_rows[r, ref[r]] - ref_cost[r] <= 2 * tol[r], (
            r, got[r], ref[r])


def assert_port_results_equal(a, b, exact_cost=True):
    for name in ("level", "slot", "payload", "hit"):
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      getattr(b, name).numpy(), err_msg=name)
    for name in ("cost", "approx_cost"):
        x, y = getattr(a, name).numpy(), getattr(b, name).numpy()
        if exact_cost:
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6,
                                       err_msg=name)


SHAPES = [(1, 1, 2), (7, 3, 2), (100, 37, 5), (17, 9, 130), (300, 257, 40)]


@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
@pytest.mark.parametrize("shape", SHAPES)
def test_knn_matches_reference(metric, shape):
    Q, K, D = shape
    rng = np.random.default_rng(Q * 1000 + K)
    q = (rng.standard_normal((Q, D)) * 3).astype(np.float32)
    k = (rng.standard_normal((K, D)) * 3).astype(np.float32)
    mr, ar = (np.asarray(a) for a in jknn(jnp.asarray(q), jnp.asarray(k),
                                           metric=metric))
    md, am = nearest_approximizer(torch.as_tensor(q), torch.as_tensor(k),
                                  metric=metric)
    tol = cost_tol(q, k, mr, metric, 1.0)
    np.testing.assert_array_less(np.abs(md.numpy() - mr), tol)
    full = _dense_ca(torch.as_tensor(q), torch.as_tensor(k), metric,
                     1.0).numpy()
    assert_winners_agree(full, am.numpy(), ar, md.numpy(), tol)
    # the wrapper is the plain version on CPU tensors
    mp, ap = knn_ref(torch.as_tensor(q), torch.as_tensor(k), metric)
    assert torch.equal(md, mp) and torch.equal(am, ap)


@pytest.mark.parametrize("gamma", [0.5, 1.0, 2.0])
def test_knn_gamma(gamma):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((33, 7)).astype(np.float32)
    k = rng.standard_normal((21, 7)).astype(np.float32)
    mr, ar = (np.asarray(a) for a in jknn(jnp.asarray(q), jnp.asarray(k),
                                           metric="l2", gamma=gamma))
    md, am = nearest_approximizer(torch.as_tensor(q), torch.as_tensor(k),
                                  metric="l2", gamma=gamma)
    np.testing.assert_array_less(np.abs(md.numpy() - mr),
                                 cost_tol(q, k, mr, "l2", gamma))
    np.testing.assert_array_equal(am.numpy(), ar)


def test_knn_bf16_inputs():
    rng = np.random.default_rng(1)
    qj = jnp.asarray(rng.standard_normal((64, 32))).astype(jnp.bfloat16)
    kj = jnp.asarray(rng.standard_normal((48, 32))).astype(jnp.bfloat16)
    q = np.asarray(qj.astype(jnp.float32))
    k = np.asarray(kj.astype(jnp.float32))
    mr, ar = (np.asarray(a) for a in jknn(qj, kj, metric="l2sq"))
    md, am = nearest_approximizer(torch.as_tensor(q).bfloat16(),
                                  torch.as_tensor(k).bfloat16(),
                                  metric="l2sq")
    np.testing.assert_array_less(np.abs(md.numpy() - mr),
                                 cost_tol(q, k, mr, "l2sq", 1.0))
    np.testing.assert_array_equal(am.numpy(), ar)


def test_tie_breaks_to_lowest_index():
    q = torch.zeros((4, 8))
    k = torch.zeros((5, 8))                   # all keys identical
    _, am = nearest_approximizer(q, k, metric="l2")
    np.testing.assert_array_equal(am.numpy(), np.zeros(4, np.int32))


def test_pad_for_knn_matches_reference():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((5, 3)).astype(np.float32)
    k = rng.standard_normal((7, 3)).astype(np.float32)
    qr, kr = jpad(jnp.asarray(q), jnp.asarray(k), 8, 4)
    qp, kp = pad_for_knn(torch.as_tensor(q), torch.as_tensor(k), 8, 4)
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kr))


# ------------------------------------------------------------- the network
def make_nets(seed, sizes, hs, h_repo, metric="l2", gamma=1.0, d=6,
              empty=(), fused=True):
    """The same random multi-level network in both packages (levels in
    ``empty`` hold the sentinel key of an empty level), plus the rng."""
    rng = np.random.default_rng(seed)
    jl, tl = [], []
    for j, (k, h) in enumerate(zip(sizes, hs)):
        if j in empty:
            keys = np.full((1, d), SENTINEL_COORD, np.float32)
            vals = np.full((1,), -1, np.int32)
        else:
            keys = (rng.standard_normal((k, d)) * 2).astype(np.float32)
            vals = rng.integers(0, 10_000, k).astype(np.int32)
        jl.append(JLevel(keys=jnp.asarray(keys), values=jnp.asarray(vals),
                         h=float(h)))
        tl.append(CacheLevel(keys=torch.as_tensor(keys),
                             values=torch.as_tensor(vals), h=float(h)))
    return (JNet(levels=jl, h_repo=float(h_repo), metric=metric,
                 gamma=gamma),
            SimCacheNetwork(levels=tl, h_repo=float(h_repo), metric=metric,
                            gamma=gamma, fused=fused), rng)


def assert_matches_reference(jres, tres, q, keys, metric, gamma):
    ca_ref = np.asarray(jres.approx_cost)
    tol = cost_tol(q, keys, ca_ref, metric, gamma)
    np.testing.assert_array_less(
        np.abs(tres.cost.numpy() - np.asarray(jres.cost)), tol)
    # winners: compare (level, slot) as one key; differing ones must be
    # near-ties of the port's own costs
    same = ((tres.level.numpy() == np.asarray(jres.level))
            & (tres.slot.numpy() == np.asarray(jres.slot)))
    for r in np.nonzero(~same)[0]:
        assert abs(float(tres.cost[r]) - float(jres.cost[r])) <= 2 * tol[r]
    np.testing.assert_array_equal(tres.payload.numpy()[same],
                                  np.asarray(jres.payload)[same])
    np.testing.assert_array_equal(tres.hit.numpy()[same],
                                  np.asarray(jres.hit)[same])
    return same


@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
@pytest.mark.parametrize("gamma", [1.0, 0.5, 2.0])
def test_fused_matches_looped_and_reference(metric, gamma):
    for seed, sizes, hs, h_repo, nq in [
        (0, [5, 9, 3], [0.0, 0.5, 1.0], 2.0, 23),
        (1, [17, 2, 31, 8], [0.0, 0.2, 0.7, 1.3], 3.0, 23),
        (3, [200, 150, 250], [0.0, 0.4, 0.8], 2.5, 300),
    ]:
        jnet, net, rng = make_nets(seed, sizes, hs, h_repo, metric, gamma)
        q = (rng.standard_normal((nq, 6)) * 2).astype(np.float32)
        qt = torch.as_tensor(q)
        fused = net._lookup_fused(qt)
        assert_port_results_equal(fused, net._lookup_looped(qt),
                                  exact_cost=gamma == 1.0)
        keys = np.concatenate([np.asarray(lv.keys) for lv in jnet.levels])
        same = assert_matches_reference(jnet._lookup_fused(jnp.asarray(q)),
                                        fused, q, keys, metric, gamma)
        assert same.mean() > 0.9


@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
def test_fused_empty_levels_masked(metric):
    jnet, net, rng = make_nets(3, [4, 1, 4], [0.0, 0.1, 0.4], 2.5, metric,
                               empty=(1,))
    q = rng.standard_normal((11, 6)).astype(np.float32)
    res = net._lookup_fused(torch.as_tensor(q))
    assert not np.any(res.level.numpy() == 1)
    assert np.all(np.isfinite(res.cost.numpy()))
    assert_port_results_equal(res, net._lookup_looped(torch.as_tensor(q)))
    jres = jnet._lookup_fused(jnp.asarray(q))
    np.testing.assert_array_equal(res.level.numpy(), np.asarray(jres.level))
    np.testing.assert_array_equal(res.payload.numpy(),
                                  np.asarray(jres.payload))

    # all levels empty → everything served by the repository
    _, net2, _ = make_nets(4, [1, 1], [0.0, 0.5], 2.0, metric,
                           empty=(0, 1))
    res2 = net2.lookup(torch.as_tensor(q))
    np.testing.assert_array_equal(res2.level.numpy(), REPO_LEVEL)
    np.testing.assert_array_equal(res2.payload.numpy(), -1)


def test_fused_repo_wins_and_ties():
    """A key tying h_repo serves the request (repository only on strict
    improvement); a dominated cache loses to the repository."""
    keys = np.zeros((1, 3), np.float32)
    for h, h_repo, want in [(1.0, 1.0, 0), (1.5, 1.0, REPO_LEVEL)]:
        net = SimCacheNetwork(levels=[CacheLevel(
            keys=torch.as_tensor(keys), values=torch.tensor([7]), h=h)],
            h_repo=h_repo)
        jnet = JNet(levels=[JLevel(keys=jnp.asarray(keys),
                                   values=jnp.asarray([7]), h=h)],
                    h_repo=h_repo)
        q = np.zeros((2, 3), np.float32)
        for fused in (True, False):
            net.fused = fused
            res = net.lookup(torch.as_tensor(q))
            np.testing.assert_array_equal(res.level.numpy(), want)
        np.testing.assert_array_equal(
            np.asarray(jnet.lookup(jnp.asarray(q)).level), want)


def test_fused_no_levels_at_all():
    q = np.random.default_rng(0).standard_normal((6, 5)).astype(np.float32)
    net = SimCacheNetwork(levels=[], h_repo=4.5)
    res = net.lookup(torch.as_tensor(q))
    np.testing.assert_array_equal(res.level.numpy(), REPO_LEVEL)
    np.testing.assert_allclose(res.cost.numpy(), 4.5)
    np.testing.assert_array_equal(res.payload.numpy(), -1)
    assert_port_results_equal(res, net._lookup_looped(torch.as_tensor(q)))


@pytest.mark.parametrize("fold_repo", [True, False])
def test_fused_lookup_entry_matches_reference(fold_repo):
    """The public entry, including ``fold_repo=False`` (segment minima,
    +INF where no key is valid) and the zero-key repository case."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((9, 4)).astype(np.float32)
    k = rng.standard_normal((12, 4)).astype(np.float32)
    hk = rng.random(12).astype(np.float32)
    meta = np.stack([np.arange(12) % 3, np.arange(12), np.arange(12) + 50,
                     np.zeros(12) if not fold_repo else np.arange(12) % 4 > 0
                     ]).astype(np.int32)
    kw = dict(metric="l2", h_repo=0.9, repo_level=-1, fold_repo=fold_repo)
    ref = [np.asarray(a) for a in jfused(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(hk), jnp.asarray(meta),
                                         **kw)]
    got = [a.numpy() for a in fused_lookup(torch.as_tensor(q),
                                           torch.as_tensor(k),
                                           torch.as_tensor(hk),
                                           torch.as_tensor(meta), **kw)]
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)
    for i in range(5):        # zero keys: the repository (or +INF) only
        z = fused_lookup(torch.as_tensor(q), torch.zeros((0, 4)),
                         torch.zeros((0,)),
                         torch.zeros((4, 0), dtype=torch.int32),
                         **kw)[i].numpy()
        zr = np.asarray(jfused(jnp.asarray(q), jnp.zeros((0, 4)),
                               jnp.zeros((0,)), jnp.zeros((4, 0), jnp.int32),
                               **kw)[i])
        np.testing.assert_array_equal(z, zr)
    # the wrapper on CPU tensors is the plain version
    plain = fused_lookup_ref(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(hk), torch.as_tensor(meta),
                             **kw)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b.numpy())


def test_invalidate_layout_after_mutation():
    _, net, rng = make_nets(10, [4, 4], [0.0, 0.5], 3.0, "l2")
    q = torch.as_tensor(rng.standard_normal((8, 6)).astype(np.float32))
    net.lookup(q)                                  # memoize old layout
    net.levels[0] = CacheLevel(
        keys=torch.as_tensor(rng.standard_normal((5, 6)).astype(np.float32)),
        values=torch.arange(100, 105, dtype=torch.int32), h=0.0)
    with pytest.raises(RuntimeError):
        net._check_layout_fresh()                  # the staleness guard
    net.invalidate_layout()
    net._check_layout_fresh()
    assert_port_results_equal(net._lookup_fused(q), net._lookup_looped(q))


def test_from_placement_matches_reference():
    """from_placement → fused ≡ looped in the port, and the same winners
    as the reference's network, including an empty level."""
    from repro.core.simcache import SimCacheNetwork as JN
    rng = np.random.default_rng(9)
    coords = rng.standard_normal((40, 5)).astype(np.float32)
    slot_cache = np.array([0] * 4 + [1] * 4 + [2] * 4)
    slots = np.concatenate([rng.choice(40, 8, replace=False),
                            np.full(4, -1)]).astype(np.int64)
    kw = dict(hs=[0.0, 0.5, 1.0], h_repo=2.0, metric="l1")
    f = SimCacheNetwork.from_placement(coords, slots, slot_cache,
                                       device="cpu", **kw)
    lp = SimCacheNetwork.from_placement(coords, slots, slot_cache,
                                        fused=False, device="cpu", **kw)
    q = torch.as_tensor(coords[:25])
    assert_port_results_equal(f.lookup(q), lp.lookup(q))
    assert not np.any(f.lookup(q).level.numpy() == 2)
    j = JN.from_placement(coords, slots, slot_cache, **kw)
    jr = j.lookup(jnp.asarray(coords[:25]))
    np.testing.assert_array_equal(f.lookup(q).payload.numpy(),
                                  np.asarray(jr.payload))
    np.testing.assert_allclose(f.expected_cost(q),
                               j.expected_cost(jnp.asarray(coords[:25])),
                               rtol=1e-5)
