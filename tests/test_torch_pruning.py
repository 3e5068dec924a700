"""The port's LSH / k-means pruned lookup (kernels/knn/lsh.py,
kernels/knn/ops.pruned_fused_lookup, SimCacheNetwork.lookup with
``prune``) on the CPU: its own contracts, mirrored from the unsharded
tests of tests/test_lsh_pruning.py, and the JAX reference's entry on
identical inputs.

What must hold:
* **exactness** — ``lookup(prune=..., verify=True)`` is bit for bit the
  exact fused lookup and the looped one, for both policies, every metric,
  γ ≠ 1, B = 1 and a 700-query batch, empty levels, duplicate keys at
  the tie-break, and a hot bucket past its capacity;
* **recall** — default tables find the exact winner for ≥ 99 % of the
  queries drawn from the paper's Gaussian-grid and Zipf demands, and
  pruning only raises the cost;
* **staleness** — a pruned lookup after mutating ``levels`` without
  ``invalidate_layout()`` raises; the memo keeps one entry per policy;
* **oracle** — the entry and ``pruned_fused_lookup_ref`` agree: same
  winners, costs to 1e-6, the same bound;
* **the reference** — the same tables through the JAX entry
  (``use_pallas=False``): the same candidate union (the tables are
  bitwise, and no SimHash margin of these queries lies within the
  1e-5·‖q‖·‖plane‖ rule of tests/test_torch_lsh.py), so the same bound
  bit for bit, the same winners, and costs within
  tests/test_torch_lookup.py's ``cost_tol``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lookup import (assert_port_results_equal, cost_tol,
                               make_nets)

from repro.kernels.knn import pruned_fused_lookup as jpfl
from repro.kernels.knn import lsh as jlsh
from repro_torch.core import catalog as catalog_api
from repro_torch.core import demand as demand_api
from repro_torch.core.simcache import REPO_LEVEL, CacheLevel, SimCacheNetwork
from repro_torch.kernels.knn import (KMeansPolicy, SimHashPolicy,
                                     pruned_fused_lookup,
                                     pruned_fused_lookup_ref)

# probes both buckets of every 1-bit table → every valid key is a
# candidate, so pruning is a pure re-indexing of the exact scan
COVER_ALL = SimHashPolicy(n_tables=2, n_bits=1, n_probes=2)


def _q(rng, nq, d=6, scale=2.0):
    return torch.as_tensor((rng.standard_normal((nq, d)) * scale)
                           .astype(np.float32))


def lookup_recall(pruned, exact) -> float:
    """Share of queries whose pruned lookup found the exact winner (the
    reference bench's definition: the same payload at the same level)."""
    same = (pruned.payload == exact.payload) & (pruned.level == exact.level)
    return float(same.float().mean())


# ------------------------------------------------------------- exactness
@pytest.mark.parametrize("prune", ["lsh", "kmeans"])
@pytest.mark.parametrize("metric,gamma", [("l2", 1.0), ("l1", 1.0),
                                          ("l2sq", 1.0), ("l2", 2.0)])
def test_pruned_verify_bit_identical(prune, metric, gamma):
    for seed, sizes, hs, h_repo, nq in [
        (0, [5, 9, 3], [0.0, 0.5, 1.0], 2.0, 23),
        (1, [17, 2, 31, 8], [0.0, 0.2, 0.7, 1.3], 3.0, 1),      # B=1
        (5, [200, 150, 250], [0.0, 0.4, 0.8], 2.5, 700),
    ]:
        _, net, rng = make_nets(seed, sizes, hs, h_repo, metric, gamma)
        q = _q(rng, nq)
        res = net.lookup(q, prune=prune, verify=True)
        assert_port_results_equal(res, net._lookup_fused(q))
        assert_port_results_equal(res, net._lookup_looped(q),
                                  exact_cost=gamma == 1.0)


def test_pruned_verify_rescans_what_the_tables_miss():
    """Narrow tables miss winners; verify re-scans exactly those queries
    whose cost reaches the bound, and the result is the exact one."""
    _, net, rng = make_nets(15, [300, 200], [0.0, 0.2], 9.0)
    net.candidate_policy = SimHashPolicy(n_tables=1, n_bits=6, n_probes=1)
    q = _q(rng, 64)
    exact = net._lookup_fused(q)
    got = net.lookup(q, prune="lsh")
    assert lookup_recall(got, exact) < 1.0
    assert bool((got.cost >= exact.cost).all())
    res = net.lookup(q, prune="lsh", verify=True)
    assert_port_results_equal(res, exact)
    assert net.rescan_calls == 1 and net.rescan_queries > 0


def test_pruned_full_coverage_equals_exact_without_verify():
    _, net, rng = make_nets(2, [64, 64], [0.0, 1.0], 5.0)
    net.candidate_policy = COVER_ALL
    q = _q(rng, 23)
    assert_port_results_equal(net.lookup(q, prune="lsh"),
                              net._lookup_fused(q))
    keys, h_key, meta = net.fused_layout()
    t = COVER_ALL.build(keys.numpy(), meta[3].numpy() > 0)
    *_, bound = pruned_fused_lookup_ref(q, keys, h_key, meta, t,
                                        cap_union=keys.shape[0], h_repo=5.0)
    assert float(bound) >= 1e38


def test_pruned_tie_break_duplicates_to_lower_level():
    """Two levels with equal h and an identical key at slot 5 of both:
    with every key a candidate, the winner is the lower concatenated
    index (level 0), verified or not."""
    rng = np.random.default_rng(42)
    dup = np.ones((1, 6), np.float32)

    def mk():
        return np.concatenate(
            [(rng.standard_normal((5, 6)) * 9 + 20).astype(np.float32), dup,
             (rng.standard_normal((2, 6)) * 9 + 20).astype(np.float32)])
    levels = [CacheLevel(keys=torch.as_tensor(mk()),
                         values=torch.arange(8 * j, 8 * j + 8,
                                             dtype=torch.int32), h=0.5)
              for j in range(2)]
    net = SimCacheNetwork(levels=levels, h_repo=9.0,
                          candidate_policy=COVER_ALL)
    q = torch.as_tensor(np.broadcast_to(dup, (3, 6)).copy())
    for verify in (False, True):
        res = net.lookup(q, prune="lsh", verify=verify)
        assert res.level.tolist() == [0, 0, 0]
        assert res.slot.tolist() == [5, 5, 5]
        assert_port_results_equal(res, net._lookup_fused(q))


# --------------------------------------------------------------- recall
@pytest.mark.parametrize("prune", ["lsh", "kmeans"])
@pytest.mark.parametrize("workload", ["gauss", "zipf"])
def test_recall_on_paper_demands(prune, workload):
    rng = np.random.default_rng(7)
    if workload == "gauss":
        cat = catalog_api.grid(L=40)                     # 1600 objects
        dem = demand_api.gaussian_grid(cat, sigma=8.0)
        metric = "l1"
    else:
        cat = catalog_api.embedding_catalog(n=2000, dim=16, seed=3)
        dem = demand_api.zipf(cat, alpha=0.8, seed=4)
        metric = "l2"
    stored = rng.choice(cat.n, 600, replace=False)
    levels = [CacheLevel(
        keys=torch.as_tensor(cat.coords[idx]),
        values=torch.as_tensor(idx.astype(np.int32)), h=float(h))
        for idx, h in ((stored[:400], 0.0), (stored[400:], 0.5))]
    net = SimCacheNetwork(levels=levels, h_repo=1e9, metric=metric)
    obj, _ = dem.sample(512, rng)
    q = torch.as_tensor(cat.coords[obj])
    pruned = net.lookup(q, prune=prune)
    exact = net._lookup_fused(q)
    r = lookup_recall(pruned, exact)
    assert r >= 0.99, (prune, workload, r)
    assert bool((pruned.cost >= exact.cost).all())


# ----------------------------------------------------- sentinel masking
@pytest.mark.parametrize("prune", ["lsh", "kmeans"])
def test_empty_level_sentinels_never_candidates(prune):
    _, net, rng = make_nets(3, [4, 1, 4], [0.0, 0.1, 0.4], 2.5, "l2sq",
                            empty=(1,))
    keys, _, meta = net.fused_layout()
    sentinel_row = 4                      # level 1's single sentinel slot
    assert int(meta[3, sentinel_row]) == 0
    for policy in (SimHashPolicy(), KMeansPolicy()):
        t = policy.build(keys.numpy(), meta[3].numpy() > 0)
        assert not np.any(t.buckets == sentinel_row)
    q = torch.as_tensor(rng.standard_normal((11, 6)).astype(np.float32))
    for verify in (False, True):
        res = net.lookup(q, prune=prune, verify=verify)
        assert not bool((res.level == 1).any())
        assert bool(torch.isfinite(res.cost).all())
    assert_port_results_equal(net.lookup(q, prune=prune, verify=True),
                              net._lookup_fused(q))

    _, net_all, rng = make_nets(4, [1, 1], [0.0, 0.3], 7.5, "l2",
                                empty=(0, 1))
    q = torch.as_tensor(rng.standard_normal((5, 6)).astype(np.float32))
    res = net_all.lookup(q, prune=prune, verify=True)
    np.testing.assert_array_equal(res.level.numpy(), REPO_LEVEL)
    np.testing.assert_allclose(res.cost.numpy(), 7.5)
    np.testing.assert_array_equal(res.payload.numpy(), -1)


@pytest.mark.parametrize("kw", [dict(prune="lsh"), dict(quantize=True),
                                dict(prune="kmeans", quantize=True)])
def test_no_levels_at_all(kw):
    net = SimCacheNetwork(levels=[], h_repo=4.5, metric="l2")
    q = torch.as_tensor(np.random.default_rng(0)
                        .standard_normal((6, 5)).astype(np.float32))
    res = net.lookup(q, verify=True, **kw)
    np.testing.assert_array_equal(res.level.numpy(), REPO_LEVEL)
    np.testing.assert_allclose(res.cost.numpy(), 4.5)


# ------------------------------------------------------------ staleness
@pytest.mark.parametrize("kw", [dict(prune="lsh"), dict(quantize=True)])
def test_stale_tables_fail_loudly(kw):
    _, net, rng = make_nets(10, [4, 4], [0.0, 0.5], 3.0, "l2")
    q = torch.as_tensor(rng.standard_normal((8, 6)).astype(np.float32))
    net.lookup(q, **kw)                          # builds layout + tables
    net.levels[0] = CacheLevel(
        keys=torch.as_tensor(rng.standard_normal((5, 6)).astype(np.float32)),
        values=torch.arange(100, 105, dtype=torch.int32), h=0.0)
    with pytest.raises(RuntimeError, match="stale candidate tables"):
        net.lookup(q, **kw)
    net.lookup(q)              # the un-pruned path serves the stale layout
    net.invalidate_layout()
    assert not net._tables
    assert_port_results_equal(net.lookup(q, verify=True, **kw),
                              net._lookup_looped(q))


def test_invalidate_layout_clears_tables_memo():
    _, net, rng = make_nets(11, [6, 3], [0.0, 0.4], 2.0, "l2")
    q = torch.as_tensor(rng.standard_normal((4, 6)).astype(np.float32))
    net.lookup(q, prune="lsh")
    net.lookup(q, prune="kmeans")
    assert len(net._tables) == 2           # memoized per (policy, shards)
    net.lookup(q, prune="lsh")
    assert len(net._tables) == 2           # a hit, not a rebuild
    net.invalidate_layout()
    assert not net._tables and net._layout is None


# ------------------------------------------------------ ops — ref oracle
def test_pruned_ops_matches_ref_oracle():
    _, net, rng = make_nets(7, [40, 25], [0.0, 0.4], 2.0, "l2", gamma=2.0)
    q = torch.as_tensor(rng.standard_normal((19, 6)).astype(np.float32))
    keys, h_key, meta = net.fused_layout()
    pol = SimHashPolicy(n_tables=2, n_bits=3, n_probes=2)
    t = pol.build(keys.numpy(), meta[3].numpy() > 0)
    cap = pol.resolve_cap(keys.shape[0])
    out_k = pruned_fused_lookup(q, keys, h_key, meta,
                                torch.as_tensor(t.proj),
                                torch.as_tensor(t.buckets), kind=t.kind,
                                n_probes=t.n_probes, cap_union=cap,
                                metric="l2", gamma=2.0, h_repo=2.0)
    out_r = pruned_fused_lookup_ref(q, keys, h_key, meta, t, cap,
                                    metric="l2", gamma=2.0, h_repo=2.0)
    for a, b in zip(out_k, out_r):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_hot_bucket_capped_and_verify_still_exact():
    """One bucket of near-duplicate keys: the per-bucket capacity clamps
    at 8× the mean load, the overflow is dropped at build time, and the
    dropped members count as un-scanned, so verify stays exact."""
    rng = np.random.default_rng(0)
    hot = np.ones((1, 6), np.float32) + \
        0.001 * rng.standard_normal((500, 6)).astype(np.float32)
    cold = (rng.standard_normal((100, 6)) * 9 + 20).astype(np.float32)
    keys = np.concatenate([hot, cold])
    net = SimCacheNetwork(
        levels=[CacheLevel(keys=torch.as_tensor(keys),
                           values=torch.arange(600, dtype=torch.int32),
                           h=0.5)], h_repo=9.0)
    _, _, meta = net.fused_layout()
    t = SimHashPolicy(n_bits=4).build(keys, meta[3].numpy() > 0)
    assert t.buckets.shape[-1] <= 8 * -(-600 // 16)   # capped, not 500
    q = torch.as_tensor(np.concatenate(
        [hot[:3], cold[:3], rng.standard_normal((4, 6)).astype(np.float32)]))
    assert_port_results_equal(net.lookup(q, prune="lsh", verify=True),
                              net._lookup_fused(q))


# ----------------------------------------------------------- the reference
@pytest.mark.parametrize("kind", ["lsh", "kmeans"])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("metric,gamma", [("l2", 1.0), ("l1", 1.0),
                                          ("l2", 2.0)])
def test_pruned_matches_reference(kind, quantize, metric, gamma):
    jnet, net, rng = make_nets(8, [150, 90, 120], [0.0, 0.3, 0.7], 2.5,
                               metric, gamma)
    qn = (rng.standard_normal((33, 6)) * 2).astype(np.float32)
    keys, h_key, meta = net.fused_layout()
    jkeys, jh, jmeta = jnet.fused_layout()
    pol = (SimHashPolicy(n_tables=3, n_bits=4, n_probes=2) if kind == "lsh"
           else KMeansPolicy(n_clusters=9, n_probes=2))
    jpol = getattr(jlsh, type(pol).__name__)(
        **{f.name: getattr(pol, f.name) for f in dataclasses.fields(pol)})
    t = pol.build(keys.numpy(), meta[3].numpy() > 0)
    jt = jpol.build(np.asarray(jkeys), np.asarray(jmeta)[3] > 0)
    np.testing.assert_array_equal(t.buckets, jt.buckets)
    cap = pol.resolve_cap(keys.shape[0]) // 3
    out = pruned_fused_lookup(
        torch.as_tensor(qn), keys, h_key, meta, torch.as_tensor(t.proj),
        torch.as_tensor(t.buckets), kind=kind, n_probes=t.n_probes,
        cap_union=cap, metric=metric, gamma=gamma, h_repo=2.5,
        quantize=quantize, top_t=6)
    jout = jpfl(jnp.asarray(qn), jkeys, jh, jmeta, jnp.asarray(jt.proj),
                jnp.asarray(jt.buckets), kind=kind, n_probes=jt.n_probes,
                cap_union=cap, metric=metric, gamma=gamma, h_repo=2.5,
                use_pallas=False, quantize=quantize, top_t=6)
    if quantize:          # vT: tests/test_torch_quantized.py's tolerance
        b, jb = out[5].double().numpy(), np.asarray(jout[5], np.float64)
        assert np.all(np.abs(b - jb) <= 4e-6 * np.abs(jb) + 1e-6)
    else:
        assert float(out[5]) == float(jout[5])
    for i in (2, 3, 4):                       # level, slot, payload
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(jout[i]))
    ca = np.asarray(jout[1])
    tol = cost_tol(qn, keys.numpy(), ca, metric, gamma)
    assert np.all(np.abs(out[0].numpy() - np.asarray(jout[0])) <= tol)
