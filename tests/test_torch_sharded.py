"""The port's sharded data and control planes (launch/mesh.py,
launch/sharding.py, the ``sharded_*`` entries of kernels/knn/ops.py and
kernels/knn/gains.py, core/objective.py's sharded best-two tables,
``SimCacheNetwork(sharded=True)`` and ``EngineConfig.sharded``) on the
CPU, at small shapes.

Mirrors the sharded parts of tests/test_sharded_lookup.py,
test_device_placement.py, test_netduel_device.py, test_quantized.py,
test_lsh_pruning.py, test_serve_engine.py and test_streaming.py. The
port's mesh holds no devices: a shard count is any positive integer and
the shards run in turn on the CPU, so every count is tested here, where
the reference needs a multi-device mesh.

What must hold:
* **inside the port, bitwise** — every sharded result equals its
  unsharded counterpart at every shard count, counts that do not divide
  K and counts larger than K included: lookups (exact, quantized,
  pruned, verified), the gain oracle's columns, the best-two tables, the
  GREEDY, LOCALSWAP and NETDUEL trajectories on a sharded
  ``DeviceInstance``, and the engine's served stats. On the CPU the gain
  oracle's plain version tiles the candidates from each shard's start,
  a multiple of 256, so its tiles are the unsharded call's and its
  columns too (no tolerance is needed for the CPU).
* **against the reference** — the reference promises its sharded
  results bitwise equal to its unsharded ones, so the port's n-way
  results are held against the reference's mesh-free oracles
  (``sharded_*_ref``) and its unsharded functions with the tolerances
  the earlier files state: tests/test_torch_lookup.py's ``cost_tol`` and
  near-tie rule for lookups, tests/test_torch_quantized.py's 4e-6·|vT| +
  1e-6 for the vT bound, tests/test_torch_pruning.py's bitwise bound for
  LSH (no SimHash margin of these queries within tests/test_torch_lsh.py
  's rule), tests/test_torch_gains.py's 5e-5 at kernel-level inputs and
  2.5e-4 relative / 5e-3 absolute on ``tree_instance``, and
  tests/test_torch_engine.py's exact slots, hits and responses. The
  reference's own sharded entries are called only on a 1-device mesh;
  its ``LookupShardPolicy`` and sharded engine are never built (they
  fail under JAX 0.9, ROADMAP queue 3 F1), nor is its 8-way reduction
  run (F2).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lookup import (assert_matches_reference,
                               assert_port_results_equal, cost_tol,
                               make_nets)
from test_torch_lsh import _excluded
from test_torch_netduel import JAX, PORT, KW, _crowded_settle
from test_torch_netduel import assert_device_equal, assert_duel_equal
from test_torch_netduel import \
    assert_matches_reference as assert_duel_matches_reference
from test_torch_netduel import tree_instance

from repro.configs.registry import get_smoke_config as jget_smoke
from repro.core import catalog as jcat
from repro.core.objective import DeviceInstance as JDevInst
from repro.core.placement import device_netduel as jdevice_netduel
from repro.core.placement import greedy as jgreedy
from repro.kernels.knn import lsh as jlsh
from repro.kernels.knn import sharded_placement_gains as jsharded_gains
from repro.kernels.knn.ref import sharded_fused_lookup_ref as jsharded_ref
from repro.kernels.knn.ref import \
    sharded_pruned_fused_lookup_ref as jsharded_pruned_ref
from repro.kernels.knn.ref import \
    sharded_quantized_fused_lookup_ref as jsharded_quant_ref
from repro.models import model as jmodel
from repro.serve import EngineConfig as JConfig
from repro.serve import SimCacheEngine as JEngine
from repro_torch import tracecount
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import catalog, demand
from repro_torch.core.objective import DeviceInstance, sharded_best_two
from repro_torch.core.placement import (device_greedy, device_localswap,
                                        device_netduel, greedy, netduel)
from repro_torch.core.simcache import REPO_LEVEL, CacheLevel, SimCacheNetwork
from repro_torch.kernels.knn import (KMeansPolicy, SimHashPolicy,
                                     fused_lookup, pad_to_shards,
                                     placement_gains, shard_meta,
                                     sharded_fused_lookup,
                                     sharded_fused_lookup_ref,
                                     sharded_placement_gains,
                                     sharded_pruned_fused_lookup,
                                     sharded_pruned_fused_lookup_ref,
                                     sharded_quantized_fused_lookup,
                                     sharded_quantized_fused_lookup_ref)
from repro_torch.launch.mesh import (ShardMesh, make_debug_mesh,
                                     make_lookup_mesh)
from repro_torch.launch.sharding import LookupShardPolicy, _resolve
from repro_torch.models import convert
from repro_torch.models import model as model_api
from repro_torch.serve import EngineConfig, SimCacheEngine

COUNTS = [1, 2, 3, 5, 8, 17]
# probes both buckets of every 1-bit table: every valid key a candidate
COVER_ALL = SimHashPolicy(n_tables=2, n_bits=1, n_probes=2)


def sharded(net: SimCacheNetwork, n: int) -> SimCacheNetwork:
    """The same levels behind an n-shard one-axis mesh."""
    return dataclasses.replace(net, sharded=True, mesh=make_lookup_mesh(n))


def _q(rng, nq, d=6, scale=2.0):
    return (rng.standard_normal((nq, d)) * scale).astype(np.float32)


def _as_result(out):
    """A (cost, C_a, level, slot, payload) tuple as a LookupResult-like
    object for the reference comparisons."""
    cost, ca, lvl, slot, pay = (np.asarray(a) for a in out[:5])
    return types.SimpleNamespace(
        cost=cost, approx_cost=ca, level=lvl, slot=slot, payload=pay,
        hit=lvl != REPO_LEVEL)


def _port_result(out):
    return types.SimpleNamespace(
        cost=out[0], approx_cost=out[1], level=out[2], slot=out[3],
        payload=out[4], hit=out[2] != REPO_LEVEL)


# ================================================================ mesh
def test_shard_mesh_contract():
    m = make_debug_mesh(2, 4)
    assert m.axis_names == ("data", "model") and m.size == 8
    assert list(m.shape.items()) == [("data", 2), ("model", 4)]
    assert make_lookup_mesh(5).shape == {"data": 5}
    assert hash(make_lookup_mesh(3)) == hash(make_lookup_mesh(3))
    for bad in ((("data",), (0,)), (("a", "a"), (1, 1)), (("a",), (1, 2))):
        with pytest.raises(ValueError):
            ShardMesh(*bad)


def test_lookup_shard_policy_contract():
    """Axes preferred model → data → pod, every axis of a mesh with none
    of them; n_shards the product. A one-axis ("data",) mesh resolves to
    ("data",), where the reference's ``tuple`` of a one-name spec splits
    the string under JAX 0.9 (F1)."""
    pol = LookupShardPolicy.create(make_lookup_mesh(1))
    assert pol.axes == ("data",) and pol.n_shards == 1
    assert pol.gain_shard_args() is None
    pol2 = LookupShardPolicy.create(make_debug_mesh(1, 1))
    assert pol2.axes == ("model", "data")
    pol3 = LookupShardPolicy.create(ShardMesh(("lookup",), (1,)))
    assert pol3.axes == ("lookup",)
    pol4 = LookupShardPolicy.create(make_debug_mesh(2, 4))
    assert pol4.axes == ("model", "data") and pol4.n_shards == 8
    assert pol4.gain_shard_args() == (pol4.mesh, ("model", "data"))
    assert pol4.control_plane_args(False) is None
    assert pol4.candidate_policy() is None
    pol5 = LookupShardPolicy.create(make_lookup_mesh(3), prune="kmeans",
                                    table_seed=4)
    assert pol5.candidate_policy() == KMeansPolicy(seed=4)
    # the resolver: divisibility, and no axis used twice across dims
    m = make_debug_mesh(2, 3)
    assert _resolve((6, 4), ("a", "b"), {"a": ("data", "model"),
                                         "b": ("data",)}, m) == \
        (("data", "model"), None)
    assert _resolve((4,), ("a",), {"a": ("model", "data")}, m) == \
        (("data",),)


# ======================================================= exact lookup
@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
@pytest.mark.parametrize("n_shards", COUNTS)
def test_sharded_lookup_bitwise_and_reference(metric, n_shards):
    """The sharded entry and network equal the fused lookup bit for bit
    at every shard count (padding past K = 17 included), and the
    reference's mesh-free oracle within the lookup tolerance."""
    jnet, net, rng = make_nets(0, [5, 9, 3], [0.0, 0.5, 1.0], 2.0, metric)
    q = _q(rng, 23)
    qt = torch.as_tensor(q)
    ref = net._lookup_fused(qt)
    keys, h_key, meta = net.fused_layout()
    mesh = make_lookup_mesh(n_shards)
    out = sharded_fused_lookup(qt, *pad_to_shards(keys, h_key, meta,
                                                  n_shards),
                               mesh, ("data",), metric=metric, h_repo=2.0)
    assert_port_results_equal(_port_result(out), ref)
    oracle = sharded_fused_lookup_ref(qt, keys, h_key, meta, n_shards,
                                      metric=metric, h_repo=2.0)
    assert_port_results_equal(_port_result(oracle), ref)
    snet = sharded(net, n_shards)
    assert_port_results_equal(snet.lookup(qt), ref)
    jk, jh, jm = jnet.fused_layout()
    jout = _as_result(jsharded_ref(jnp.asarray(q), jk, jh, jm, n_shards,
                                   metric=metric, h_repo=2.0))
    assert_matches_reference(jout, snet.lookup(qt), q, keys.numpy(),
                             metric, 1.0)


@pytest.mark.parametrize("seed,sizes,hs,h_repo,nq,metric,gamma", [
    (1, [17, 2, 31, 8], [0.0, 0.2, 0.7, 1.3], 3.0, 1, "l2", 1.0),
    (3, [200, 150, 250], [0.0, 0.4, 0.8], 2.5, 300, "l1", 1.0),
    (3, [200, 150, 250], [0.0, 0.4, 0.8], 2.5, 300, "l2sq", 2.0),
], ids=["B1", "multi_tile", "gamma2"])
def test_sharded_eight_way_differential(seed, sizes, hs, h_repo, nq,
                                        metric, gamma):
    """The reference's 8-way differential, here in process: sharded ≡
    fused ≡ looped (costs bitwise for γ = 1, 1e-6 otherwise, as the
    reference allows the looped path), and the reference's fused
    network within the lookup tolerance."""
    jnet, net, rng = make_nets(seed, sizes, hs, h_repo, metric, gamma)
    q = _q(rng, nq)
    qt = torch.as_tensor(q)
    res = sharded(net, 8).lookup(qt)
    assert_port_results_equal(res, net._lookup_fused(qt))
    assert_port_results_equal(res, net._lookup_looped(qt),
                              exact_cost=gamma == 1.0)
    assert_matches_reference(jnet._lookup_fused(jnp.asarray(q)), res, q,
                             net.fused_layout()[0].numpy(), metric, gamma)


@pytest.mark.parametrize("n_shards", [2, 4, 7])
def test_sharded_empty_levels_and_repo(n_shards):
    """Sentinel keys of empty levels land in any shard and stay masked;
    an all-empty network serves everything from the repository."""
    _, net, rng = make_nets(3, [4, 1, 4], [0.0, 0.1, 0.4], 2.5, "l2sq",
                            empty=(1,))
    qt = torch.as_tensor(_q(rng, 11, scale=1.0))
    res = sharded(net, n_shards).lookup(qt)
    assert not bool((res.level == 1).any())
    assert_port_results_equal(res, net._lookup_fused(qt))
    _, net_all, rng = make_nets(4, [1, 1], [0.0, 0.3], 7.5, "l2",
                                empty=(0, 1))
    qt = torch.as_tensor(_q(rng, 5, scale=1.0))
    res = sharded(net_all, n_shards).lookup(qt)
    assert bool((res.cost == 7.5).all()) and bool((res.level == -1).all())
    assert bool((res.payload == -1).all())
    assert bool((res.approx_cost == 0.0).all())


def test_sharded_all_padding_shards():
    """5 keys over 8 shards: three shards hold padding only and return
    the shard-local no-key result (+INF, 0, repo_level, 0, −1); the
    reduction still gives the fused lookup."""
    _, net, rng = make_nets(6, [2, 3], [0.0, 0.5], 4.0)
    qt = torch.as_tensor(_q(rng, 9))
    keys, h_key, meta = pad_to_shards(*net.fused_layout(), 8)
    assert keys.shape[0] == 8
    for s in range(5, 8):
        out = fused_lookup(qt, keys[s:s + 1], h_key[s:s + 1],
                           meta[:, s:s + 1], h_repo=4.0, repo_level=-1,
                           fold_repo=False)
        assert bool((out[0] == 3.0e38).all())
        assert bool((out[1] == 0).all()) and bool((out[2] == -1).all())
        assert bool((out[3] == 0).all()) and bool((out[4] == -1).all())
    assert_port_results_equal(sharded(net, 8).lookup(qt),
                              net._lookup_fused(qt))


def test_sharded_no_levels_serves_repo():
    net = SimCacheNetwork(levels=[], h_repo=4.5, metric="l2", sharded=True,
                          mesh=make_lookup_mesh(3))
    res = net.lookup(torch.as_tensor(_q(np.random.default_rng(0), 6, 5)))
    assert bool((res.level == REPO_LEVEL).all())
    assert bool((res.cost == 4.5).all()) and not bool(res.hit.any())


def test_sharded_requires_mesh():
    with pytest.raises(ValueError, match="requires a mesh"):
        SimCacheNetwork(levels=[], h_repo=1.0, sharded=True)


def test_stale_layout_then_invalidate_sharded():
    """The memoization contract on the sharded plane: mutating ``levels``
    without invalidate_layout() serves the stale layout verbatim;
    invalidate_layout() restores agreement with the looped path."""
    _, net, rng = make_nets(10, [4, 4], [0.0, 0.5], 3.0, "l2")
    net = sharded(net, 3)
    qt = torch.as_tensor(_q(rng, 8, scale=1.0))
    before = net.lookup(qt)
    net.levels[0] = CacheLevel(
        keys=torch.as_tensor(_q(rng, 5, scale=1.0)),
        values=torch.arange(100, 105, dtype=torch.int32), h=0.0)
    stale = net.lookup(qt)
    assert_port_results_equal(stale, before)
    assert not torch.equal(stale.payload, net._lookup_looped(qt).payload)
    net.invalidate_layout()
    assert_port_results_equal(net.lookup(qt), net._lookup_looped(qt))


def test_invalidate_layout_clears_sharded_memo():
    _, net, rng = make_nets(11, [6, 3], [0.0, 0.4], 2.0, "l2")
    net = sharded(net, 4)
    qt = torch.as_tensor(_q(rng, 4, scale=1.0))
    net.lookup(qt)
    net.lookup(qt, quantize=True)
    net.lookup(qt, prune="lsh")
    assert set(net._sharded_layout) == {4}
    assert {k[1] for k in net._tables} == {4}
    mp = net.sharded_layout(4)[2]
    ms = net.sharded_meta(4)              # regrouped once, then sliced
    assert ms is net.sharded_meta(4) and ms.is_contiguous()
    assert ms.shape == (4, 4, mp.shape[1] // 4)
    assert torch.equal(ms, shard_meta(mp, 4))
    assert all(torch.equal(ms[s], mp[:, s * 3:(s + 1) * 3])
               for s in range(4))
    net.invalidate_layout()
    assert not net._sharded_layout and net._layout is None
    assert not net._tables


def _tie_net(**kw):
    """Two 8-key levels with equal h and an identical key at slot 5 of
    both: concatenated indices 5 and 13 lie in different shards of a 2,
    3 or 8-way split, so the reduction must take the lower shard."""
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
                          candidate_policy=COVER_ALL, **kw)
    return net, torch.as_tensor(np.broadcast_to(dup, (3, 6)).copy())


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_sharded_tie_break_to_lower_shard(n_shards):
    net, q = _tie_net()
    snet = sharded(net, n_shards)
    ref = net._lookup_fused(q)
    for kw in ({}, dict(prune="lsh"), dict(prune="lsh", verify=True),
               dict(quantize=True, verify=True, top_t=2)):
        res = snet.lookup(q, **kw)
        assert_port_results_equal(res, ref)
        assert bool((res.level == 0).all()) and bool((res.slot == 5).all())
    # the per-shard pruned oracle with the shards' own full-coverage tables
    kp, hp, mp = pad_to_shards(*net.fused_layout(), n_shards)
    S = kp.shape[0] // n_shards
    ts = [COVER_ALL.for_shard(s).build(kp[s * S:(s + 1) * S].numpy(),
                                       mp[3, s * S:(s + 1) * S].numpy() > 0)
          for s in range(n_shards)]
    out = sharded_pruned_fused_lookup_ref(q, kp, hp, mp, ts, cap_union=S,
                                          h_repo=9.0)
    assert_port_results_equal(_port_result(out), ref)


def test_sharded_signatures_bump_once():
    """Each sharded entry counts one specialization per new signature,
    as the reference's jit traces once per shape."""
    _, net, rng = make_nets(12, [7, 6], [0.0, 0.5], 2.0)
    net = sharded(net, 3)
    q = torch.as_tensor(_q(rng, 13))
    with tracecount.snapshot() as s:
        for _ in range(3):
            net.lookup(q)
            net.lookup(q, quantize=True, top_t=3)
            net.lookup(q, prune="kmeans")
        assert s.delta("sharded_fused_lookup") == 1
        assert s.delta("sharded_quantized_fused_lookup") == 1
        assert s.delta("sharded_pruned_fused_lookup") == 1
        net.lookup(q[:11])
        assert s.delta("sharded_fused_lookup") == 2


# ====================================================== quantized lookup
QCONFIGS = [
    (0, [5, 9, 3], [0.0, 0.5, 1.0], 2.0, 23),
    (1, [17, 2, 31, 8], [0.0, 0.2, 0.7, 1.3], 3.0, 1),
    (5, [200, 150, 250], [0.0, 0.4, 0.8], 2.5, 300),
]


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_quantized_verify_bit_identical_sharded(n_shards):
    """Verified quantized lookups through the sharded plane (per-shard
    int8 rows, per-query min of the shards' vT) are the exact lookup."""
    for seed, sizes, hs, h_repo, nq in QCONFIGS:
        _, net, rng = make_nets(seed, sizes, hs, h_repo)
        snet = sharded(net, n_shards)
        qt = torch.as_tensor(_q(rng, nq))
        res = snet.lookup(qt, quantize=True, verify=True, top_t=4)
        assert_port_results_equal(res, net._lookup_fused(qt))
        assert_port_results_equal(res, snet.lookup(qt))
        raw = snet.lookup(qt, quantize=True, top_t=4)
        assert bool((raw.cost >= net._lookup_fused(qt).cost).all())


@pytest.mark.parametrize("n_shards", [3])
def test_quantized_sharded_matches_oracles(n_shards):
    """The sharded entry against the port's and the reference's chunked
    oracles: winners equal, costs within the lookup tolerance, the vT
    bound within 4e-6·|vT| + 1e-6 of the reference's; and the chunked
    result admissible between the exact cost and the one-way oracle's."""
    jnet, net, rng = make_nets(8, [60, 45, 30], [0.0, 0.3, 0.9], 2.5)
    q = _q(rng, 17, scale=1.0)
    qt = torch.as_tensor(q)
    snet = sharded(net, n_shards)
    kp, hp, mp = snet.sharded_layout(n_shards)
    out = sharded_quantized_fused_lookup(
        qt, kp, hp, mp, snet._quant_rows(n_shards), snet.mesh, ("data",),
        top_t=6, h_repo=2.5)
    keys, h_key, meta = net.fused_layout()
    mine = sharded_quantized_fused_lookup_ref(qt, keys, h_key, meta,
                                              n_shards, top_t=6, h_repo=2.5)
    for i in (2, 3, 4):
        assert torch.equal(out[i], mine[i])
    for i in (0, 1, 5):
        np.testing.assert_allclose(out[i].numpy(), mine[i].numpy(),
                                   rtol=1e-6, atol=1e-6)
    jk, jh, jm = jnet.fused_layout()
    jout = jsharded_quant_ref(jnp.asarray(q), jk, jh, jm, n_shards,
                              top_t=6, h_repo=2.5)
    b, jb = out[5].double().numpy(), np.asarray(jout[5], np.float64)
    assert np.all(np.abs(b - jb) <= 4e-6 * np.abs(jb) + 1e-6)
    assert_matches_reference(_as_result(jout), _port_result(out), q,
                             keys.numpy(), "l2", 1.0)
    exact = net._lookup_fused(qt).cost.numpy()
    assert np.all(out[0].numpy() >= exact)


def test_quant_rows_memo_per_shard_count():
    _, net, rng = make_nets(13, [50, 80], [0.2, 0.8], 3.0)
    net = sharded(net, 3)
    qt = torch.as_tensor(_q(rng, 8))
    net.lookup(qt, quantize=True)
    net.lookup(qt, quantize=True)
    assert [k for k in net._tables] == [("quant_rows", 3)]
    rows = net._quant_rows(3)
    assert rows.q.shape[0] == net.sharded_layout(3)[0].shape[0] == 132
    assert float(rows.scale[-1]) == 0.0           # a padding row


# ========================================================= pruned lookup
@pytest.mark.parametrize("prune", ["lsh", "kmeans"])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_pruned_verify_bit_identical_sharded(prune, n_shards):
    for seed, sizes, hs, h_repo, nq in QCONFIGS:
        _, net, rng = make_nets(seed, sizes, hs, h_repo)
        snet = sharded(net, n_shards)
        qt = torch.as_tensor(_q(rng, nq))
        res = snet.lookup(qt, prune=prune, verify=True)
        assert_port_results_equal(res, net._lookup_fused(qt))
        assert_port_results_equal(res, snet.lookup(qt))
        res = snet.lookup(qt, prune=prune, quantize=True, verify=True,
                          top_t=8)
        assert_port_results_equal(res, net._lookup_fused(qt))


def test_pruned_sharded_verify_rescans_through_the_sharded_path(
        monkeypatch):
    """Narrow per-shard tables miss winners; the verifier re-scans those
    queries through the sharded exact path, never the fused one."""
    import repro_torch.core.simcache as simcache_mod
    _, net, rng = make_nets(15, [300, 200], [0.0, 0.2], 9.0)
    net.candidate_policy = SimHashPolicy(n_tables=1, n_bits=6, n_probes=1)
    snet = sharded(net, 4)
    qt = torch.as_tensor(_q(rng, 64))
    exact = net._lookup_fused(qt)
    assert bool((snet.lookup(qt, prune="lsh").cost > exact.cost).any())
    calls = []

    def count(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped
    for name in ("sharded_fused_lookup", "fused_lookup"):
        monkeypatch.setattr(simcache_mod, name,
                            count(name, getattr(simcache_mod, name)))
    res = snet.lookup(qt, prune="lsh", verify=True)
    assert_port_results_equal(res, exact)
    assert calls == ["sharded_fused_lookup"]
    assert snet.rescan_calls == 1 and snet.rescan_queries > 0


@pytest.mark.parametrize("kind", ["lsh", "kmeans"])
def test_pruned_sharded_matches_reference_oracle(kind):
    """Per-shard tables built from ``for_shard(s)`` on each chunk, the
    same in both packages; the port's sharded entry against the
    reference's mesh-free oracle: the scalar bound bit for bit, the same
    winners, costs within the lookup tolerance; and against the port's
    own oracle bitwise in everything but the costs (1e-6)."""
    n = 3
    jnet, net, rng = make_nets(8, [150, 90, 120], [0.0, 0.3, 0.7], 2.5)
    pol = (SimHashPolicy(n_tables=3, n_bits=4, n_probes=2) if kind == "lsh"
           else KMeansPolicy(n_clusters=5, n_probes=2))
    jpol = getattr(jlsh, type(pol).__name__)(
        **{f.name: getattr(pol, f.name) for f in dataclasses.fields(pol)})
    net.candidate_policy = pol
    snet = sharded(net, n)
    q = _q(rng, 33)
    qt = torch.as_tensor(q)
    kp, hp, mp = snet.sharded_layout(n)
    S = kp.shape[0] // n
    proj, buckets, n_probes = snet._tables_for(pol, n)
    ts = [pol.for_shard(s).build(kp[s * S:(s + 1) * S].numpy(),
                                 mp[3, s * S:(s + 1) * S].numpy() > 0)
          for s in range(n)]
    jts = [jpol.for_shard(s).build(kp[s * S:(s + 1) * S].numpy(),
                                   mp[3, s * S:(s + 1) * S].numpy() > 0)
           for s in range(n)]
    for s in range(n):
        np.testing.assert_array_equal(ts[s].buckets, jts[s].buckets)
        np.testing.assert_array_equal(proj[s].numpy(), ts[s].proj)
        assert not _excluded(ts[s], q).any()
    cap = pol.resolve_cap(S) // 2
    out = sharded_pruned_fused_lookup(
        qt, kp, hp, mp, proj, buckets, snet.mesh, ("data",), kind=kind,
        n_probes=n_probes, cap_union=cap, h_repo=2.5)
    mine = sharded_pruned_fused_lookup_ref(qt, kp, hp, mp, ts, cap,
                                           h_repo=2.5)
    for i in (2, 3, 4, 5):
        assert torch.equal(out[i], mine[i])
    np.testing.assert_allclose(out[0].numpy(), mine[0].numpy(), rtol=1e-6,
                               atol=1e-6)
    jout = jsharded_pruned_ref(jnp.asarray(q), jnp.asarray(kp.numpy()),
                               jnp.asarray(hp.numpy()),
                               jnp.asarray(mp.numpy()), jts, cap,
                               h_repo=2.5)
    assert float(out[5]) == float(jout[5])
    for i in (2, 3, 4):
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(jout[i]))
    tol = cost_tol(q, kp.numpy(), np.asarray(jout[1]), "l2", 1.0)
    assert np.all(np.abs(out[0].numpy() - np.asarray(jout[0])) <= tol)


def test_tables_memo_per_shard_count():
    """``_tables_for(policy, n)`` builds shard s's tables from
    ``policy.for_shard(s)`` over its chunk, stacked with −1 bucket
    padding, memoized per (policy, n)."""
    _, net, rng = make_nets(14, [40, 33], [0.0, 0.4], 2.0)
    net = sharded(net, 3)
    pol = SimHashPolicy(n_tables=2, n_bits=3, n_probes=2)
    proj, buckets, n_probes = net._tables_for(pol, 3)
    assert net._tables_for(pol, 3)[0] is proj
    kp, _, mp = net.sharded_layout(3)
    S = kp.shape[0] // 3
    for s in range(3):
        t = pol.for_shard(s).build(kp[s * S:(s + 1) * S].numpy(),
                                   mp[3, s * S:(s + 1) * S].numpy() > 0)
        w = t.buckets.shape[-1]
        np.testing.assert_array_equal(buckets[s, ..., :w].numpy(), t.buckets)
        assert bool((buckets[s, ..., w:] == -1).all())
        np.testing.assert_array_equal(proj[s].numpy(), t.proj)
    assert n_probes == pol.resolve_probes(pol.resolve_bits(S))
    assert set(net._tables) == {(pol, 3)}


# ============================================================ gains
def _gain_inputs(seed=5, R=117, O=700, D=5, I=2, J=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, D)).astype(np.float32)
    y = rng.standard_normal((O, D)).astype(np.float32)
    lam = rng.random((I, R)).astype(np.float32)
    cur = (rng.random((I, R)) * 4).astype(np.float32)
    h = rng.random((I, J)).astype(np.float32)
    h[1, 0] = np.inf                                   # off-path entry
    return x, y, lam, cur, h


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_sharded_gains_bitwise(n_shards, quantize):
    """Every column of the sharded oracle is the unsharded one's, bit for
    bit (O = 700: a ragged last tile, and past 3 shards whole shards of
    padding that run nothing); and within 5e-5 of the reference's
    candidate-sharded oracle on a 1-device mesh."""
    args = _gain_inputs()
    t = [torch.as_tensor(a) for a in args]
    want = placement_gains(*t, quantize=quantize)
    got = sharded_placement_gains(*t, make_lookup_mesh(n_shards), ("data",),
                                  quantize=quantize)
    assert got.shape == want.shape == (700, 3)
    assert torch.equal(got, want)
    if not quantize:
        jmesh = jax.make_mesh((1,), ("data",))
        ref = np.asarray(jsharded_gains(*(jnp.asarray(a) for a in args),
                                        jmesh, ("data",), use_pallas=False))
        np.testing.assert_allclose(got.numpy(), ref, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_gains_on_tree_instance(n_shards):
    """A sharded streaming ``DeviceInstance``'s oracle on the reference's
    tree instance: bitwise the unsharded instance's, and within the F3
    tolerance of the reference's streamed oracle."""
    jinst, inst = tree_instance(JAX), tree_instance(PORT)
    d = DeviceInstance.from_instance(inst, materialize_ca=False,
                                     device="cpu")
    ds = DeviceInstance.from_instance(inst, mesh=make_lookup_mesh(n_shards),
                                      axes=("data",), materialize_ca=False,
                                      device="cpu")
    assert ds.n_shards == n_shards and d.n_shards == 1
    cur = d.initial_costs()
    g = ds.gains(cur)
    assert torch.equal(g, d.gains(cur))
    jd = JDevInst.from_instance(jinst, materialize_ca=False)
    gj = np.asarray(jd.gains(jnp.asarray(cur.numpy())))
    np.testing.assert_allclose(g.numpy(), gj, rtol=2.5e-4, atol=5e-3)


def _zipf_instance(pkg, n=170, k=(6, 9), seed=4):
    cat_m, dem_m, top_m, inst_cls = pkg
    cat = cat_m.embedding_catalog(n=n, dim=6, seed=seed)
    net = top_m.tandem(k_leaf=k[0], k_parent=k[1], h=50.0, h_repo=400.0)
    return inst_cls(net=net, cat=cat,
                    dem=dem_m.zipf(cat, alpha=0.8, seed=seed + 1))


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_device_greedy_sharded_bit_identical(n_shards):
    """GREEDY seeded by the candidate-sharded oracle picks the unsharded
    allocation, the host's and the reference's host GREEDY's."""
    inst = _zipf_instance(PORT)
    d = DeviceInstance.from_instance(inst, materialize_ca=False,
                                     device="cpu")
    ds = DeviceInstance.from_instance(inst, mesh=make_lookup_mesh(n_shards),
                                      axes=("data",), materialize_ca=False,
                                      device="cpu")
    got = device_greedy(ds)
    np.testing.assert_array_equal(got, device_greedy(d))
    np.testing.assert_array_equal(got, greedy(inst))
    np.testing.assert_array_equal(got, jgreedy(_zipf_instance(JAX)))
    np.testing.assert_array_equal(device_greedy(ds, quantize=True),
                                  device_greedy(d, quantize=True))


# ==================================================== best-two tables
@pytest.mark.parametrize("materialize", [True, False])
@pytest.mark.parametrize("n_shards", [2, 3, 5, 200])
def test_best_two_tables_sharded_bitwise(n_shards, materialize):
    """Request-axis shards (150 objects: 5 and 200 do not divide it, 200
    leaves shards of padding) give the unsharded tables bit for bit,
    folded serving tables and C(A) included."""
    inst = tree_instance(PORT)
    kw = dict(materialize_ca=materialize, device="cpu")
    d = DeviceInstance.from_instance(inst, **kw)
    ds = DeviceInstance.from_instance(inst, mesh=make_lookup_mesh(n_shards),
                                      axes=("data",), **kw)
    slots = np.random.default_rng(n_shards).integers(
        -1, inst.cat.n, inst.net.total_slots)
    for a, b in zip(ds.best_two_tables(slots), d.best_two_tables(slots)):
        assert torch.equal(a, b)
    for a, b in zip(ds.best_two(slots), d.best_two(slots)):
        assert torch.equal(a, b)
    assert ds.total_cost(slots) == d.total_cost(slots)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_best_two_matches_reference(n_shards):
    """``sharded_best_two`` (the serving tables, repository folded) on
    the reference's C_a matrix: bitwise the reference's unsharded
    ``DeviceInstance.best_two`` and the port's, at a layout with empty
    slots."""
    ca = np.asarray(tree_instance(JAX).ca)
    inst, jinst = tree_instance(PORT, ca=ca), tree_instance(JAX, ca=ca)
    d = DeviceInstance.from_instance(inst, device="cpu")
    slots = np.random.default_rng(3).integers(-1, inst.cat.n,
                                              inst.net.total_slots)
    got = sharded_best_two(d.coords, d.ca, torch.as_tensor(slots),
                           d.slot_cache, d.H, d.h_repo,
                           make_lookup_mesh(n_shards), ("data",), d.metric,
                           d.gamma, True)
    for a, b in zip(got, d.best_two(slots)):
        assert torch.equal(a, b)
    ref = JDevInst.from_instance(jinst).best_two(jnp.asarray(slots))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("cap", [1, None], ids=["rebuild", "dirty_rows"])
def test_best_two_delta_sharded(cap):
    """The incremental refresh on a sharded instance — its full rebuild
    (more dirty rows than ``cap``) sharded, its dirty-row recompute not —
    gives the tables of a fresh build on the new layout."""
    inst = tree_instance(PORT)
    ds = DeviceInstance.from_instance(inst, mesh=make_lookup_mesh(4),
                                      axes=("data",), materialize_ca=False,
                                      device="cpu")
    rng = np.random.default_rng(7)
    K = inst.net.total_slots
    slots = rng.integers(0, inst.cat.n, K)
    pre = ds.best_two_tables(slots)
    ys = np.array([1, 4, K], np.int64)                 # K: an unused lane
    new = slots.copy()
    new[ys[:2]] = rng.integers(0, inst.cat.n, 2)
    got = ds.best_two_delta(*pre, new, ys, cap=cap)
    for a, b in zip(got, ds.best_two_tables(new)):
        assert torch.equal(a, b)


# ========================================================= online plane
@pytest.mark.parametrize("n_shards", [2, 4])
def test_device_netduel_sharded_mesh(n_shards):
    """A ``DeviceInstance`` with mesh axes re-arms the duel through the
    sharded tables: bitwise the host policy and the unsharded device
    scan, and the reference's device scan on one shared C_a."""
    ca = np.asarray(tree_instance(JAX).ca)
    inst, jinst = tree_instance(PORT, ca=ca), tree_instance(JAX, ca=ca)
    d = DeviceInstance.from_instance(inst, device="cpu")
    ds = DeviceInstance.from_instance(inst, mesh=make_lookup_mesh(n_shards),
                                      axes=("data",), device="cpu")
    got = device_netduel(ds, record_events=True, **KW)
    assert got.n_promotions > 0
    assert_duel_equal(netduel(inst, **KW), got)
    assert_device_equal(got, device_netduel(d, record_events=True, **KW))
    ref = jdevice_netduel(JDevInst.from_instance(jinst), record_events=True,
                          **KW)
    assert_duel_matches_reference(got, ref, bitwise=True, host=False)


def test_settle_past_promote_cap_sharded():
    """More promotions in one step than the incremental re-arm takes:
    the sharded full rebuild gives the unsharded run's carry bitwise."""
    import importlib
    nd = importlib.import_module("repro_torch.core.placement.netduel")
    inst, slots0, xs, w = _crowded_settle()
    runs = []
    for mesh in (None, make_lookup_mesh(3)):
        d = DeviceInstance.from_instance(inst, mesh=mesh,
                                         axes=("data",) if mesh else (),
                                         materialize_ca=False, device="cpu")
        h_slots, on_path = nd._scan_args(d)
        runs.append(nd._duel_scan(
            d, h_slots, on_path, nd._duel_carry(d, slots0), xs,
            float(np.float32(1.05)), w, True, False, 0))
    (c0, o0), (c1, o1) = runs
    assert int(c1.n_prom.sum()) > nd.PROMOTE_CAP
    for a, b in zip(c0, c1):
        assert torch.equal(a, b)
    assert torch.equal(o0.b1, o1.b1)


def test_device_localswap_sharded():
    inst = _zipf_instance(PORT, n=160, seed=6)
    kw = dict(materialize_ca=False, device="cpu")
    d = DeviceInstance.from_instance(inst, **kw)
    ds = DeviceInstance.from_instance(inst, mesh=make_debug_mesh(2, 2),
                                      axes=("model", "data"), **kw)
    assert ds.n_shards == 4
    a = device_localswap(d, n_iters=600, tol=1e-3)
    b = device_localswap(ds, n_iters=600, tol=1e-3)
    np.testing.assert_array_equal(a.slots_np, b.slots_np)


# ================================================================ engine
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=256)
ECFG = dict(k_device=16, k_pod=24, k_global=32, h_ici=1.0, h_dcn=10.0,
            h_model=100.0, metric="l2")


def make_engine(n_shards=None, params=None, **kw):
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), **SMALL)
    if params is None:
        params = model_api.init_params(cfg, 0, device="cpu")
    cat = catalog.embedding_catalog(n=400, dim=16, seed=1)
    mesh = None if n_shards is None else make_lookup_mesh(n_shards)
    eng = SimCacheEngine(cfg, params, EngineConfig(**ECFG, **kw),
                         cat.coords, device="cpu", mesh=mesh)
    return eng, cfg, cat


def trace(n_batches, batch=16, seed=0):
    cat = catalog.embedding_catalog(n=400, dim=16, seed=1)
    dem = demand.zipf(cat, alpha=1.1, seed=3)
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


def _stats(s):
    return (s.n_requests, s.n_hits, s.model_calls, s.total_cost,
            s.total_approx_cost)


def _cold_refresh_warm(eng):
    c, oc = run(eng, trace(3))
    eng.refresh_placement()
    w, ow = run(eng, trace(6, seed=1))
    return _stats(c), oc, eng.placement.slots.copy(), _stats(w), ow


@pytest.fixture(scope="module")
def unsharded_run():
    return _cold_refresh_warm(make_engine()[0])


@pytest.mark.parametrize("n_shards,flags", [
    (1, {}), (3, {}), (4, dict(prune="lsh", quantize=True, verify=True))],
    ids=["one", "three", "four_lsh_quantize"])
def test_engine_sharded_serves_as_unsharded(n_shards, flags, unsharded_run):
    """``EngineConfig.sharded`` with a mesh: the sharded lookup on every
    batch and a sharded synchronous solve serve the unsharded engine's
    cold and warm traces — slots, hits, responses and costs — bit for
    bit."""
    eng = make_engine(n_shards, sharded=True, **flags)[0]
    assert eng.lookup_shards.axes == ("data",)
    got = _cold_refresh_warm(eng)
    assert eng.simcache.sharded and eng.simcache.mesh is eng.mesh
    assert eng.simcache.n_shards() == n_shards
    np.testing.assert_array_equal(got[2], unsharded_run[2])
    assert got[:2] == unsharded_run[:2] and got[3:] == unsharded_run[3:]


def test_engine_sharded_requires_mesh():
    with pytest.raises(ValueError, match="requires a mesh"):
        make_engine(None, sharded=True)


def test_engine_sharded_matches_reference_engine():
    """A 3-shard engine against the reference's unsharded engine on the
    same weights: the same slots, warm hits, responses and model calls,
    and costs within tests/test_torch_engine.py's 0.1 per hit plus
    1e-5 relative."""
    jcfg = dataclasses.replace(jget_smoke("granite-3-2b"), **SMALL)
    jparams = jmodel.init_params(jcfg, 0)
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), **SMALL)
    model = convert.from_jax_params(cfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    coords = jcat.embedding_catalog(n=400, dim=16, seed=1).coords
    jeng = JEngine(jcfg, jparams, JConfig(**ECFG), coords)
    eng = SimCacheEngine(cfg, model, EngineConfig(**ECFG, sharded=True),
                         coords, device="cpu", mesh=make_lookup_mesh(3))
    out = []
    for e, conv in ((jeng, jnp.asarray), (eng, np.asarray)):
        run(e, trace(2), conv)
        e.refresh_placement()
        out.append((e.placement.slots.copy(), *run(e, trace(4, seed=1),
                                                   conv)))
    (jslots, jw, jow), (slots, w, ow) = out
    np.testing.assert_array_equal(slots, jslots)
    assert (w.n_hits, w.model_calls) == (jw.n_hits, jw.model_calls)
    assert ow == jow
    assert abs(w.total_cost - jw.total_cost) <= \
        0.1 * w.n_hits + 1e-5 * abs(jw.total_cost)


def test_engine_background_refresh_solves_unsharded(monkeypatch):
    """The synchronous solve and the duel plane shard the control plane;
    the background refresh solves unsharded, as the reference's does —
    and installs the same allocation the sharded solve gives."""
    import repro_torch.serve.engine as engine_mod
    seen = []
    orig = DeviceInstance.from_instance

    def record(inst, mesh=None, axes=(), **kw):
        seen.append(None if mesh is None else (mesh.size, tuple(axes)))
        return orig(inst, mesh=mesh, axes=axes, **kw)
    monkeypatch.setattr(engine_mod.DeviceInstance, "from_instance", record)
    eng = make_engine(4, sharded=True, netduel=True)[0]
    run(eng, trace(3))
    eng.refresh_placement()
    assert seen == [(4, ("data",)), (4, ("data",))]      # solve, duel arm
    sync_slots = eng.placement.slots.copy()
    assert eng.request_refresh()
    assert eng.wait_refresh(timeout=120) and eng.poll_refresh()
    assert seen[2] is None                              # background solve
    assert seen[3] == (4, ("data",))                    # the re-armed duel
    np.testing.assert_array_equal(eng.placement.slots, sync_slots)


def test_engine_sharded_netduel_serves_as_unsharded():
    """The online plane on a sharded engine (the duel's table rebuilds
    request-axis sharded): the same served stats and promotions."""
    out = []
    for n in (None, 3):
        kw = dict(sharded=True) if n else {}
        eng = make_engine(n, netduel=True, duel_window=64,
                          duel_arm_prob=0.5, **kw)[0]
        got = _cold_refresh_warm(eng)
        out.append((got, eng.placement_events, eng.duel.slots_np.copy()))
    (a, pa, sa), (b, pb, sb) = out
    assert a[:2] == b[:2] and a[3:] == b[3:] and pa == pb
    np.testing.assert_array_equal(a[2], b[2])
    np.testing.assert_array_equal(sa, sb)


def _accounting(eng):
    s = eng.stats
    return (s.n_hits, s.n_requests, s.model_calls, s.total_cost,
            s.total_approx_cost)


def _mixed_batches(cat, cfg, sizes, seed=0):
    rng = np.random.default_rng(seed)
    dem = demand.zipf(cat, alpha=1.1, seed=3)
    out = []
    for k in sizes:
        ids, _ = dem.sample(k, rng)
        out.append((ids, torch.as_tensor(
            rng.integers(0, cfg.vocab, (k, 8)).astype(np.int32))))
    return out


@pytest.mark.parametrize("ecfg_kw", [
    {}, dict(warm_start=True, warm_polish_iters=128)],
    ids=["greedy", "warm_start"])
def test_atomic_swap_differential_sharded(ecfg_kw):
    """tests/test_streaming.py's swap differential on a 3-shard engine: a
    mid-stream background refresh swapped in (run A) serves exactly what
    a synchronous sharded solve installed at the same batch boundary
    (run B) and an explicit install of A's post-swap placement (run C)
    serve; the background solve equals the synchronous one."""
    sizes = [16, 9, 16, 23, 16, 11, 16, 16, 7, 16]
    swap_after = 5
    kw = dict(sharded=True, algo="greedy", **ecfg_kw)
    eng_a, cfg, cat = make_engine(3, **kw)
    params = eng_a.params
    batches = _mixed_batches(cat, cfg, [16] * 4 + sizes)
    for ids, prompts in batches[:4]:
        eng_a.serve(ids, prompts)
    eng_a.refresh_placement()
    v0 = eng_a.placement.version
    traj_a = []
    for b, (ids, prompts) in enumerate(batches[4:]):
        if b == swap_after - 1:
            assert eng_a.request_refresh() and eng_a.refresh_in_flight
            assert not eng_a.request_refresh()
        eng_a.serve(ids, prompts)
        if b == swap_after - 1:
            assert eng_a.wait_refresh(timeout=120)
            assert eng_a.poll_refresh() and not eng_a.refresh_in_flight
        else:
            assert not eng_a.poll_refresh()
        traj_a.append(_accounting(eng_a))
    assert eng_a.placement.version > v0
    slots_post = np.asarray(eng_a.placement.slots).copy()

    eng_b, _, _ = make_engine(3, params=params, **kw)
    for ids, prompts in batches[:4]:
        eng_b.serve(ids, prompts)
    eng_b.refresh_placement()
    traj_b, pending = [], None
    for b, (ids, prompts) in enumerate(batches[4:]):
        if b == swap_after - 1:
            inst = eng_b.observed_instance()
            pending = eng_b._solve(inst, eng_b.ecfg.algo,
                                   eng_b.ecfg.device_placement)[0], inst
        eng_b.serve(ids, prompts)
        if b == swap_after - 1:
            slots_b, inst = pending
            np.testing.assert_array_equal(slots_b, slots_post)
            eng_b._install(slots_b, inst)
        traj_b.append(_accounting(eng_b))
    assert traj_a == traj_b

    eng_c, _, _ = make_engine(3, params=params, **kw)
    for ids, prompts in batches[:4]:
        eng_c.serve(ids, prompts)
    eng_c.refresh_placement()
    for b, (ids, prompts) in enumerate(batches[4:]):
        eng_c.serve(ids, prompts)
        if b == swap_after - 1:
            eng_c._install(slots_post, eng_c.observed_instance())
    assert _accounting(eng_c) == traj_a[-1]
