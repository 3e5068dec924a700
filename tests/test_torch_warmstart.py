"""The port's §4 warm-start pipeline (core/placement/warmstart.py)
against the JAX reference, on the CPU, and the reference's own
invariants on the port. Mirrors tests/test_warmstart.py.

The instances are the reference suite's: grid catalogs (side √O) with
Gaussian demand on a 3-cache chain, a leaf-fed tandem and an equi-depth
tree, plus the §4.4 tandem with arrivals at both nodes; each is built
once by each package from the same seeds (byte-equal demand).

What must match:
* ``classify_topology``: equal reductions, field for field;
* ``solve_continuous`` for chains and trees, and ``map_solution``: NumPy
  copies, bitwise (``slots_warm``, ``bounds``, ``order``, the cost); the
  tandem's f32 descent: ``w1`` within its last step and the cost within
  1e-5 relative (tests/test_torch_continuous.py says why);
* the polished allocation and its swap count, for the host polish
  (NumPy, bitwise) and the device polish, except at the named f32
  near-ties of NEAR_TIES. There the grid's symmetry gives two slots the
  same ΔC in exact arithmetic (the f64 host deltas are equal), the two
  frameworks' f32 sums round it differently (both within 1e-5 of the
  f64 value), and each picks its own lowest; the test walks both device
  windows in lockstep and shows that the first differing decision is
  that one.
"""
from __future__ import annotations

import functools
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import catalog as jcatalog
from repro.core import demand as jdemand
from repro.core import topology as jtopology
from repro.core.objective import DeviceInstance as JDeviceInstance
from repro.core.objective import Instance as JInstance
from repro.core.placement import device as jdevice
from repro.core.placement import warmstart as jws
from repro_torch.core import catalog as catalog_api
from repro_torch.core import demand as demand_api
from repro_torch.core import topology as topology_api
from repro_torch.core.objective import DeviceInstance, Instance, random_slots
from repro_torch.core.placement import warmstart as ws
from repro_torch.core.placement.device import (DeviceSwapState, _accepts,
                                               _swap_argmin, device_greedy,
                                               device_localswap)
from repro_torch.core.placement.localswap import (SwapState,
                                                  emulated_stream,
                                                  swap_deltas)

PORT = types.SimpleNamespace(catalog=catalog_api, demand=demand_api,
                             topology=topology_api, Instance=Instance)
JAX = types.SimpleNamespace(catalog=jcatalog, demand=jdemand,
                            topology=jtopology, Instance=JInstance)

GAP_BOUND = {"chain": 0.06, "tandem": 0.06, "tree": 0.06}
POLISH = {1024: 128}
TOPOS = ["chain", "tandem", "tree", "tandem_both"]

# (topology, device polish) → (step, the reference's slot, the port's
# slot): the first polish decision where the frameworks differ, an f32
# near-tie between two slots of equal f64 ΔC
NEAR_TIES = {("tandem", True): (6, 33, 32),
             ("tandem_both", True): (59, 21, 18)}


def make_instance(api, topo: str, O: int, k: int = 64):
    """The reference suite's instances (grid catalog, Gaussian demand),
    and the §4.4 tandem with arrivals at both nodes."""
    L = math.isqrt(O)
    assert L * L == O
    cat = api.catalog.grid(L=L)
    if topo == "tandem":
        net = api.topology.tandem(k_leaf=k, k_parent=k, h=2.0, h_repo=100.0)
        dem = api.demand.gaussian_grid(cat, sigma=L / 4)
    elif topo == "chain":
        net = api.topology.chain(3, [k, k, k], [0.0, 2.0, 6.0], 100.0)
        dem = api.demand.gaussian_grid(cat, sigma=L / 4)
    elif topo == "tandem_both":
        net = api.topology.tandem_both(k, k, 2.0, 100.0)
        dem = api.demand.gaussian_grid(cat, sigma=L / 4, n_ingress=2)
    else:
        net = api.topology.equi_depth_tree(branching=2, depth=1,
                                           k_per_level=[k, k],
                                           h_per_level=[0.0, 3.0],
                                           h_repo=100.0)
        dem = api.demand.gaussian_grid(cat, sigma=L / 4, n_ingress=2)
    return api.Instance(net=net, cat=cat, dem=dem)


@functools.lru_cache(maxsize=None)
def pair(topo: str, O: int = 1024):
    inst, jinst = make_instance(PORT, topo, O), make_instance(JAX, topo, O)
    np.testing.assert_array_equal(inst.lam, jinst.lam)
    return inst, jinst


def _fields(red):
    return None if red is None else (type(red).__name__, _plain(red))


def _plain(x):
    if hasattr(x, "__dataclass_fields__"):
        return {f: _plain(getattr(x, f)) for f in x.__dataclass_fields__}
    return x


# ====================================================================
# 1 · against the reference
# ====================================================================
def _nets(api):
    t = api.topology
    inf = np.inf
    irregular = [([[0.0, 1.0, inf], [0.0, inf, 5.0]], [8, 8, 8]),
                 ([[0.0, inf, 2.0], [inf, 0.0, 2.0]], [8, 16, 8]),
                 ([[0.0, inf, 2.0]], [4, 6, 8])]
    nets = {"single_cache": t.single_cache(32, 50.0),
            "tandem": t.tandem(8, 16, 2.0, 50.0),
            "chain": t.chain(4, 8, 1.0, 50.0),
            "tpu_hierarchy": t.tpu_hierarchy(8, 12, 16, 0.5, 2.0, 30.0),
            "tandem_both": t.tandem_both(8, 16, 2.0, 50.0),
            "equi_depth_tree": t.equi_depth_tree(
                branching=3, depth=2, k_per_level=[4, 8, 16],
                h_per_level=[0.0, 1.0, 3.0], h_repo=50.0)}
    for n, (H, caps) in enumerate(irregular):
        H = np.array(H, np.float32)
        nets[f"irregular{n}"] = t.CacheNetwork(
            n_caches=3, capacities=np.array(caps),
            ingress=np.arange(H.shape[0]), H=H,
            h_repo=np.full(H.shape[0], 50.0, np.float32))
    return nets


@pytest.mark.parametrize("name", sorted(_nets(PORT)))
def test_classify_matches_reference(name):
    for gamma in (1.0, 0.5):
        red = ws.classify_topology(_nets(PORT)[name], gamma=gamma)
        jred = jws.classify_topology(_nets(JAX)[name], gamma=gamma)
        assert _fields(red) == _fields(jred)


@pytest.mark.parametrize("topo", TOPOS)
def test_solve_and_map_match_reference(topo):
    """``solve_continuous`` and ``map_solution``: the map of the
    reference's own solution is bitwise the reference's map; the port's
    solve is bitwise for chains and trees, within tolerance for the
    tandem's descent."""
    inst, jinst = pair(topo)
    red = ws.classify_topology(inst.net)
    jred = jws.classify_topology(jinst.net)
    jsol = jws.solve_continuous(jinst, jred)
    sol = ws.solve_continuous(inst, red, device="cpu")
    np.testing.assert_array_equal(sol.order, jsol.order)
    if topo == "tandem_both":
        last_step = 0.05 / np.sqrt(1.0 + 2999 / 100.0)
        np.testing.assert_allclose(sol.w1, jsol.w1, rtol=0, atol=last_step)
        assert sol.cost == pytest.approx(jsol.cost, rel=1e-5)
        assert sol.beta == jsol.beta
    else:
        np.testing.assert_array_equal(sol.splits, jsol.splits)
        assert sol.cost == jsol.cost
    same = ws.ContinuousSolution(**_plain(jsol))
    slots, bounds = ws.map_solution(inst, red, same)
    jslots, jbounds = jws.map_solution(jinst, jred, jsol)
    np.testing.assert_array_equal(slots, jslots)
    if jbounds is None:
        assert bounds is None
    else:
        np.testing.assert_array_equal(bounds, jbounds)


def _first_divergence(inst, jinst, slots0, n_iters: int, tol: float):
    """Walk the port's and the reference's device polish windows in
    lockstep from ``slots0``; return (step, slots before it, obj,
    ingress, the reference's (y, ΔC), the port's (y, ΔC)) at the first
    differing decision, or None."""
    _, _, objs, ings = emulated_stream(inst, n_iters, 0, slots0, None)
    d = DeviceInstance.from_instance(inst, device="cpu")
    jd = JDeviceInstance.from_instance(jinst)
    pst = DeviceSwapState.init(d, slots0)
    jst = jdevice.DeviceSwapState.init(jd, slots0)
    for t, (o, i) in enumerate(zip(objs.tolist(), ings.tolist())):
        y, dy = _swap_argmin(d, pst.best1, pst.arg1, pst.best2, o, i)
        jy, jdy = jdevice._swap_argmin_device(
            jd.coords, jd.ca, jd.lam, jd.H, jd.slot_cache, jst.best1,
            jst.arg1, jst.best2, jnp.int32(o), jnp.int32(i), jd.metric,
            jd.gamma, True)
        y, dy, jy, jdy = int(y), float(dy), int(jy), float(jdy)
        acc, jacc = _accepts(dy, tol), jdy < -float(np.float32(tol))
        if (acc or jacc) and (y, acc) != (jy, jacc):
            return t, pst.slots_np, o, i, (jy, jdy), (y, dy)
        if acc:
            pst.slots[y] = o
            pst.refresh(d)
            jst.slots = jst.slots.at[jy].set(o)
            jst.refresh(jd)
    return None


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("topo", TOPOS)
def test_warm_start_matches_reference(topo, device):
    inst, jinst = pair(topo)
    kw = dict(polish_iters=POLISH[1024], device=device)
    rep = ws.warm_start(
        inst, dinst=DeviceInstance.from_instance(inst, device="cpu")
        if device else None, torch_device="cpu", **kw)
    jrep = jws.warm_start(
        jinst, dinst=JDeviceInstance.from_instance(jinst) if device
        else None, **kw)
    np.testing.assert_array_equal(rep.slots_warm, jrep.slots_warm)
    np.testing.assert_array_equal(rep.order, jrep.order)
    assert (rep.kind, rep.groups) == (jrep.kind, jrep.groups)
    if jrep.bounds is not None:
        np.testing.assert_array_equal(rep.bounds, jrep.bounds)
    if (topo, device) not in NEAR_TIES:
        np.testing.assert_array_equal(rep.slots, jrep.slots)
        assert rep.n_swaps == jrep.n_swaps
        return
    # the named near-tie: identical decisions up to it, then two slots
    # whose f64 ΔC are equal and whose f32 ΔC differ by a few ulps
    step, jpick, pick = NEAR_TIES[topo, device]
    div = _first_divergence(inst, jinst, rep.slots_warm, POLISH[1024],
                            ws.SWAP_TOL)
    assert div is not None
    t, slots, o, i, (jy, jdy), (y, dy) = div
    assert (t, jy, y) == (step, jpick, pick)
    d64 = swap_deltas(inst, SwapState.init(inst, slots), o, i)
    assert d64[jy] == d64[y] == d64.min()
    for f32 in (jdy, dy):     # f32 sums of O·J rounded terms
        assert abs(f32 - d64[y]) <= 1e-5 * abs(d64[y])
    assert not np.array_equal(rep.slots, jrep.slots)
    # both polishes still improve the map, to the same cost within 1 %
    for r, inst_ in ((rep, inst), (jrep, jinst)):
        assert inst_.total_cost(r.slots) <= inst_.total_cost(r.slots_warm)
    assert inst.total_cost(rep.slots) == pytest.approx(
        jinst.total_cost(jrep.slots), rel=1e-2)


def test_warm_start_runs_on_the_card_unless_told(monkeypatch):
    """With no card, a warm start that needs a torch device and was not
    told one raises; a chain polished on the host needs none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ws.warm_start(pair("tandem_both")[0], polish_iters=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ws.warm_start(pair("chain")[0], polish_iters=4)
    rep = ws.warm_start(pair("chain")[0], polish_iters=4, device=False)
    assert rep.slots.shape == (192,)


# ====================================================================
# 2 · the reference's invariants, on the port
# ====================================================================
@functools.lru_cache(maxsize=None)
def gap_point(topo: str, O: int):
    """(gap, report, inst) against ``device_greedy`` on the CPU."""
    inst = pair(topo, O)[0]
    dinst = DeviceInstance.from_instance(inst, device="cpu")
    rep = ws.warm_start(inst, dinst=dinst, polish_iters=POLISH[O])
    g = device_greedy(dinst)
    cg = inst.total_cost(np.where(g < 0, 0, g))
    return (inst.total_cost(rep.slots) - cg) / cg, rep, inst


@pytest.mark.parametrize("topo", ["chain", "tandem", "tree"])
def test_gap_1e3(topo):
    gap, _, _ = gap_point(topo, 1024)
    assert gap <= GAP_BOUND[topo], \
        f"{topo}@1024: gap {gap:.3%} above recorded bound"


def test_gap_shrinks_with_polish():
    _, rep, inst = gap_point("tandem", 1024)
    assert inst.total_cost(rep.slots) <= inst.total_cost(rep.slots_warm) \
        + 1e-9
    assert rep.n_swaps > 0


@pytest.mark.parametrize("topo", ["chain", "tandem", "tree"])
def test_bands_contiguous_after_mapping(topo):
    """Discrete Prop 4.2: each chain-position cache stores only objects
    whose popularity rank lies in its band's rank_window."""
    _, rep, inst = gap_point(topo, 1024)
    rank_of = np.empty(inst.cat.n, np.int64)
    rank_of[rep.order] = np.arange(inst.cat.n)
    for p, caches in enumerate(rep.groups):
        for j in caches:
            k = int(inst.net.capacities[j])
            lo, hi = ws.rank_window(inst.cat.n, int(rep.bounds[p]),
                                    int(rep.bounds[p + 1]), k)
            stored = rep.slots_warm[inst.slot_cache == j]
            r = rank_of[stored]
            assert r.min() >= lo and r.max() < hi
            assert len(np.unique(stored)) == k


@pytest.mark.parametrize("topo", ["chain", "tandem", "tree"])
def test_warm_polish_never_worse_than_cold_localswap(topo):
    _, rep, inst = gap_point(topo, 1024)
    dinst = DeviceInstance.from_instance(inst, device="cpu")
    cw = inst.total_cost(rep.slots)
    for seed in (0, 1):
        cold0 = random_slots(inst, np.random.default_rng(seed))
        st_ = device_localswap(dinst, n_iters=POLISH[1024], seed=0,
                               slots0=cold0)
        cc = inst.total_cost(np.where(st_.slots_np < 0, 0, st_.slots_np))
        assert cw <= cc + 1e-9 * max(1.0, abs(cc))


def test_classify_shapes():
    """The reference's classification tests: chains of every
    single-ingress topology, the tandem-both pattern, the tree levels,
    and the fallback contract as a ValueError."""
    nets = _nets(PORT)
    for name, n_path in (("single_cache", 1), ("tandem", 2), ("chain", 4),
                         ("tpu_hierarchy", 3)):
        red = ws.classify_topology(nets[name])
        assert red.kind == "chain" and len(red.path) == n_path
        assert red.spec.hs == tuple(sorted(red.spec.hs))
    red = ws.classify_topology(nets["tandem_both"])
    assert (red.kind, red.leaf, red.parent, red.leaf_ingress,
            red.parent_ingress) == ("tandem_both", 0, 1, 0, 1)
    assert red.h == pytest.approx(2.0)
    red = ws.classify_topology(nets["equi_depth_tree"])
    assert [len(lv) for lv in red.levels] == [9, 3, 1]
    assert red.spec.ks == (4.0, 8.0, 16.0)
    assert red.spec.hs == (0.0, 1.0, 3.0)
    assert ws.classify_topology(nets["irregular0"]) is None
    assert ws.classify_topology(nets["irregular1"]) is None
    assert ws.classify_topology(nets["irregular2"]).unreachable == (1,)
    cat = catalog_api.embedding_catalog(n=64, dim=4, seed=0)
    dem = demand_api.zipf(cat, alpha=1.0, n_ingress=2, seed=1)
    with pytest.raises(ValueError, match="discrete solvers"):
        ws.warm_start(Instance(net=nets["irregular0"], cat=cat, dem=dem))


def _check_valid(inst, rep):
    K = inst.net.total_slots
    for slots in (rep.slots_warm, rep.slots):
        assert slots.shape == (K,)
        assert slots.min() >= 0 and slots.max() < inst.cat.n
    for j in range(inst.net.n_caches):
        stored = rep.slots_warm[inst.slot_cache == j]
        k = int(inst.net.capacities[j])
        assert len(stored) == k
        if k <= inst.cat.n:
            assert len(np.unique(stored)) == k


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), n_caches=st.integers(1, 4),
       alpha=st.sampled_from([0.5, 0.9, 1.2]))
def test_random_chain_invariants(seed, n_caches, alpha):
    rng = np.random.default_rng(seed)
    O = int(rng.integers(50, 400))
    cat = catalog_api.embedding_catalog(n=O, dim=6, seed=seed)
    ks = rng.integers(4, max(6, O // 4), n_caches)
    hs = np.concatenate([[0.0], np.sort(rng.uniform(0.5, 20.0,
                                                    n_caches - 1))])
    net = topology_api.chain(n_caches, ks.tolist(), hs.tolist(), 100.0)
    inst = Instance(net=net, cat=cat,
                    dem=demand_api.zipf(cat, alpha=alpha, seed=seed + 1))
    red = ws.classify_topology(inst.net, gamma=inst.cat.gamma)
    assert red.kind == "chain" and len(red.path) == n_caches
    rep = ws.warm_start(inst, polish_iters=64, device=False)
    _check_valid(inst, rep)
    assert inst.total_cost(rep.slots) <= inst.empty_cost() + 1e-9
    rep2 = ws.warm_start(inst, polish_iters=64, device=False)
    np.testing.assert_array_equal(rep.slots, rep2.slots)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 10_000), branching=st.integers(2, 3),
       depth=st.integers(1, 2))
def test_random_tree_invariants(seed, branching, depth):
    rng = np.random.default_rng(seed)
    O = int(rng.integers(60, 300))
    cat = catalog_api.embedding_catalog(n=O, dim=5, seed=seed)
    ks = rng.integers(3, 12, depth + 1).tolist()
    hs = np.concatenate([[0.0], np.sort(rng.uniform(0.5, 8.0, depth))])
    net = topology_api.equi_depth_tree(branching, depth, ks, hs.tolist(),
                                       50.0)
    dem = demand_api.zipf(cat, alpha=0.8, n_ingress=net.n_ingress,
                          seed=seed + 1)
    inst = Instance(net=net, cat=cat, dem=dem)
    red = ws.classify_topology(inst.net)
    assert red.kind == "tree"
    assert [len(lv) for lv in red.levels] == \
        [branching ** (depth - d) for d in range(depth + 1)]
    rep = ws.warm_start(inst, polish_iters=48, device=False)
    _check_valid(inst, rep)
    assert inst.total_cost(rep.slots) <= inst.empty_cost() + 1e-9


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 10_000),
       beta=st.sampled_from([0.25, 1.0, 4.0]))
def test_random_tandem_both_invariants(seed, beta):
    rng = np.random.default_rng(seed)
    O = int(rng.integers(64, 400))
    cat = catalog_api.embedding_catalog(n=O, dim=6, seed=seed)
    net = topology_api.tandem_both(int(rng.integers(4, 32)),
                                   int(rng.integers(4, 32)), 2.0, 60.0)
    dem = demand_api.zipf(cat, alpha=0.9, n_ingress=2, seed=seed + 1,
                          betas=np.array([1.0, beta]))
    inst = Instance(net=net, cat=cat, dem=dem)
    red = ws.classify_topology(inst.net, gamma=inst.cat.gamma)
    assert red.kind == "tandem_both"
    rep = ws.warm_start(inst, polish_iters=48, device=False,
                        torch_device="cpu")
    _check_valid(inst, rep)
    assert inst.total_cost(rep.slots) <= inst.empty_cost() + 1e-9


def test_small_catalog_wraps():
    """k > O: every object stored, duplicates legal, no −1 slots."""
    cat = catalog_api.grid(L=3)
    net = topology_api.tandem(k_leaf=16, k_parent=4, h=1.0, h_repo=20.0)
    inst = Instance(net=net, cat=cat, dem=demand_api.uniform(cat))
    rep = ws.warm_start(inst, polish_iters=0)
    assert rep.slots.shape == (20,)
    assert rep.slots.min() >= 0 and rep.slots.max() < 9
    assert set(rep.slots[inst.slot_cache == 0].tolist()) == set(range(9))
