"""The port's placement control plane against the JAX reference, on the
CPU.

Mirrors tests/test_device_placement.py: the same gauss, zipf and tree
instances are built in both packages from the same seeds (their numpy
inputs are byte-equal, tests/test_torch_data.py), and

* the port's device GREEDY returns the allocation of the port's host
  GREEDY, of the reference's host GREEDY and of the reference's device
  GREEDY — picks are discrete outputs, so equality is exact (the
  instances' decision margins exceed f32 resolution, as in the
  reference's own suite);
* LOCALSWAP, the polish and the cascade match the host oracles slot for
  slot and swap for swap at one decision margin (``TOL``);
* inside the port the stepped and whole-loop forms, and the incremental
  and full best-two re-arms, are bitwise identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import catalog as jcat
from repro.core import demand as jdem
from repro.core import topology as jtop
from repro.core.objective import DeviceInstance as JDevInst
from repro.core.objective import Instance as JInst
from repro.core.placement import device_greedy as jdevice_greedy
from repro.core.placement import \
    device_greedy_then_localswap as jdevice_cascade
from repro.core.placement import greedy as jgreedy
from repro.core.placement import localswap as jlocalswap
from repro.core.placement import greedy_then_localswap as jcascade
from repro_torch.core import catalog, demand, topology
from repro_torch.core.objective import (DeviceInstance, Instance,
                                        random_slots)
from repro_torch.core.placement import (device_greedy,
                                        device_greedy_then_localswap,
                                        device_localswap,
                                        device_localswap_polish, greedy,
                                        greedy_then_localswap, localswap,
                                        localswap_polish)

TOL = 1e-5          # one decision margin for host and device swap paths
JAX = (jcat, jdem, jtop, JInst)
PORT = (catalog, demand, topology, Instance)


def gauss_instance(pkg, L=8, k=(3, 4), sigma=2.0, seed=0):
    """§6.1 grid/Gaussian instance, demand jittered to break the grid's
    exact gain ties (as the reference's suite does)."""
    cat_m, dem_m, top_m, inst_cls = pkg
    cat = cat_m.grid(L=L)
    net = top_m.tandem(k_leaf=k[0], k_parent=k[1], h=2.0, h_repo=10.0)
    dem0 = dem_m.gaussian_grid(cat, sigma=sigma)
    rng = np.random.default_rng(seed)
    lam = dem0.lam * (1.0 + 1e-3 * rng.random(dem0.lam.shape))
    return inst_cls(net=net, cat=cat, dem=dem_m.Demand(lam=lam / lam.sum()))


def zipf_instance(pkg, n=180, dim=6, k=(8, 12), seed=1):
    cat_m, dem_m, top_m, inst_cls = pkg
    cat = cat_m.embedding_catalog(n=n, dim=dim, seed=seed)
    net = top_m.tandem(k_leaf=k[0], k_parent=k[1], h=50.0, h_repo=400.0)
    return inst_cls(net=net, cat=cat,
                    dem=dem_m.zipf(cat, alpha=0.8, seed=seed + 1))


def tree_instance(pkg, seed=3):
    cat_m, dem_m, top_m, inst_cls = pkg
    cat = cat_m.embedding_catalog(n=150, dim=4, seed=seed)
    net = top_m.equi_depth_tree(2, 1, [4, 6], [0.0, 30.0], 300.0)
    dem = dem_m.zipf(cat, alpha=0.7, n_ingress=net.n_ingress, seed=seed)
    return inst_cls(net=net, cat=cat, dem=dem)


ALL = [("gauss", gauss_instance), ("zipf", zipf_instance),
       ("tree", tree_instance)]


def dev(inst, materialize=None):
    return DeviceInstance.from_instance(inst, materialize_ca=materialize,
                                        device="cpu")


@pytest.mark.parametrize("name,make", ALL)
@pytest.mark.parametrize("materialize", [True, False])
def test_device_greedy_matches_host_and_reference(name, make, materialize):
    inst, jinst = make(PORT), make(JAX)
    host = greedy(inst, lazy=True)
    np.testing.assert_array_equal(host, greedy(inst, lazy=False))
    np.testing.assert_array_equal(host, jgreedy(jinst))
    got = device_greedy(dev(inst, materialize))
    np.testing.assert_array_equal(got, host)
    ref = jdevice_greedy(JDevInst.from_instance(
        jinst, materialize_ca=materialize))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name,make", ALL)
@pytest.mark.parametrize("materialize", [True, False])
def test_device_greedy_quantized_seeds_equal_exact(name, make, materialize):
    """``quantize=True`` seeds the lazy table with int8 gain upper bounds,
    marked stale: every pick is re-scored exactly before it is accepted,
    so the allocation is the exact-seeded run's on both loops, and the
    reference's quantized run's."""
    inst, jinst = make(PORT), make(JAX)
    d = dev(inst, materialize)
    exact = device_greedy(d)
    for scan in (True, False):
        np.testing.assert_array_equal(
            device_greedy(d, scan=scan, quantize=True), exact)
    ref = jdevice_greedy(JDevInst.from_instance(
        jinst, materialize_ca=materialize), quantize=True)
    np.testing.assert_array_equal(exact, ref)


@pytest.mark.parametrize("name,make", ALL)
def test_greedy_whole_loop_equals_stepped(name, make):
    """The device-resident loop and the host-bookkept stepped form take
    the same decisions, at any refresh batch size."""
    d = dev(make(PORT), materialize=False)
    for topk in (1, 64):
        np.testing.assert_array_equal(device_greedy(d, topk=topk, scan=True),
                                      device_greedy(d, topk=topk,
                                                    scan=False))


@pytest.mark.parametrize("name,make", ALL[:2])
def test_device_localswap_matches_host_and_reference(name, make):
    inst, jinst = make(PORT), make(JAX)
    hs = localswap(inst, n_iters=300, seed=7, tol=TOL)
    js = jlocalswap(jinst, n_iters=300, seed=7, tol=TOL)
    np.testing.assert_array_equal(hs.slots, js.slots)
    d = dev(inst)
    for incremental in (True, False):
        ds = device_localswap(d, n_iters=300, seed=7, tol=TOL,
                              incremental=incremental)
        np.testing.assert_array_equal(ds.slots_np, hs.slots)
        assert ds.n_swaps == hs.n_swaps


@pytest.mark.parametrize("materialize", [True, False])
def test_device_polish_and_cascade_match_host(materialize):
    inst, jinst = zipf_instance(PORT, n=120, k=(5, 6), seed=2), \
        zipf_instance(JAX, n=120, k=(5, 6), seed=2)
    d = dev(inst, materialize)
    s0 = random_slots(inst, np.random.default_rng(11))
    hp = localswap_polish(inst, s0, max_passes=6, tol=TOL)
    for incremental in (True, False):
        dp = device_localswap_polish(d, s0, max_passes=6, tol=TOL,
                                     incremental=incremental)
        np.testing.assert_array_equal(dp.slots_np, hp.slots)
        assert dp.n_swaps == hp.n_swaps
    hc = greedy_then_localswap(inst, max_passes=6, tol=TOL)
    timings = {}
    dc = device_greedy_then_localswap(d, max_passes=6, tol=TOL,
                                      timings=timings)
    np.testing.assert_array_equal(dc.slots_np, hc.slots)
    np.testing.assert_array_equal(
        hc.slots, jcascade(jinst, max_passes=6, tol=TOL).slots)
    assert set(timings) == {"greedy_s", "polish_s"}


@pytest.mark.parametrize("name,make", ALL)
def test_device_cascade_matches_host_and_reference(name, make):
    """The engine's default solve (GREEDY → LOCALSWAP polish) on every
    instance: the port's device and host cascades and the reference's
    host and device cascades pick the same allocation."""
    inst, jinst = make(PORT), make(JAX)
    host = greedy_then_localswap(inst, max_passes=6, tol=TOL)
    np.testing.assert_array_equal(
        host.slots, jcascade(jinst, max_passes=6, tol=TOL).slots)
    np.testing.assert_array_equal(
        host.slots, jdevice_cascade(JDevInst.from_instance(
            jinst, materialize_ca=False), max_passes=6, tol=TOL).slots_np)
    got = device_greedy_then_localswap(dev(inst, False), max_passes=6,
                                       tol=TOL)
    np.testing.assert_array_equal(got.slots_np, host.slots)
    assert got.n_swaps == host.n_swaps


@pytest.mark.parametrize("materialize", [True, False])
def test_best_two_delta_equals_rebuild(materialize):
    """The incremental re-arm is bitwise the full rebuild, through
    single and multi-slot writes and the over-cap rebuild branch."""
    inst = tree_instance(PORT)
    d = dev(inst, materialize)
    rng = np.random.default_rng(4)
    slots = torch.as_tensor(random_slots(inst, rng))
    slots[3] = -1                                       # an empty slot
    pre = d.best_two_tables(slots)
    K = int(inst.net.total_slots)
    for ys, cap in (([2], None), ([0, 5, 7], None), ([1, 4], 1),
                    ([6, K], None)):
        new = slots.clone()
        for y in ys:
            if y < K:
                new[y] = int(rng.integers(0, inst.cat.n))
        got = d.best_two_delta(*pre, new, torch.tensor(ys), cap=cap)
        want = d.best_two_tables(new)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        slots, pre = new, got


def test_best_two_matches_host_and_reference():
    """Serving tables: the materialized C_a is the host's own matrix, so
    they equal the host's exactly; streamed, they use the shape-stable
    form like the reference's device twin (equal slots, values to
    summation order — the host's matmul-form diagonal carries
    sqrt(eps·|x|²) self-distance noise the stable form does not)."""
    inst, jinst = tree_instance(PORT), tree_instance(JAX)
    slots = random_slots(inst, np.random.default_rng(5))
    host = inst.best_two(slots)
    mat = [a.numpy() for a in dev(inst, True).best_two(slots)]
    for got, want in zip(mat, host):
        np.testing.assert_array_equal(got, want)
    ref = [np.asarray(a) for a in JDevInst.from_instance(
        jinst, materialize_ca=False).best_two(jnp.asarray(slots))]
    streamed = [a.numpy() for a in dev(inst, False).best_two(slots)]
    np.testing.assert_array_equal(streamed[1], ref[1])
    np.testing.assert_array_equal(streamed[1], host[1])
    for i in (0, 2):
        np.testing.assert_allclose(streamed[i], ref[i], rtol=1e-5)


def test_device_total_cost_matches_host():
    inst = zipf_instance(PORT, n=100, k=(4, 4))
    slots = np.where(greedy(inst) < 0, 0, greedy(inst))
    assert dev(inst, False).total_cost(slots) == pytest.approx(
        inst.total_cost(slots), rel=1e-5)


def test_gain_tol_near_ties_resolve_by_index():
    """Duplicated catalog points tie exactly; every path resolves them
    to the lowest (o', j), and a gain_tol above the best gain places
    nothing."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 4, size=(12, 3)).astype(np.float32)
    coords = np.concatenate([base, base[:4]])          # exact duplicates
    cat = catalog.Catalog(coords=coords, metric="l2")
    net = topology.tandem(k_leaf=3, k_parent=3, h=0.5, h_repo=5.0)
    lam = np.concatenate([rng.random(12) + 0.05,
                          (rng.random(4) + 0.05)])[None, :]
    inst = Instance(net=net, cat=cat, dem=demand.Demand(lam=lam / lam.sum()))
    lazy = greedy(inst, lazy=True)
    np.testing.assert_array_equal(lazy, greedy(inst, lazy=False))
    for materialize in (True, False):
        for scan in (True, False):
            np.testing.assert_array_equal(
                lazy, device_greedy(dev(inst, materialize), scan=scan))
    assert not np.any(lazy[lazy >= 0] >= 12)
    cur = np.repeat(inst.net.h_repo[:, None].astype(np.float64),
                    inst.cat.n, axis=1)
    big = float(inst.add_gain_all(cur).max()) + 1.0
    for slots in (greedy(inst, gain_tol=big),
                  device_greedy(dev(inst), gain_tol=big),
                  device_greedy(dev(inst), gain_tol=big, scan=False)):
        assert np.all(slots == -1)
