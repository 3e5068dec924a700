"""The port's NETDUEL (paper §5) against the JAX reference, on the CPU.

Mirrors tests/test_netduel.py and tests/test_netduel_device.py (the
mesh test is in tests/test_torch_sharded.py). The gauss, zipf and
tree instances are built in both packages from the same seeds (their
numpy inputs are byte-equal, tests/test_torch_data.py).

What must match, and how:

* port against JAX — the promotion list (t, slot, object), the final
  slots, ``virt``, ``deadline`` and the promotion count exactly. The f32
  savings (the promotion events' and the carry's) bitwise where both
  packages get one explicit C_a matrix (the host policies and the
  materialized device scans); where each streams its own C_a (the
  shape-stable form: JAX sums the feature axis with ``jnp.sum``, the port
  in an ascending loop, so a pair differs by f32 rounding) to 1e-5
  relative. Two packages' own *materialized* l2 matrices are not
  compared: their matmul forms carry up to ~1 of cancellation noise at
  d ≈ 0 on these catalogs, and a saving sums hundreds of such terms. The
  served cost to 1e-6 relative.
* inside the port, the reference's own exactness contracts, bitwise:
  the device scan ≡ the host policy on materialized instances,
  incremental ≡ full re-arm, a masked (bucketed) window ≡ the unpadded
  one, the δ-margin ties, deadline re-arm cycles, a window that never
  promotes, and a settle with more than ``PROMOTE_CAP`` promotions (the
  full-rebuild branch). Kernel F's host driver (the scan in launches
  between promotions, ``_duel_scan(kernel=True)``), run here with F's
  plain version, ≡ the plain scan, bitwise.
* the cost trace (``record_every``): the host's f64 sums against the
  device's f32 ``sum(λ·best1)`` to 1e-5 relative, as in the reference
  suite; between the port's two device paths bitwise (one torch sum of
  the same table).
"""
import importlib

import numpy as np
import pytest
import torch

from repro.core import catalog as jcat
from repro.core import demand as jdem
from repro.core import topology as jtop
from repro.core.objective import DeviceInstance as JDevInst
from repro.core.objective import Instance as JInst
from repro.core.placement import device_netduel as jdevice_netduel
from repro.core.placement import netduel as jnetduel
from repro.kernels.knn.gains import duel_virtual_costs as jduel_costs
from repro_torch.core import catalog, demand, topology
from repro_torch.core.objective import (DeviceInstance, Instance,
                                        random_slots)
from repro_torch.core.placement import DuelPlane, device_netduel, netduel
from repro_torch.kernels.duel import DuelXs
from repro_torch.kernels.knn.gains import duel_virtual_costs

# the module (the package exports the function under the same name)
nd = importlib.import_module("repro_torch.core.placement.netduel")
JAX = (jcat, jdem, jtop, JInst)
PORT = (catalog, demand, topology, Instance)


def gauss_instance(pkg, L=8, k=(3, 4), sigma=2.0, seed=0, ca=None):
    cat_m, dem_m, top_m, inst_cls = pkg
    cat = cat_m.grid(L=L)
    net = top_m.tandem(k_leaf=k[0], k_parent=k[1], h=2.0, h_repo=10.0)
    dem0 = dem_m.gaussian_grid(cat, sigma=sigma)
    rng = np.random.default_rng(seed)
    lam = dem0.lam * (1.0 + 1e-3 * rng.random(dem0.lam.shape))
    return inst_cls(net=net, cat=cat, dem=dem_m.Demand(lam=lam / lam.sum()),
                    ca_matrix=ca)


def zipf_instance(pkg, n=150, dim=6, k=(6, 9), seed=1, ca=None):
    cat_m, dem_m, top_m, inst_cls = pkg
    cat = cat_m.embedding_catalog(n=n, dim=dim, seed=seed)
    net = top_m.tandem(k_leaf=k[0], k_parent=k[1], h=50.0, h_repo=400.0)
    return inst_cls(net=net, cat=cat,
                    dem=dem_m.zipf(cat, alpha=0.8, seed=seed + 1),
                    ca_matrix=ca)


def tree_instance(pkg, seed=3, ca=None):
    cat_m, dem_m, top_m, inst_cls = pkg
    cat = cat_m.embedding_catalog(n=150, dim=4, seed=seed)
    net = top_m.equi_depth_tree(2, 1, [4, 6], [0.0, 30.0], 300.0)
    dem = dem_m.zipf(cat, alpha=0.7, n_ingress=net.n_ingress, seed=seed)
    return inst_cls(net=net, cat=cat, dem=dem, ca_matrix=ca)


ALL = [("gauss", gauss_instance), ("zipf", zipf_instance),
       ("tree", tree_instance)]
KW = dict(n_iters=6000, seed=3, window=400, arm_prob=0.35)


def dev(inst, materialize=None):
    return DeviceInstance.from_instance(inst, materialize_ca=materialize,
                                        device="cpu")


def assert_duel_equal(st_h, st_d, served=True):
    """Host DuelState == device DeviceDuelState of the port: exact ints,
    bitwise f32 duel state, served cost to f64 roundoff."""
    np.testing.assert_array_equal(st_h.sw.slots, st_d.slots)
    assert st_h.n_promotions == st_d.n_promotions
    assert st_h.promotions == st_d.promotions
    np.testing.assert_array_equal(st_h.virt, st_d.virt)
    np.testing.assert_array_equal(st_h.deadline, st_d.deadline)
    np.testing.assert_array_equal(st_h.real_sav, st_d.real_sav)
    np.testing.assert_array_equal(st_h.virt_sav, st_d.virt_sav)
    if served:
        assert st_h.n_served == st_d.n_served
        np.testing.assert_allclose(st_d.served_cost, st_h.served_cost,
                                   rtol=1e-12)


def assert_device_equal(a, b):
    """Two device runs of the port: every output bitwise."""
    for f in ("slots", "virt", "deadline", "real_sav", "virt_sav",
              "b1_trace"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.promotions == b.promotions
    assert a.n_promotions == b.n_promotions
    assert a.served_cost == b.served_cost
    assert a.cost_trace == b.cost_trace


def assert_matches_reference(got, ref, bitwise: bool, host: bool):
    """The port's state against the reference's: discrete outputs
    exactly, savings bitwise (one shared C_a) or to 1e-5 relative, the
    served cost to 1e-6 relative."""
    slots = (lambda s: s.sw.slots) if host else (lambda s: s.slots)
    np.testing.assert_array_equal(slots(got), slots(ref))
    np.testing.assert_array_equal(got.virt, ref.virt)
    np.testing.assert_array_equal(got.deadline, ref.deadline)
    assert got.n_promotions == ref.n_promotions
    assert [p[:3] for p in got.promotions] == [p[:3] for p in ref.promotions]
    sav = lambda s: np.asarray([p[3:] for p in s.promotions])  # noqa: E731
    if bitwise:
        assert got.promotions == ref.promotions
        np.testing.assert_array_equal(got.real_sav, ref.real_sav)
        np.testing.assert_array_equal(got.virt_sav, ref.virt_sav)
    else:
        np.testing.assert_allclose(sav(got), sav(ref), rtol=1e-5)
        np.testing.assert_allclose(got.real_sav, ref.real_sav, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref.real_sav).max())
        np.testing.assert_allclose(got.virt_sav, ref.virt_sav, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref.virt_sav).max())
    np.testing.assert_allclose(got.served_cost, ref.served_cost, rtol=1e-6)


# ------------------------------------------------------- against the JAX
@pytest.mark.parametrize("name,make", ALL)
def test_netduel_matches_reference_on_one_ca(name, make):
    """The host policy and the materialized device scan (the plain
    version, on the CPU) against the reference's, both packages given
    the reference's C_a matrix: everything bitwise but the served cost."""
    ca = np.asarray(make(JAX).ca)
    inst, jinst = make(PORT, ca=ca), make(JAX, ca=ca)
    ref_h = jnetduel(jinst, **KW)
    assert ref_h.n_promotions > 0                     # a non-trivial run
    assert_matches_reference(netduel(inst, **KW), ref_h, bitwise=True,
                             host=True)
    ref_d = jdevice_netduel(JDevInst.from_instance(jinst),
                            record_events=True, **KW)
    got_d = device_netduel(dev(inst), record_events=True, **KW)
    assert_matches_reference(got_d, ref_d, bitwise=True, host=False)


@pytest.mark.parametrize("name,make", ALL)
def test_streamed_netduel_matches_reference(name, make):
    """The device scans with each package's own streamed C_a (the
    engine's mode): discrete outputs exact, savings to 1e-5 relative."""
    inst, jinst = make(PORT), make(JAX)
    kw = dict(KW, n_iters=3000)
    ref = jdevice_netduel(JDevInst.from_instance(jinst,
                                                 materialize_ca=False),
                          record_events=True, **kw)
    assert ref.n_promotions > 0
    got = device_netduel(dev(inst, materialize=False), record_events=True,
                         **kw)
    assert_matches_reference(got, ref, bitwise=False, host=False)


@pytest.mark.parametrize("metric,gamma", [("l1", 1.0), ("l2", 1.0),
                                          ("l2sq", 1.0), ("l2", 0.5)])
def test_duel_virtual_costs_match_reference(metric, gamma):
    """One request's virtual costs, streamed (shape-stable form) and
    gathered from a materialized C_a, against the reference: the gather
    bitwise on one shared matrix, the streamed row to 1e-6 relative (two
    frameworks' f32 sums in one order)."""
    rng = np.random.default_rng(4)
    coords = rng.standard_normal((40, 7)).astype(np.float32) * 30
    h = np.where(rng.random(12) < 0.2, np.inf,
                 rng.random(12) * 10).astype(np.float32)
    virt = rng.integers(0, 40, 12)
    ca = np.abs(rng.standard_normal((40, 40))).astype(np.float32)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    for obj in (0, 17):
        for has_ca in (True, False):
            got = duel_virtual_costs(t(coords), t(ca), obj, t(virt), t(h),
                                     metric, gamma, has_ca).numpy()
            ref = np.asarray(jduel_costs(coords, ca, obj, virt, h, metric,
                                         gamma, has_ca))
            if has_ca:
                np.testing.assert_array_equal(got, ref)
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-6)


# ------------------------------------------ the port's exactness contracts
@pytest.mark.parametrize("name,make", ALL)
def test_device_netduel_bit_identical(name, make):
    inst = make(PORT)
    st_h = netduel(inst, **KW)
    st_d = device_netduel(dev(inst), record_events=True, **KW)
    assert st_h.n_promotions > 0
    assert_duel_equal(st_h, st_d)


@pytest.mark.parametrize("name,make", ALL)
@pytest.mark.parametrize("materialize", [True, False])
def test_kernel_driver_equals_plain_scan(name, make, materialize):
    """Kernel F's host driver — launches from one promotion to the next,
    the re-arm between them, events and the cost trace per table
    version — here with F's plain version, against the plain scan:
    bitwise, streamed C_a included."""
    d = dev(make(PORT), materialize)
    kw = dict(KW, n_iters=2500, record_events=True, record_every=300)
    plain = device_netduel(d, **kw)
    orig = nd._duel_scan

    def through_kernel(*a, **k):
        return orig(*a, **dict(k, kernel=True))
    try:
        nd._duel_scan = through_kernel
        driven = device_netduel(d, **kw)
    finally:
        nd._duel_scan = orig
    assert plain.n_promotions > 0
    assert_device_equal(driven, plain)


def test_device_netduel_fixed_stream_and_lambda_unawareness():
    """With an explicit request stream the device scan replays the host
    trajectory exactly, and — like the host — it never reads λ."""
    inst_a = zipf_instance(PORT, seed=5)
    inst_b = Instance(net=inst_a.net, cat=inst_a.cat,
                      dem=demand.uniform(inst_a.cat))
    rng = np.random.default_rng(9)
    requests = inst_a.dem.sample(5000, rng)
    slots0 = random_slots(inst_a, np.random.default_rng(1))
    kw = dict(seed=7, window=300, arm_prob=0.4, slots0=slots0,
              requests=requests)
    st_h = netduel(inst_a, **kw)
    st_d = device_netduel(dev(inst_a), record_events=True, **kw)
    st_u = device_netduel(dev(inst_b), record_events=True, **kw)
    assert_duel_equal(st_h, st_d)
    np.testing.assert_array_equal(st_d.slots, st_u.slots)
    assert st_d.promotions == st_u.promotions


def test_device_netduel_cost_trace_matches():
    inst = zipf_instance(PORT)
    kw = dict(n_iters=3000, seed=2, window=250, arm_prob=0.4,
              record_every=500)
    st_h = netduel(inst, **kw)
    st_d = device_netduel(dev(inst), **kw)
    assert len(st_h.sw.cost_trace) == len(st_d.cost_trace)
    np.testing.assert_allclose(st_d.cost_trace, st_h.sw.cost_trace,
                               rtol=1e-5)


def _line_instance():
    """1-D l1 catalog [x0=0, x1=3, q=4] over a single 1-slot cache with
    h_repo=6: a stream [x1, q, q, ...] arms virtual x1 against real x0
    and accumulates exactly rs=2 and vs=3 per q-request."""
    coords = np.array([[0.0], [3.0], [4.0]], np.float32)
    cat = catalog.Catalog(coords=coords, metric="l1")
    net = topology.single_cache(k=1, h_repo=6.0)
    lam = np.full((1, 3), 1.0 / 3)
    return Instance(net=net, cat=cat, dem=demand.Demand(lam=lam))


@pytest.mark.parametrize("delta,promotes", [
    (0.5, False),        # vs == (1+δ)·rs exactly → strict > fails
    (0.4999, True),      # just under the boundary → promote
    (0.5001, False),     # just over → discard
])
def test_delta_margin_boundary_tie(delta, promotes):
    inst = _line_instance()
    w = 16
    objs = np.array([1] + [2] * w)
    ings = np.zeros_like(objs)
    kw = dict(seed=0, window=w, delta=delta, arm_prob=1.0,
              slots0=np.array([0]), requests=(objs, ings))
    st_h = netduel(inst, **kw)
    st_d = device_netduel(dev(inst), record_events=True, **kw)
    assert_duel_equal(st_h, st_d)
    assert (st_h.n_promotions > 0) == promotes
    if promotes:
        t, y, obj, rs, vs = st_h.promotions[0]
        assert (t, y, obj) == (w, 0, 1)
        assert vs == 3.0 * w and rs == 2.0 * w


def test_deadline_rearm_cycles():
    inst = gauss_instance(PORT)
    kw = dict(n_iters=3000, seed=4, window=60, arm_prob=1.0)
    st_h = netduel(inst, **kw)
    st_d = device_netduel(dev(inst), record_events=True, **kw)
    assert_duel_equal(st_h, st_d)
    assert np.all(st_h.deadline > 3000 - 2 * 60)
    assert st_h.n_promotions > 1


def test_never_promoted_window():
    inst = zipf_instance(PORT)
    slots0 = random_slots(inst, np.random.default_rng(8))
    kw = dict(n_iters=500, seed=1, window=10_000, arm_prob=1.0,
              slots0=slots0)
    st_h = netduel(inst, **kw)
    st_d = device_netduel(dev(inst), record_events=True, **kw)
    assert_duel_equal(st_h, st_d)
    assert st_h.n_promotions == 0
    np.testing.assert_array_equal(st_d.slots, slots0)
    assert np.any(st_d.virt >= 0)


@pytest.mark.parametrize("name,make", ALL)
def test_device_netduel_incremental_bit_identical(name, make):
    d = dev(make(PORT))
    kw = dict(KW, record_events=True)
    st_i = device_netduel(d, incremental=True, **kw)
    st_f = device_netduel(d, incremental=False, **kw)
    assert st_i.n_promotions > 0
    assert_device_equal(st_i, st_f)


def test_duelplane_incremental_bit_identical():
    inst = zipf_instance(PORT, seed=11)
    d = dev(inst)
    slots0 = random_slots(inst, np.random.default_rng(2))
    planes = [DuelPlane(d, slots0, window=120, arm_prob=0.6, seed=5,
                        incremental=inc) for inc in (True, False)]
    rng = np.random.default_rng(7)
    for b in range(6):
        objs, ings = inst.dem.sample(96, rng)
        n_valid = 96 if b % 2 == 0 else 70        # alternate bucketed
        for p in planes:
            p.observe(objs, ings, n_valid=n_valid)
        pi, pf = planes
        np.testing.assert_array_equal(pi.slots_np, pf.slots_np)
        assert pi.n_promotions == pf.n_promotions
        assert pi.served_cost == pf.served_cost
    assert planes[0].n_promotions > 0


@pytest.mark.parametrize("materialize", [True, False])
def test_duelplane_masked_window_equals_unpadded(materialize):
    """A bucketed batch (valid prefix, padding rows of any content)
    leaves the carry, the rng and the served cost bitwise where the
    unpadded batch leaves them, with external b1 prices as the engine
    gives them."""
    inst = zipf_instance(PORT, seed=12)
    d = dev(inst, materialize)
    slots0 = random_slots(inst, np.random.default_rng(3))
    kw = dict(window=80, arm_prob=0.7, seed=9)
    exact, padded = DuelPlane(d, slots0, **kw), DuelPlane(d, slots0, **kw)
    rng = np.random.default_rng(1)
    best1 = exact.carry.best1.numpy()
    for n in (37, 64, 5, 100):
        objs, _ = inst.dem.sample(n, rng)
        b1 = best1[0, objs] * np.float32(1.01)
        pad = 128 - n
        objs_p = np.concatenate([objs, rng.integers(0, inst.cat.n, pad)])
        b1_p = np.concatenate([b1, rng.random(pad).astype(np.float32)])
        exact.observe(objs, b1_ext=b1)
        padded.observe(objs_p, b1_ext=b1_p, n_valid=n)
        for a, b in zip(exact.carry, padded.carry):
            assert torch.equal(a, b)
        assert exact.served_cost == padded.served_cost
        assert exact.t == padded.t
    assert exact.n_promotions > 0


def _crowded_settle(n_slots=12, w=5):
    """A window in which ``n_slots`` duels expire at one step: a 1-D l1
    catalog (object 0 at 0, objects 1..n at 100, the request q at 100),
    one cache of ``n_slots`` copies of object 0 at h = 0, h_repo 1000.
    Steps 0..n−1 (duel time 0) request 1..n and arm the first free slot
    each; step n (duel time w) requests q, every duel expires with
    vs > 0 = rs, and all promote at once."""
    coords = np.zeros((n_slots + 2, 1), np.float32)
    coords[1:] = 100.0
    cat = catalog.Catalog(coords=coords, metric="l1")
    net = topology.single_cache(k=n_slots, h_repo=1000.0)
    inst = Instance(net=net, cat=cat, dem=demand.uniform(cat))
    objs = np.r_[np.arange(1, n_slots + 1), n_slots + 1, 1, 2]
    ts = np.r_[np.zeros(n_slots), w, w + 1, w + 2].astype(np.int64)
    T = len(objs)
    xs = DuelXs(torch.as_tensor(objs), torch.zeros(T, dtype=torch.int64),
                torch.as_tensor(ts), torch.ones(T, dtype=torch.bool),
                torch.zeros(T, dtype=torch.float32))
    return inst, np.zeros(n_slots, np.int64), xs, w


@pytest.mark.parametrize("materialize", [True, False])
def test_settle_past_promote_cap_takes_full_rebuild(materialize):
    """More than ``PROMOTE_CAP`` promotions in one step: the re-arm takes
    the full rebuild, and the plain scan, the kernel driver and the full
    re-arm all end bitwise equal, on the tables a fresh build gives."""
    inst, slots0, xs, w = _crowded_settle()
    d = dev(inst, materialize)
    h_slots, on_path = nd._scan_args(d)
    runs = []
    for kernel, incremental in ((False, True), (True, True), (False, False)):
        carry, out = nd._duel_scan(
            d, h_slots, on_path, nd._duel_carry(d, slots0), xs,
            float(np.float32(1.05)), w, True, False, 0,
            incremental=incremental, kernel=kernel)
        runs.append((carry, out))
    (carry, out), *others = runs
    assert int(carry.n_prom.sum()) == 12 > nd.PROMOTE_CAP
    assert [int(e[1].sum()) for e in out.events] == [12]
    np.testing.assert_array_equal(carry.slots.numpy(), np.arange(1, 13))
    fresh = nd._duel_carry(d, carry.slots.numpy())
    for a, b in zip(carry[1:8], fresh[1:8]):
        assert torch.equal(a, b)
    for c2, o2 in others:
        for a, b in zip(carry, c2):
            assert torch.equal(a, b)
        assert torch.equal(out.b1, o2.b1)
        assert len(o2.events) == 1 and all(
            torch.equal(a, b) for a, b in zip(out.events[0][1:],
                                              o2.events[0][1:]))


# ----------------------------------------------------------- the policy
def small_instance(L=12, k=6, h=1.5, h_repo=15.0, sigma=None):
    cat = catalog.grid(L=L)
    net = topology.tandem(k_leaf=k, k_parent=k, h=h, h_repo=h_repo)
    dem = demand.gaussian_grid(cat, sigma=sigma or L / 6)
    return Instance(net=net, cat=cat, dem=dem)


def test_netduel_improves_over_random_init():
    inst = small_instance()
    rng = np.random.default_rng(0)
    slots0 = random_slots(inst, rng)
    c0 = inst.total_cost(slots0)
    st = netduel(inst, n_iters=30000, seed=0, slots0=slots0,
                 window=1000, arm_prob=0.3)
    assert st.n_promotions > 0
    assert st.sw.cost(inst) < c0 * 0.7, (c0, st.sw.cost(inst))


def test_netduel_is_lambda_unaware():
    inst_a = small_instance(sigma=2.0)
    inst_b = small_instance(sigma=6.0)     # different λ, same topology
    rng = np.random.default_rng(1)
    objs, ings = inst_a.dem.sample(8000, rng)
    st_a = netduel(inst_a, requests=(objs, ings), seed=3, window=800)
    st_b = netduel(inst_b, requests=(objs, ings), seed=3, window=800)
    np.testing.assert_array_equal(st_a.sw.slots, st_b.sw.slots)


def test_netduel_virtual_never_stored_before_promotion():
    inst = small_instance()
    rng = np.random.default_rng(2)
    slots0 = random_slots(inst, rng)
    st = netduel(inst, n_iters=500, seed=0, slots0=slots0,
                 window=10_000, arm_prob=1.0)
    np.testing.assert_array_equal(st.sw.slots, slots0)
    assert st.n_promotions == 0


def test_netduel_tracks_serving_cost():
    inst = small_instance()
    st = netduel(inst, n_iters=5000, seed=4, window=500)
    assert st.n_served == 5000
    assert st.served_cost / st.n_served <= inst.empty_cost() + 1e-9
