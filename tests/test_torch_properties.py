"""Twins of the reference's property tests (tests/test_properties.py) on
the port, on the CPU.

The two properties the duel scan and its re-arm bear on:

* incremental best-two re-arm — the port's LOCALSWAP trajectory with
  delta re-arms is bit-identical to the full-rebuild trajectory on
  every random instance (its over-cap fallback included). Beside it,
  the reference's device LOCALSWAP on the same instance takes the same
  swaps to the same slots and witnesses. Each package materializes the
  l2 C_a in the matmul form (‖x‖² + ‖y‖² − 2x·y) and cancels in its own
  order, so the costs agree to that cancellation only: the square root
  of an f32 rounding of ‖x‖² ≤ 32, under 4e-3 at a cost of 0;
* §5 NETDUEL — a promotion never increases the cost measured on the
  duel's own window requests (vs > (1+δ)·rs and vs > 0). Beside it, the
  reference's device scan on the same instance gives the same
  promotions: at dim 2 and l1 both packages' C_a matrices are the same
  bits (two terms sum alike in any order), so the events agree exactly.

And the paper's structural claims on the port's host algorithms, each
beside the reference's result on the same instance (the host algorithms
are copied line for line: equal allocations, gains and costs to 1e-9,
f64 sums of the same terms):

* Prop 3.2 — G(A) is non-negative, monotone and submodular over the
  slot matroid;
* GREEDY's 1/2 bound vs brute-force optimum (tiny instances);
* Prop 3.3 — localswap_polish fixed points are locally optimal;
* Remark 1 — cascade cost ≤ greedy cost, and still ≥ ½·OPT gain;
* eq. (1) — serving cost never exceeds the repository cost, and adding
  any approximizer never increases any request's cost.
"""
import itertools

import numpy as np
from hypothesis import given, settings, strategies as st

from repro.core import catalog as jcat
from repro.core import demand as jdem
from repro.core import topology as jtop
from repro.core.objective import DeviceInstance as JDevInst
from repro.core.objective import Instance as JInst
from repro.core.objective import random_slots as jrandom_slots
from repro.core.placement import device_localswap as jdevice_localswap
from repro.core.placement import device_netduel as jdevice_netduel
from repro.core.placement import greedy as jgreedy
from repro.core.placement import greedy_then_localswap as jcascade
from repro.core.placement import localswap_polish as jlocalswap_polish
from repro_torch.core import catalog, demand, topology
from repro_torch.core.objective import DeviceInstance, Instance, random_slots
from repro_torch.core.placement import (device_localswap, device_netduel,
                                        greedy, greedy_then_localswap,
                                        localswap_polish)
from repro_torch.core.placement.localswap import is_locally_optimal

JAX = (jcat, jdem, jtop, JInst)
PORT = (catalog, demand, topology, Instance)


def make_random_instance(seed, pkg=PORT, n_obj=6, dim=2, k=(1, 1), h=0.5,
                         h_repo=3.0, metric="l1", gamma=1.0):
    """The reference suite's random instance, in either package."""
    cat_m, dem_m, top_m, inst_cls = pkg
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 4, size=(n_obj, dim)).astype(np.float32)
    cat = cat_m.Catalog(coords=coords, metric=metric, gamma=gamma)
    net = top_m.tandem(k_leaf=k[0], k_parent=k[1], h=h, h_repo=h_repo)
    lam = rng.random((1, n_obj)) + 0.05
    return inst_cls(net=net, cat=cat, dem=dem_m.Demand(lam=lam / lam.sum()))


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_localswap_incremental_bit_identical(seed):
    """Delta best-two re-arm == full rebuild along the whole LOCALSWAP
    trajectory, on every random instance; the reference's trajectory
    takes the same swaps."""
    inst = make_random_instance(seed, n_obj=8, k=(2, 2), metric="l2")
    dinst = DeviceInstance.from_instance(inst, device="cpu")
    a = device_localswap(dinst, n_iters=250, seed=seed, incremental=True)
    b = device_localswap(dinst, n_iters=250, seed=seed, incremental=False)
    np.testing.assert_array_equal(a.slots_np, b.slots_np)
    assert a.n_swaps == b.n_swaps
    for name in ("best1", "arg1", "best2"):
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      getattr(b, name).numpy())
    jinst = make_random_instance(seed, JAX, n_obj=8, k=(2, 2), metric="l2")
    ref = jdevice_localswap(JDevInst.from_instance(jinst), n_iters=250,
                            seed=seed)
    np.testing.assert_array_equal(a.slots_np, np.asarray(ref.slots))
    assert a.n_swaps == ref.n_swaps
    np.testing.assert_array_equal(a.arg1.numpy(), np.asarray(ref.arg1))
    for name in ("best1", "best2"):
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=4e-3)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10_000), delta=st.sampled_from([0.0, 0.05, 0.3]))
def test_netduel_promotions_never_hurt_window_cost(seed, delta):
    """§5 settle rule: a virtual wins only with vs > (1+δ)·rs and
    vs > 0, so the window-measured cost change rs − vs is < −δ·rs ≤ 0
    for every promotion, on every random instance and margin; the
    reference's scan promotes the same duels."""
    kw = dict(n_iters=2500, seed=seed + 1, window=120, delta=delta,
              arm_prob=0.6, record_events=True)
    inst = make_random_instance(seed, n_obj=8, k=(2, 2), h_repo=5.0)
    st_ = device_netduel(DeviceInstance.from_instance(inst, device="cpu"),
                         **kw)
    for (t, y, obj, rs, vs) in st_.promotions:
        assert vs > 0.0
        assert vs > (1.0 + np.float32(delta)) * np.float32(rs)
        assert rs - vs < -delta * rs + 1e-9      # window cost never rises
    jinst = make_random_instance(seed, JAX, n_obj=8, k=(2, 2), h_repo=5.0)
    ref = jdevice_netduel(JDevInst.from_instance(jinst), **kw)
    assert st_.promotions == ref.promotions
    np.testing.assert_array_equal(st_.slots, np.asarray(ref.slots))


def gain_of(inst, pairs):
    """Caching gain of an approximizer set given as (obj, cache) pairs,
    ignoring the fixed slot layout (any feasible multiset respecting
    capacities)."""
    slots = np.full(inst.net.total_slots, -1, dtype=np.int64)
    offsets = {j: list(np.where(inst.slot_cache == j)[0]) for j in
               range(inst.net.n_caches)}
    for (o, j) in pairs:
        slots[offsets[j].pop(0)] = o
    return inst.caching_gain(slots)


def _best_gain(inst, n_obj, k):
    return max(inst.caching_gain(np.array(c, np.int64))
               for c in itertools.product(range(n_obj), repeat=k))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_gain_nonneg_monotone_submodular(seed):
    inst = make_random_instance(seed, n_obj=5, k=(2, 2))
    jinst = make_random_instance(seed, JAX, n_obj=5, k=(2, 2))
    rng = np.random.default_rng(seed + 1)
    universe = [(o, j) for o in range(5) for j in range(2)]
    rng.shuffle(universe)
    A = universe[:1]

    def count(S, j):
        return sum(1 for (_, jj) in S if jj == j)
    # A ⊂ B with room for one more element per cache
    B = [p for i, p in enumerate(universe[:2]) if count(universe[:i], p[1])
         < 1]
    alpha = next(p for p in universe if p not in B and count(B, p[1]) < 2)
    gA, gB = gain_of(inst, A), gain_of(inst, B)
    assert gA >= -1e-9 and gB >= -1e-9
    assert gB >= gA - 1e-9                      # monotone (A ⊆ B)
    mgA = gain_of(inst, A + [alpha]) - gA
    mgB = gain_of(inst, B + [alpha]) - gB
    assert mgA >= mgB - 1e-7                    # submodular
    for S in (A, B, A + [alpha], B + [alpha]):
        assert abs(gain_of(inst, S) - gain_of(jinst, S)) < 1e-9


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_greedy_half_approximation(seed):
    inst = make_random_instance(seed, n_obj=5, k=(1, 1))
    gslots = greedy(inst)
    np.testing.assert_array_equal(
        gslots, jgreedy(make_random_instance(seed, JAX, n_obj=5, k=(1, 1))))
    assert inst.caching_gain(gslots) >= 0.5 * _best_gain(inst, 5, 2) - 1e-9


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_polish_fixed_point_is_locally_optimal(seed):
    inst = make_random_instance(seed, n_obj=6, k=(1, 2))
    jinst = make_random_instance(seed, JAX, n_obj=6, k=(1, 2))
    start = random_slots(inst, np.random.default_rng(seed))
    np.testing.assert_array_equal(
        start, jrandom_slots(jinst, np.random.default_rng(seed)))
    st_ = localswap_polish(inst, start.copy())
    assert is_locally_optimal(inst, st_.slots)
    ref = jlocalswap_polish(jinst, start.copy())
    np.testing.assert_array_equal(st_.slots, ref.slots)
    assert st_.n_swaps == ref.n_swaps


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_cascade_dominates_greedy_and_half_opt(seed):
    inst = make_random_instance(seed, n_obj=5, k=(1, 1))
    g = greedy(inst)
    casc = greedy_then_localswap(inst)
    assert casc.cost(inst) <= inst.total_cost(g) + 1e-9
    assert inst.caching_gain(casc.slots) >= \
        0.5 * _best_gain(inst, 5, 2) - 1e-9
    jinst = make_random_instance(seed, JAX, n_obj=5, k=(1, 1))
    ref = jcascade(jinst)
    np.testing.assert_array_equal(casc.slots, ref.slots)
    assert abs(casc.cost(inst) - ref.cost(jinst)) < 1e-9


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_request_costs_bounded_and_monotone(seed):
    inst = make_random_instance(seed, n_obj=6, k=(2, 2))
    jinst = make_random_instance(seed, JAX, n_obj=6, k=(2, 2))
    rng = np.random.default_rng(seed)
    slots = random_slots(inst, rng)
    costs = inst.request_costs(slots)
    np.testing.assert_allclose(costs, jinst.request_costs(slots), rtol=0,
                               atol=1e-9)
    repo = inst.net.h_repo[:, None]
    assert np.all(costs <= repo + 1e-6)          # eq. (1): repo caps cost
    # adding an approximizer (filling an empty slot) never hurts anyone
    empty = np.where(slots < 0)[0]
    if empty.size:
        slots2 = slots.copy()
        slots2[empty[0]] = int(rng.integers(0, 6))
        assert np.all(inst.request_costs(slots2) <= costs + 1e-6)
