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

The rest of the reference suite's properties are left to the slice that
brings the LM scaffolding (ROADMAP item 16).
"""
import numpy as np
from hypothesis import given, settings, strategies as st

from repro.core import catalog as jcat
from repro.core import demand as jdem
from repro.core import topology as jtop
from repro.core.objective import DeviceInstance as JDevInst
from repro.core.objective import Instance as JInst
from repro.core.placement import device_localswap as jdevice_localswap
from repro.core.placement import device_netduel as jdevice_netduel
from repro_torch.core import catalog, demand, topology
from repro_torch.core.objective import DeviceInstance, Instance
from repro_torch.core.placement import device_localswap, device_netduel

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
