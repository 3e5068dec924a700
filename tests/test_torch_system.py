"""Twins of two end-to-end tests of tests/test_system.py on the port, on
the CPU: the placement control plane feeding the runtime cache network,
and the cost ordering of the placement algorithms.

Tolerances: the offline C(A) and the empirical cost of the runtime
lookup agree to 1e-3 relative (the reference test's rule: an f64 sum of
f32 per-request costs against the f32 lookup's). Beside each port result
stands the reference's on the same instance: the host algorithms are
copied line for line, so the allocations are equal and the costs agree
to 1e-9 (f64 sums of the same terms).
"""
import numpy as np
import torch

from repro.core import catalog as jcatalog
from repro.core import demand as jdemand
from repro.core import topology as jtopology
from repro.core.objective import Instance as JInstance
from repro.core.placement import greedy as jgreedy
from repro.core.placement import greedy_then_localswap as jcascade
from repro.core.placement import localswap as jlocalswap
from repro_torch.core import catalog, demand, topology
from repro_torch.core.objective import Instance
from repro_torch.core.placement import (greedy, greedy_then_localswap,
                                        localswap)
from repro_torch.core.simcache import SimCacheNetwork


def _instances(L, k, h, h_repo, sigma):
    """The same instance in the port and in the reference."""
    out = []
    for cat_m, dem_m, top_m, inst_cls in (
            (catalog, demand, topology, Instance),
            (jcatalog, jdemand, jtopology, JInstance)):
        cat = cat_m.grid(L=L)
        net = top_m.tandem(k_leaf=k, k_parent=k, h=h, h_repo=h_repo)
        out.append(inst_cls(net=net, cat=cat,
                            dem=dem_m.gaussian_grid(cat, sigma=sigma)))
    return out


def test_placement_to_dataplane_roundtrip():
    """Offline C(A) == empirical cost of the runtime cache serving the
    full demand-weighted request set (eq. (2) both ways)."""
    inst, jinst = _instances(20, 12, 3.0, 25.0, 4.0)
    st = greedy_then_localswap(inst, max_passes=6)
    ref = jcascade(jinst, max_passes=6)
    np.testing.assert_array_equal(st.slots, ref.slots)
    offline = st.cost(inst)
    assert abs(offline - ref.cost(jinst)) < 1e-9
    sc = SimCacheNetwork.from_placement(
        inst.cat.coords, st.slots, inst.slot_cache, hs=[0.0, 3.0],
        h_repo=25.0, metric="l1", gamma=1.0, device="cpu")
    res = sc.lookup(torch.as_tensor(inst.cat.coords))
    empirical = float(np.sum(inst.dem.lam[0] * res.cost.numpy()))
    assert abs(empirical - offline) < 1e-3 * max(offline, 1.0)
    # and the allocation actually beats no cache
    assert offline < inst.empty_cost() * 0.25


def test_full_pipeline_cost_ordering():
    """Across algorithms, the end-to-end ordering of Fig 3 holds on a
    fresh instance (cascade ≤ greedy; localswap close)."""
    inst, jinst = _instances(16, 8, 2.0, 20.0, 3.0)
    g = greedy(inst)
    np.testing.assert_array_equal(g, jgreedy(jinst))
    c_greedy = inst.total_cost(g)
    ls = localswap(inst, n_iters=6000, seed=0)
    np.testing.assert_array_equal(
        ls.slots, jlocalswap(jinst, n_iters=6000, seed=0).slots)
    c_ls = ls.cost(inst)
    casc = greedy_then_localswap(inst, max_passes=6)
    np.testing.assert_array_equal(casc.slots,
                                  jcascade(jinst, max_passes=6).slots)
    c_casc = casc.cost(inst)
    assert c_casc <= c_greedy + 1e-9
    assert c_ls <= c_greedy * 1.05
