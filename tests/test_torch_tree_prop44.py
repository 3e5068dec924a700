"""Prop 4.4 checked in the discrete system, on the port, and held against
the JAX reference on the CPU. Mirrors tests/test_tree_prop44.py.

In an equi-depth tree with leaf-only arrivals and per-leaf rates
β_ℓ·λ(x), the continuous optimum replicates one chain solution at every
level. The discrete analogue: LOCALSWAP on the whole tree does not beat
the replicated chain solution by more than a small margin, and the
replicated solution's normalized cost does not depend on β.

The host solvers (``greedy_then_localswap``, ``localswap``) and the
threshold solver are NumPy copies of the reference's, so their costs
must equal the reference's bitwise. ``tree_cost`` through the f32
mirror descent matches the reference's within 1e-5 relative
(tests/test_torch_continuous.py).
"""
import numpy as np
import pytest

from repro.core import catalog as jcatalog
from repro.core import demand as jdemand
from repro.core import topology as jtopology
from repro.core.objective import Instance as JInstance
from repro.core.placement import continuous as jcont
from repro.core.placement import greedy_then_localswap as jcascade
from repro.core.placement import localswap as jlocalswap
from repro_torch.core import catalog, demand, topology
from repro_torch.core.objective import Instance
from repro_torch.core.placement import continuous as cont
from repro_torch.core.placement import greedy_then_localswap, localswap

PORT = (catalog, demand, topology, Instance, greedy_then_localswap,
        localswap)
JAX = (jcatalog, jdemand, jtopology, JInstance, jcascade, jlocalswap)


def build_tree_and_chain(api, L=16, k=8, h=2.0, h_repo=30.0,
                         betas=(1.0, 2.0)):
    cat_api, dem_api, top_api, inst_cls = api[:4]
    cat = cat_api.grid(L=L)
    base = dem_api.gaussian_grid(cat, sigma=L / 6).lam[0]
    tree = top_api.equi_depth_tree(
        branching=2, depth=1, k_per_level=[k, k], h_per_level=[0.0, h],
        h_repo=h_repo)
    lam_tree = np.stack([b * base for b in betas])
    inst_tree = inst_cls(net=tree, cat=cat,
                         dem=dem_api.Demand(lam=lam_tree / lam_tree.sum()))
    chain = top_api.tandem(k_leaf=k, k_parent=k, h=h, h_repo=h_repo)
    inst_chain = inst_cls(net=chain, cat=cat, dem=dem_api.Demand(
        lam=(base / base.sum())[None, :]))
    return inst_tree, inst_chain


def replicate_chain_solution(chain_slots, k):
    """chain slots [leaf | parent] → tree slots [leaf0 | leaf1 | root]."""
    leaf, parent = chain_slots[:k], chain_slots[k:]
    return np.concatenate([leaf, leaf, parent])


def _replicated_and_free(api):
    inst_tree, inst_chain = build_tree_and_chain(api)
    chain_sol = api[4](inst_chain, max_passes=8)
    c_rep = inst_tree.total_cost(replicate_chain_solution(chain_sol.slots,
                                                          8))
    c_free = api[5](inst_tree, n_iters=12000, seed=0).cost(inst_tree)
    return c_rep, c_free


def test_replicated_chain_is_near_optimal_on_tree():
    c_rep, c_free = _replicated_and_free(PORT)
    # free optimization may exploit discreteness a little, but Prop 4.4
    # says the replicated structure is the continuum optimum: ≤ ~10% gap
    assert c_rep <= c_free * 1.10, (c_rep, c_free)
    assert (c_rep, c_free) == _replicated_and_free(JAX)


def _normalized_costs(api):
    costs = {}
    for betas in ((1.0, 1.0), (1.0, 4.0)):
        inst_tree, inst_chain = build_tree_and_chain(api, betas=betas)
        chain_sol = api[4](inst_chain, max_passes=8)
        rep = replicate_chain_solution(chain_sol.slots, 8)
        costs[betas] = inst_tree.total_cost(rep) / inst_tree.empty_cost()
    return costs


def test_beta_scaling_preserves_allocation():
    """The replicated allocation's normalized cost is invariant to the
    per-leaf β (degree-1 homogeneity in λ), and is the reference's."""
    costs = _normalized_costs(PORT)
    assert abs(costs[(1.0, 1.0)] - costs[(1.0, 4.0)]) < 1e-6
    assert costs == _normalized_costs(JAX)


def test_tree_cost_homogeneous_in_lambda():
    """``tree_cost`` (continuous Prop 4.4) is degree-1 homogeneous in λ,
    for the threshold solver (~1e-6) and the f32 mirror descent (~2 %
    slack), and matches the reference's: bitwise through the thresholds,
    within 1e-5 through the descent."""
    rng = np.random.default_rng(4)
    lams = rng.gamma(2.0, 1.0, 30)
    betas = np.array([1.0, 0.5, 2.0])
    kw = dict(ks=(12.0, 24.0), hs=(0.0, 1.5), h_repo=6.0, gamma=1.0)
    spec, jspec = cont.ChainSpec(**kw), jcont.ChainSpec(**kw)
    for c_scale in (3.0, 0.25):
        c1 = cont.tree_cost(lams, betas, spec, use_thresholds=True)
        cs = cont.tree_cost(c_scale * lams, betas, spec,
                            use_thresholds=True)
        assert abs(cs - c_scale * c1) <= 1e-6 * c_scale * c1
        assert cs == jcont.tree_cost(c_scale * lams, betas, jspec)
    c1_md = cont.tree_cost(lams, betas, spec, use_thresholds=False,
                           device="cpu")
    c3_md = cont.tree_cost(3.0 * lams, betas, spec, use_thresholds=False,
                           device="cpu")
    assert abs(c3_md - 3.0 * c1_md) <= 2e-2 * 3.0 * c1_md
    assert c1_md == pytest.approx(
        jcont.tree_cost(lams, betas, jspec, use_thresholds=False), rel=1e-5)
