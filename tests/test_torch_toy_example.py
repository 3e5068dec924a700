"""Twin of tests/test_toy_example.py on the port: the paper's §3.4 toy
example, reproduced exactly with the port's host placement algorithms
(``repro_torch.core.placement``), on the CPU.

Five contents x1..x5 with C_a(x2,x3)=C_a(x3,x4)=0,
C_a(x1,x2)=C_a(x4,x5)=ε, all other pairs ∞ (costs symmetric).
λ3 > λ2 = λ4 > λ1 = λ5, repository cost h_s > 2ε.

The claims are the reference test's, checked on the port. Beside each
algorithm's result stands the reference's on the same instance: the port
copies the host algorithms and their emulated request stream line for
line, so GREEDY's and LOCALSWAP's allocations are equal and their costs
equal to 1e-9 (both sum the same f64 terms).
"""
import itertools

import numpy as np
import pytest

from repro.core import catalog as jcatalog
from repro.core import demand as jdemand
from repro.core import topology as jtopology
from repro.core.objective import Instance as JInstance
from repro.core.placement import greedy as jgreedy
from repro.core.placement import localswap as jlocalswap
from repro.core.placement import localswap_polish as jlocalswap_polish
from repro_torch.core import catalog, demand, topology
from repro_torch.core.objective import Instance
from repro_torch.core.placement import greedy, localswap, localswap_polish
from repro_torch.core.placement.localswap import is_locally_optimal

BIG = np.float32(1e9)   # stand-in for the paper's infinite cost
PORT = (catalog, demand, topology, Instance)
JAX = (jcatalog, jdemand, jtopology, JInstance)


def toy_ca(eps: float) -> np.ndarray:
    ca = np.full((5, 5), BIG, dtype=np.float32)
    np.fill_diagonal(ca, 0.0)
    for (i, j, v) in [(1, 2, 0.0), (2, 3, 0.0), (0, 1, eps), (3, 4, eps)]:
        ca[i, j] = ca[j, i] = v
    return ca


def make_instance(net_fn, lam_rows, eps, pkg=PORT):
    cat_m, dem_m, top_m, inst_cls = pkg
    cat = cat_m.Catalog(coords=np.zeros((5, 1), np.float32))
    lam = np.asarray(lam_rows, dtype=np.float64)
    return inst_cls(net=net_fn(top_m), cat=cat,
                    dem=dem_m.Demand(lam=lam / lam.sum()),
                    ca_matrix=toy_ca(eps))


def brute_force_best(inst):
    best, arg = np.inf, None
    K = inst.net.total_slots
    for combo in itertools.product(range(5), repeat=K):
        c = inst.total_cost(np.array(combo, dtype=np.int64))
        if c < best - 1e-12:
            best, arg = c, combo
    return best, arg


class _Toy:
    eps = 0.25
    lam = [[1.0, 4 / 3, 2.0, 4 / 3, 1.0]]

    def _net(self, top):
        raise NotImplementedError

    def _inst(self, pkg=PORT):
        return make_instance(self._net, self.lam, self.eps, pkg)

    def _greedy_pair(self):
        """The port's GREEDY, checked against the reference's."""
        slots = greedy(self._inst())
        np.testing.assert_array_equal(slots, jgreedy(self._inst(JAX)))
        return slots

    def _localswap_pair(self, n_iters, seed):
        st = localswap(self._inst(), n_iters=n_iters, seed=seed)
        ref = jlocalswap(self._inst(JAX), n_iters=n_iters, seed=seed)
        np.testing.assert_array_equal(st.slots, ref.slots)
        assert st.cost(self._inst()) == pytest.approx(
            ref.cost(self._inst(JAX)), abs=1e-9)
        return st


class TestSingleCache(_Toy):
    def _net(self, top):
        return top.single_cache(k=2, h_repo=1.0)  # h_s = 1 > 2ε

    def test_optimum_is_x2_x4(self):
        _, arg = brute_force_best(self._inst())
        assert sorted(arg) == [1, 3]

    def test_greedy_reaches_x3_plus_edge(self):
        slots = sorted(self._greedy_pair().tolist())
        assert slots in ([0, 2], [2, 4])

    def test_greedy_not_locally_optimal(self):
        inst = self._inst()
        assert not is_locally_optimal(inst, self._greedy_pair())

    def test_localswap_reaches_unique_local_optimum(self):
        st = self._localswap_pair(4000, 3)
        assert sorted(st.slots.tolist()) == [1, 3]
        assert is_locally_optimal(self._inst(), st.slots)

    def test_cost_ordering(self):
        inst = self._inst()
        g = inst.total_cost(self._greedy_pair())
        ls = self._localswap_pair(4000, 0).cost(inst)
        assert ls < g


class TestTandemSmallH(_Toy):
    """Tandem, h(1,2) small: optimal keeps the {x2,x4} structure split
    across the two caches; GREEDY still anchors on x3."""
    h12 = 0.05

    def _net(self, top):
        return top.tandem(k_leaf=1, k_parent=1, h=self.h12,
                          h_repo=1.0 + self.h12)

    def test_optimal_structure(self):
        _, arg = brute_force_best(self._inst())
        assert sorted(arg) == [1, 3]

    def test_greedy_keeps_x3_at_leaf(self):
        slots = self._greedy_pair()
        assert slots[0] == 2              # x3 at the leaf cache
        assert slots[1] in (0, 4)

    def test_localswap_reaches_optimum(self):
        st = self._localswap_pair(6000, 1)
        best, _ = brute_force_best(self._inst())
        assert st.cost(self._inst()) == pytest.approx(best, abs=1e-9)


class TestPaperNumericRegime(_Toy):
    """h_s=1, h(1,2)=ε=4/9, λ1=λ5=1, λ2=λ4=4/3, λ3=2 (> λ2): the paper
    states {(x3,1),(x1,2)}/{(x3,1),(x5,2)} are global minima while the
    {(x2/x4)} configurations are only local minima; GREEDY succeeds."""
    eps = 4.0 / 9.0

    def _net(self, top):
        return top.tandem(k_leaf=1, k_parent=1, h=self.eps,
                          h_repo=1.0 + self.eps)

    def test_global_minimum_is_x3_based(self):
        _, arg = brute_force_best(self._inst())
        assert arg[0] == 2 and arg[1] in (0, 4)

    def test_x2_x4_state_is_local_minimum(self):
        inst = self._inst()
        slots = np.array([3, 1], dtype=np.int64)      # (x4 leaf, x2 parent)
        assert is_locally_optimal(inst, slots)
        best, _ = brute_force_best(inst)
        assert inst.total_cost(slots) > best + 1e-6   # ...but not global

    def test_greedy_finds_global(self):
        inst = self._inst()
        best, _ = brute_force_best(inst)
        assert inst.total_cost(self._greedy_pair()) == \
            pytest.approx(best, abs=1e-9)

    def test_localswap_can_stick_at_local_minimum(self):
        start = np.array([3, 1], dtype=np.int64)
        st = localswap_polish(self._inst(), start.copy())
        ref = jlocalswap_polish(self._inst(JAX), start.copy())
        # started at the local min, polish must not escape (a fixed point)
        assert sorted(st.slots.tolist()) == [1, 3]
        assert st.n_swaps == 0 == ref.n_swaps
        np.testing.assert_array_equal(st.slots, ref.slots)
