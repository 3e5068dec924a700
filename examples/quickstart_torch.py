"""Quickstart on the PyTorch port: the paper's content-placement problem
in 30 lines (twin of examples/quickstart.py).

Builds the §6.1 setup (grid catalog, Gaussian demand, tandem cache
network), solves placement with all four algorithms, and prints the
expected serving cost of each — reproducing the Fig. 3 ordering
(LocalSwap ≤ Greedy ≤ NetDuel, with the continuous approximation close).
All five are host NumPy oracles, as in the reference; the device is
resolved all the same (CUDA unless ``--device cpu``), like every twin's.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch._device import resolve_device
from repro_torch.core import catalog, demand, topology
from repro_torch.core.objective import Instance
from repro_torch.core.placement import (continuous, greedy, localswap,
                                        netduel, greedy_then_localswap)


def run(device=None) -> dict:
    """The example's body; returns what it prints."""
    resolve_device(device)
    L, k, h, h_repo = 30, 30, 2.0, 50.0
    cat = catalog.grid(L=L)                      # 900 objects, norm-1
    net = topology.tandem(k_leaf=k, k_parent=k, h=h, h_repo=h_repo)
    dem = demand.gaussian_grid(cat, sigma=L / 8)
    inst = Instance(net=net, cat=cat, dem=dem)
    print(f"catalog {cat.n} objects; caches {k}+{k}; "
          f"no-cache cost C(∅) = {inst.empty_cost():.3f}\n")

    slots = greedy(inst)
    c_greedy = inst.total_cost(slots)
    print(f"GREEDY              C(A) = {c_greedy:.4f}")
    st = localswap(inst, n_iters=8000)
    print(f"LOCALSWAP           C(A) = {st.cost(inst):.4f} "
          f"({st.n_swaps} swaps)")
    casc = greedy_then_localswap(inst)
    print(f"GREEDY→LOCALSWAP    C(A) = {casc.cost(inst):.4f}  (Remark 1)")
    nd = netduel(inst, n_iters=40000, window=1500, arm_prob=0.3)
    print(f"NETDUEL (online)    C(A) = {nd.sw.cost(inst):.4f} "
          f"({nd.n_promotions} promotions)")
    spec = continuous.ChainSpec(ks=(float(k), float(k)), hs=(0.0, h),
                                h_repo=h_repo, gamma=1.0)
    _, c_cont, _ = continuous.solve_chain_thresholds(inst.lam[0], spec)
    print(f"continuous (11)     C    = {c_cont:.4f}  (Prop 4.2 thresholds)")
    return {"empty": inst.empty_cost(), "greedy": c_greedy,
            "localswap": st.cost(inst), "n_swaps": st.n_swaps,
            "cascade": casc.cost(inst), "netduel": nd.sw.cost(inst),
            "n_promotions": nd.n_promotions, "continuous": c_cont}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    run(device=ap.parse_args().device)


if __name__ == "__main__":
    main()
