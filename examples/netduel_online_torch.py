"""NETDUEL (§5) adapting online to a demand shift on the PyTorch port
(twin of examples/netduel_online.py) — the λ-unaware policy tracks a
moving Gaussian without ever being told the rates, on the device-resident
online control plane: each phase is one ``device_netduel`` over the whole
request window (kernel F on the card: the steps between promotions, and
the re-arm after each), benchmarked against the device-GREEDY offline
reference (at 900 objects the instance's C_a is materialized, and the
gains fold it in torch).

Phase 1 also replays the window through the host NumPy policy to show
the device scan reproduces it bit for bit.

  PYTHONPATH=src python examples/netduel_online_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import catalog, demand, topology
from repro_torch.core.objective import DeviceInstance, Instance
from repro_torch.core.placement import device_greedy, device_netduel, netduel


def offline_reference(inst: Instance, device) -> float:
    """λ-aware device-GREEDY cost — the offline yardstick (§3.2)."""
    slots = device_greedy(DeviceInstance.from_instance(inst, device=device))
    return inst.total_cost(np.where(slots < 0, 0, slots))


def run(n_requests: int = 40000, device=None) -> dict:
    """The example's body (a test passes fewer requests a phase);
    returns what it prints."""
    dev = resolve_device(device)
    L, k = 30, 40
    cat = catalog.grid(L=L)
    net = topology.tandem(k_leaf=k, k_parent=k, h=2.0, h_repo=50.0)

    # phase 1: demand centered bottom-left; phase 2: top-right
    base = cat.coords - cat.coords.min(0)
    d1 = np.exp(-np.abs(base - L * 0.25).sum(1) ** 2 / (2 * (L / 8) ** 2))
    d2 = np.exp(-np.abs(base - L * 0.75).sum(1) ** 2 / (2 * (L / 8) ** 2))
    dem1 = demand.Demand(lam=(d1 / d1.sum())[None, :])
    dem2 = demand.Demand(lam=(d2 / d2.sum())[None, :])
    inst1 = Instance(net=net, cat=cat, dem=dem1)
    inst2 = Instance(net=net, cat=cat, dem=dem2)
    dinst1 = DeviceInstance.from_instance(inst1, device=dev)
    dinst2 = DeviceInstance.from_instance(inst2, device=dev)

    rng = np.random.default_rng(0)
    objs1, ing1 = dem1.sample(n_requests, rng)
    objs2, ing2 = dem2.sample(n_requests, rng)

    st = device_netduel(dinst1, requests=(objs1, ing1), window=1200,
                        arm_prob=0.3, record_events=True)
    c1 = inst1.total_cost(st.slots)
    ref1 = offline_reference(inst1, dev)
    print(f"after phase 1: C(A | λ1) = {c1:.4f} "
          f"({st.n_promotions} promotions in one device scan; "
          f"offline device-GREEDY ref {ref1:.4f})")

    # the host policy replays the same window to the same state, bit
    # for bit — the scan is a port of the decisions, not of the spirit
    st_host = netduel(inst1, requests=(objs1, ing1), window=1200,
                      arm_prob=0.3)
    assert np.array_equal(st_host.sw.slots, st.slots)
    assert st_host.promotions == st.promotions
    print("host NumPy NETDUEL replay: identical promotion sequence "
          f"({len(st.promotions)} events) and final slots")

    st2 = device_netduel(dinst2, requests=(objs2, ing2), window=1200,
                         arm_prob=0.3, slots0=st.slots)
    ref2 = offline_reference(inst2, dev)
    c_old = inst2.total_cost(st.slots)
    print(f"right after shift: C(A_old | λ2) = {c_old:.4f}")
    c2 = inst2.total_cost(st2.slots)
    print(f"after adaptation:  C(A_new | λ2) = {c2:.4f} "
          f"({st2.n_promotions} promotions; "
          f"offline device-GREEDY ref {ref2:.4f})")
    assert c2 < c_old
    gap = c2 / ref2 - 1.0
    print(f"NetDuel recovered from the demand shift without knowing λ; "
          f"the device control plane prices its remaining gap to the "
          f"offline GREEDY reference at {100 * gap:.1f}%.")
    return {"c1": c1, "ref1": ref1, "c_old": c_old, "c2": c2, "ref2": ref2,
            "n_promotions1": st.n_promotions,
            "n_promotions2": st2.n_promotions}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    run(device=ap.parse_args().device)


if __name__ == "__main__":
    main()
