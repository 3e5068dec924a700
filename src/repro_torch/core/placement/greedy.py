"""GREEDY placement (paper §3.2).

Problem (4) is the maximization of a monotone non-negative submodular
function over a matroid (Prop 3.2), so GREEDY enjoys a 1/2 approximation
ratio [Fisher–Nemhauser–Wolsey '78]. Two implementations:

* ``lazy=True`` (default) — the accelerated/lazy greedy: marginal gains
  can only shrink as the allocation grows (submodularity), so a stale
  max-heap of gains only needs the popped candidate re-evaluated. This is
  the "smart implementation" the paper alludes to in §3.2 and reduces the
  practical complexity by orders of magnitude while returning the exact
  greedy solution.
* ``lazy=False`` — textbook greedy. Instead of recomputing all O·J
  gains from scratch every step (the paper's stated bound
  O_R·N·(O·N·K − K(K−1)/2)), the gain table is updated incrementally
  with ``Instance.add_gain_delta``: a pick only changes the gains
  through the requests whose serving cost it lowered (the same
  vectorized row update ``updated_costs`` applies to ``cur``), so each
  step costs O(changed·O·J). Used to validate the lazy variant — and
  the device control plane (core/placement/device.py) — in tests.

Both host paths are the *differential oracles* of the device
implementations; allocations are tie-broken to the lowest flat (o', j)
index everywhere.

Candidates are (object o', cache j) pairs; a candidate is feasible while
cache j still has a free slot (matroid/cardinality constraint).
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.objective import Instance, empty_slots


def greedy(inst: Instance, lazy: bool = True, verbose: bool = False,
           gain_tol: float = 1e-12) -> np.ndarray:
    """Run GREEDY to fill every slot; returns the allocation vector."""
    slots = empty_slots(inst)
    slot_cache = inst.slot_cache
    free = {j: list(np.where(slot_cache == j)[0][::-1])
            for j in range(inst.net.n_caches)}
    cur = np.repeat(inst.net.h_repo[:, None].astype(np.float64),
                    inst.cat.n, axis=1)                       # C(r, ∅)

    n_select = inst.net.total_slots
    if lazy:
        gains = inst.add_gain_all(cur)                        # (O, J)
        heap: list[tuple[float, int, int, int]] = []          # (-gain, ver, o, j)
        for j in range(inst.net.n_caches):
            if not np.isfinite(inst.net.H[:, j]).any():
                continue
            for o in range(inst.cat.n):
                if gains[o, j] > gain_tol:
                    heap.append((-float(gains[o, j]), 0, o, j))
        heapq.heapify(heap)
        version = 0
        picked = 0
        while picked < n_select and heap:
            negg, ver, o, j = heapq.heappop(heap)
            if not free[j]:
                continue
            if ver != version:                                # stale → refresh
                g = inst.add_gain_single(cur, o, j)
                if g <= gain_tol:
                    continue
                if heap and -g > heap[0][0]:                  # no longer top
                    heapq.heappush(heap, (-g, version, o, j))
                    continue
            # accept (o, j)
            s = free[j].pop()
            slots[s] = o
            cur = inst.updated_costs(cur, o, j)
            version += 1
            picked += 1
            if verbose and picked % 50 == 0:
                print(f"[greedy] {picked}/{n_select} cost="
                      f"{float(np.sum(inst.lam * cur)):.4f}")
    else:
        gains = inst.add_gain_all(cur)                        # once, O(O²·J)
        for picked in range(n_select):
            masked = gains.copy()
            for j in range(inst.net.n_caches):                # mask full caches
                if not free[j]:
                    masked[:, j] = -np.inf
            o, j = np.unravel_index(int(np.argmax(masked)), masked.shape)
            if masked[o, j] <= gain_tol:
                break                                         # no positive gain left
            s = free[j].pop()
            slots[s] = o
            new_cur = inst.updated_costs(cur, o, j)
            # incremental gain update: only requests whose cost dropped
            # contribute (satellite of the device refactor; exact up to
            # float association)
            gains += inst.add_gain_delta(cur, new_cur)
            cur = new_cur
    return slots
