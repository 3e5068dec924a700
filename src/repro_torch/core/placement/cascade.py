"""Greedy → LocalSwap cascade (paper §3.3, Remark 1).

Running LOCALSWAP from the GREEDY solution yields a *locally optimal*
configuration whose gain still satisfies the 1/2 approximation bound:
LocalSwap only ever decreases C(A), hence only increases G(A), so
G(A_cascade) ≥ G(A_greedy) ≥ ½ · max_A G(A).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.objective import Instance
from repro_torch.core.placement.greedy import greedy
from repro_torch.core.placement.localswap import (_EPS, SwapState,
                                                  localswap_polish)


def greedy_then_localswap(inst: Instance, max_passes: int = 50,
                          lazy: bool = True, tol: float = _EPS) -> SwapState:
    slots = greedy(inst, lazy=lazy)
    # fill any slots greedy left empty (zero marginal gain) before polishing
    if np.any(slots < 0):
        slots = slots.copy()
        slots[slots < 0] = 0
    return localswap_polish(inst, slots, max_passes=max_passes, tol=tol)
