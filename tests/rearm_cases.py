"""Inputs of the NETDUEL re-arm (``duel_rearm_ref`` / ``duel_rearm_cuda``)
shared by tests/test_torch_duel_rearm.py (CPU, against the JAX reference)
and tests/test_torch_gpu.py (the kernel against its plain version on the
card). numpy and torch only: the card's tests import no JAX.

One layout of 3·``per`` slots (192 by default) over three caches, two
ingresses, each off the path of one cache (H = +inf there), an empty
slot (−1) and two slots holding the same object (exact ties). Sixteen slots hold far outliers,
witnesses of the outliers' own rows only, so promoting them dirties
few rows; the cases promote a mix:

* ``"1"``, ``"3"``, ``"8"``: one ordinary slot and the rest outliers, so
  the plain version takes the incremental refresh with some dirty rows,
  fewer than ``default_delta_cap``; in ``"3"`` a promoted slot takes the
  object another slot holds (a tie on insertion);
* ``"9"``: past ``PROMOTE_CAP``, the plain version's full rebuild;
* ``"dirty"``: four ordinary slots, more dirty rows than the cap;
* ``"20"``: twenty slots (more new columns than the kernel holds at once).
"""
from __future__ import annotations

import numpy as np
import torch

CASES = ("1", "3", "8", "9", "dirty")
N_OUTLIERS = 16


def rearm_case(metric: str, gamma: float, materialize: bool, case: str,
               device="cpu", n: int = 1500, dim: int = 4,
               integer: bool = True, seed: int = 0, per: int = 64) -> dict:
    """The re-arm's arguments on ``device`` and the case's promoted
    slots. Integer coordinates make every l1 and l2sq distance exact
    (the same bits in any summation order); ``integer=False`` draws
    them from a normal law. ``materialize`` passes an explicit C_a
    matrix (the matmul form, as a materialized instance has it)."""
    from repro_torch.core import costs
    from repro_torch.core.objective import _best_two_rows_pre
    rng = np.random.default_rng(seed)
    if integer:
        coords = rng.integers(0, 10, (n, dim)).astype(np.float32)
        coords[-N_OUTLIERS:] += 40.0
    else:
        coords = 3.0 * rng.standard_normal((n, dim)).astype(np.float32)
        coords[-N_OUTLIERS:] += 120.0
    J = 3
    K = J * per
    slot_cache = np.repeat(np.arange(J), per)
    H = np.array([[1.0, 4.0, np.inf], [np.inf, 2.0, 6.0]], np.float32)
    h_repo = np.array([9.0, 14.0], np.float32)
    slots = rng.integers(0, n - N_OUTLIERS, K)
    outlier_slots = np.arange(4, K, K // N_OUTLIERS)[:N_OUTLIERS]
    slots[outlier_slots] = n - N_OUTLIERS + np.arange(N_OUTLIERS)
    slots[5] = -1                                  # an empty slot
    slots[1] = slots[2]                            # two slots, one object
    ordinary = np.setdiff1d(np.arange(K), np.r_[outlier_slots, 5, 1])
    pick = {"1": 1, "3": 1, "8": 1, "9": 9, "dirty": 4, "20": 20}[case]
    n_out = {"1": 0, "3": 2, "8": 7, "9": 0, "dirty": 0, "20": 0}[case]
    if pick == 1:                                  # a witness of ingress 0
        ordinary = ordinary[ordinary < per]
    ys = np.sort(np.r_[rng.choice(ordinary, pick, replace=False),
                       outlier_slots[:n_out]])
    slots_new = slots.copy()
    slots_new[ys] = rng.integers(0, n - N_OUTLIERS, len(ys))
    if case == "3":                                # a tie on insertion
        slots_new[ys[-1]] = slots[ordinary[-1]]
    promote = np.zeros(K, bool)
    promote[ys] = True

    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    coords_t = torch.as_tensor(coords, **f32)
    ca = None
    if materialize:
        ca = costs.approx_cost(coords_t, coords_t, metric, gamma).contiguous()
    H_t = torch.as_tensor(H, **f32)
    slot_cache_t = torch.as_tensor(slot_cache, **i64)
    slots_t = torch.as_tensor(slots, **i64)
    pre = _best_two_rows_pre(ca if materialize else coords_t,
                             None if materialize
                             else coords_t[slots_t.clamp_min(0)],
                             slots_t, slot_cache_t, H_t, metric, gamma,
                             materialize)
    return dict(pre=tuple(t.contiguous() for t in pre),
                slots_new=torch.as_tensor(slots_new, **i64),
                promote=torch.as_tensor(promote, device=device),
                slot_cache=slot_cache_t, H=H_t,
                h_repo=torch.as_tensor(h_repo, **f32), coords=coords_t,
                ca=ca, metric=metric, gamma=gamma, ys=ys)


def rearm_args(c: dict) -> tuple:
    """The positional arguments of ``duel_rearm_ref`` / ``_cuda``."""
    return (c["pre"], c["slots_new"], c["promote"], c["slot_cache"], c["H"],
            c["h_repo"], c["coords"], c["ca"], c["metric"], c["gamma"])


def dirty_rows(c: dict) -> int:
    """Rows whose a1 or a2, at any ingress, is a promoted slot."""
    ys = torch.as_tensor(c["ys"], device=c["pre"][1].device)
    hit = torch.isin(c["pre"][1], ys) | torch.isin(c["pre"][3], ys)
    return int(hit.any(dim=0).sum())
