"""Device-resident GREEDY / LOCALSWAP (paper §3.2–3.3) on the batched
gain oracle.

Counterpart of ``repro.core.placement.device``. The NumPy implementations
in greedy.py / localswap.py stay as the differential oracles; the
functions here implement the *same decision rules* — lowest-(o', j) and
lowest-slot tie-breaks, the same accept thresholds compared in f32 —
with every O(O·J)-sized object (the gain table, the per-request cost
matrix, the swap deltas) on the card, over a
:class:`repro_torch.core.objective.DeviceInstance`.

* :func:`device_greedy` — batched lazy greedy. One full oracle launch
  (``DeviceInstance.gains``: kernel C when C_a streams, or with
  ``quantize`` the int8 lower-bound pass, whose seeds start stale) seeds
  an upper-bound table; each step re-evaluates the k highest stale entries
  in one batched ``gain_at`` until the argmax entry is fresh.
  ``torch.argmax`` keeps the first maximum, and the stale set is taken
  by a stable descending sort — ties at the k-th boundary go to the
  lowest index, as ``lax.top_k`` does — so the refreshed set, and with
  it every pick, is a deterministic function of the table.
  ``scan=True`` keeps the free-slot bookkeeping on the device and reads
  one pair of flags per step; ``scan=False`` keeps it on the host.
  Both take the same decisions. The reference's ``lax.while_loop``
  becomes a host-driven Python loop: one host synchronization per step.
* :func:`device_localswap` / :func:`device_localswap_polish` — the ΔC(y)
  sweep of localswap.py's best/second-best decomposition. An accepted
  swap re-arms the serving tables incrementally
  (``objective.best_two_delta``) when ``incremental``, else by a full
  rebuild. Trajectories are identical.
* :func:`device_greedy_then_localswap` — the Remark-1 cascade.

Every incremental op computes streamed distances with the shape-stable
form (core/costs.py), so a (request, candidate) pair has one f32 value
across all of them; the full oracle (kernel C) keeps the matmul form and
only seeds upper bounds.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.objective import (DeviceInstance, _apply_pick,
                                        _ca_column, _gain_at, fold_best_two)

GAIN_TOL = 1e-12        # matches the host greedy default
SWAP_TOL = 1e-6         # f32-safe LOCALSWAP acceptance threshold
DEFAULT_TOPK = 64


# ------------------------------------------------------------------ greedy
def _select_candidate(ub, fresh, col_open):
    """(argmax index, its masked value, its freshness) over open columns;
    ``torch.argmax`` keeps the first maximum → lowest flat (o', j)."""
    J = col_open.shape[0]
    mask = col_open.repeat(ub.shape[0] // J)
    masked = torch.where(mask, ub, -torch.inf)
    idx = torch.argmax(masked)
    return idx, masked[idx], fresh[idx]


def _refresh_topk(dinst: DeviceInstance, cur, ub, fresh, col_open, k: int):
    """Re-evaluate the k highest stale upper bounds in one batched oracle
    call (ties to the lowest index); closed columns are never
    refreshed."""
    J = col_open.shape[0]
    stale = col_open.repeat(ub.shape[0] // J) & ~fresh
    srt = torch.sort(torch.where(stale, ub, -torch.inf), descending=True,
                     stable=True)
    vals, idxs = srt.values[:k], srt.indices[:k]
    g = dinst.gain_at(cur, idxs // J, idxs % J)
    valid = vals > -torch.inf
    ub = ub.index_put((idxs,), torch.where(valid, g, ub[idxs]))
    fresh = fresh.index_put((idxs,), valid | fresh[idxs])
    return ub, fresh


def _slot_fill_tables(dinst: DeviceInstance):
    """(slots_by_cache (J, max_cap), cap (J,)): slot ids of each cache in
    ascending order — the fill order of the host paths' ``free[j].pop()``
    (descending list, popped from the end)."""
    slot_cache = dinst.host.slot_cache
    caps = dinst.host.net.capacities
    J = dinst.n_caches
    tbl = np.zeros((J, max(int(caps.max()), 1)), np.int64)
    for j in range(J):
        idx = np.where(slot_cache == j)[0]
        tbl[j, :idx.size] = idx
    dev = dinst.device
    return (torch.as_tensor(tbl, device=dev),
            torch.as_tensor(np.asarray(caps), dtype=torch.int64, device=dev))


def _greedy_device_loop(dinst, cur, ub, fresh, col_open, n_slots: int,
                        gain_tol: float, k: int) -> np.ndarray:
    """The GREEDY accept loop with its free-slot bookkeeping on the
    device: per step one read of (stop, fresh) to steer the loop."""
    dev = dinst.device
    J = col_open.shape[0]
    tbl, cap = _slot_fill_tables(dinst)
    fill = torch.zeros((J,), dtype=torch.int64, device=dev)
    slots = torch.full((n_slots,), -1, dtype=torch.int64, device=dev)
    tol = torch.tensor(gain_tol, dtype=torch.float32, device=dev)
    picked = 0
    while picked < n_slots:
        idx, val, is_fresh = _select_candidate(ub, fresh, col_open)
        stop, fr = torch.stack([val <= tol, is_fresh]).tolist()
        if stop:
            break
        if not fr:
            ub, fresh = _refresh_topk(dinst, cur, ub, fresh, col_open, k)
            continue
        o, j = idx // J, idx % J
        slots[tbl[j, fill[j]]] = o
        cur = dinst.apply_pick(cur, o, j)
        fresh = torch.zeros_like(fresh)
        fill[j] += 1
        col_open = col_open.index_put((j,), fill[j] < cap[j])
        picked += 1
    return slots.cpu().numpy()


def device_greedy(dinst: DeviceInstance, topk: int = DEFAULT_TOPK,
                  gain_tol: float = GAIN_TOL, scan: bool = True,
                  quantize: bool = False) -> np.ndarray:
    """Batched lazy GREEDY on the device gain oracle; returns the same
    allocation vector as ``greedy(inst)`` (slots left at −1 when no
    candidate has gain above ``gain_tol``).

    ``quantize=True`` seeds the upper-bound table from the int8
    lower-bound oracle instead of the exact one. Quantized gains are
    admissible upper bounds, so they enter the lazy loop marked stale:
    every accepted candidate is still re-scored exactly before it is
    accepted, which keeps the allocation bit-identical to the
    exact-seeded run."""
    O, J = dinst.n_objects, dinst.n_caches
    K = int(dinst.host.net.total_slots)
    slot_cache = dinst.host.slot_cache
    free = {j: list(np.where(slot_cache == j)[0][::-1]) for j in range(J)}

    cur = dinst.initial_costs()
    ub = dinst.gains(cur, quantize=quantize).float().reshape(-1)  # o·J + j
    # exact seeds are fresh; quantized seeds are stale upper bounds
    fresh = torch.full((O * J,), not quantize, dtype=torch.bool,
                       device=dinst.device)
    col_open = torch.tensor([bool(free[j]) for j in range(J)],
                            device=dinst.device)
    k = min(topk, O * J)
    gain_tol = float(np.float32(gain_tol))     # compared in f32 throughout
    if scan:
        return _greedy_device_loop(dinst, cur, ub, fresh, col_open, K,
                                   gain_tol, k)

    slots = np.full(K, -1, dtype=np.int64)
    for _ in range(K):
        while True:
            idx, val, is_fresh = _select_candidate(ub, fresh, col_open)
            if float(val) <= gain_tol:
                return slots                               # no gain left
            if bool(is_fresh):
                break
            ub, fresh = _refresh_topk(dinst, cur, ub, fresh, col_open, k)
        o, j = divmod(int(idx), J)
        s = free[j].pop()
        slots[s] = o
        cur = dinst.apply_pick(cur, o, j)
        fresh = torch.zeros_like(fresh)                    # all stale
        if not free[j]:
            col_open = col_open.index_put(
                (torch.tensor(j, device=dinst.device),),
                torch.tensor(False, device=dinst.device))
    return slots


# --------------------------------------------------------------- localswap
def _swap_deltas(dinst: DeviceInstance, best1, arg1, best2, obj: int,
                 ingress: int) -> torch.Tensor:
    """(K,) ΔC(y) of replacing slot y with ``obj`` for a request at
    ``ingress``, +inf off its forwarding path — the device mirror of
    localswap.swap_deltas."""
    coords, ca, metric, gamma, has_ca = dinst._ca_args()
    lam, H, slot_cache = dinst.lam, dinst.H, dinst.slot_cache
    col = _ca_column(coords, ca, obj, metric, gamma, has_ca)
    a = col[None, :, None] + H[:, None, :]                 # (I, O, J)
    min_ca = torch.minimum(best1[:, :, None], a)
    S = (lam[:, :, None] * (min_ca - best1[:, :, None])).sum(dim=(0, 1))
    K = slot_cache.shape[0]
    mask = arg1 >= 0
    yy = torch.where(mask, arg1, 0)
    j_of_y = slot_cache[yy]                                # (I, O)
    a_sel = a.gather(2, j_of_y[:, :, None])[:, :, 0]
    m_sel = min_ca.gather(2, j_of_y[:, :, None])[:, :, 0]
    corr = torch.where(mask, (torch.minimum(best2, a_sel) - m_sel) * lam,
                       0.0)
    # index_put with accumulate sorts its indices on CUDA: a fixed sum
    # order, unlike an atomic scatter-add
    delta = torch.zeros((K,), dtype=torch.float32, device=dinst.device)
    delta = delta.index_put((yy.reshape(-1),), corr.reshape(-1),
                            accumulate=True)
    delta = delta + S[slot_cache]
    on_path = torch.isfinite(H[ingress])[slot_cache]
    return torch.where(on_path, delta, torch.inf)


def _swap_argmin(dinst: DeviceInstance, best1, arg1, best2, obj: int,
                 ingress: int):
    """(argmin slot y, ΔC(y)) — :func:`_swap_deltas` + np.argmin's
    lowest-slot tie-break."""
    delta = _swap_deltas(dinst, best1, arg1, best2, obj, ingress)
    y = torch.argmin(delta)
    return y, delta[y]


@dataclasses.dataclass
class DeviceSwapState:
    """Device-resident twin of localswap.SwapState: the folded serving
    tables plus the pre-fold tables (b1p/a1p/b2p/a2p) that the
    incremental re-arm keys its dirty-row detection on."""
    slots: torch.Tensor                # (K,) object ids (no empties)
    best1: torch.Tensor                # (I, O)
    arg1: torch.Tensor                 # (I, O) best slot or −1
    best2: torch.Tensor                # (I, O)
    b1p: torch.Tensor                  # (I, O) pre-fold best
    a1p: torch.Tensor                  # (I, O) pre-fold best slot
    b2p: torch.Tensor                  # (I, O) pre-fold second best
    a2p: torch.Tensor                  # (I, O) pre-fold second-best slot
    n_swaps: int = 0

    @classmethod
    def init(cls, dinst: DeviceInstance, slots) -> "DeviceSwapState":
        slots = torch.as_tensor(np.asarray(slots), dtype=torch.int64,
                                device=dinst.device)
        b1p, a1p, b2p, a2p = dinst.best_two_tables(slots)
        b1, a1, b2 = fold_best_two(b1p, a1p, b2p, dinst.h_repo)
        return cls(slots=slots, best1=b1, arg1=a1, best2=b2,
                   b1p=b1p, a1p=a1p, b2p=b2p, a2p=a2p)

    def _set_pre(self, dinst: DeviceInstance, pre) -> None:
        self.b1p, self.a1p, self.b2p, self.a2p = pre
        self.best1, self.arg1, self.best2 = fold_best_two(
            self.b1p, self.a1p, self.b2p, dinst.h_repo)

    def refresh(self, dinst: DeviceInstance) -> None:
        self._set_pre(dinst, dinst.best_two_tables(self.slots))

    @property
    def slots_np(self) -> np.ndarray:
        return self.slots.cpu().numpy().astype(np.int64)


def _accepts(dy: torch.Tensor, tol: float) -> bool:
    """The f32 accept rule ΔC < −tol shared by every LOCALSWAP path."""
    return float(dy) < -float(np.float32(tol))


def _run_localswap_window(dinst: DeviceInstance, st: DeviceSwapState,
                          objs, ings, tol: float,
                          incremental: bool = True) -> None:
    """Advance ``st`` through one request window; an accepted swap
    re-arms the tables through ``best_two_delta`` (``incremental``) or a
    full rebuild — the same trajectory either way."""
    for o, i in zip(np.asarray(objs).tolist(), np.asarray(ings).tolist()):
        y, dy = _swap_argmin(dinst, st.best1, st.arg1, st.best2, o, i)
        if _accepts(dy, tol):
            st.slots = st.slots.index_put((y,), torch.tensor(
                o, dtype=torch.int64, device=dinst.device))
            if incremental:
                st._set_pre(dinst, dinst.best_two_delta(
                    st.b1p, st.a1p, st.b2p, st.a2p, st.slots, y[None]))
            else:
                st.refresh(dinst)
            st.n_swaps += 1


def device_localswap(dinst: DeviceInstance, n_iters: int = 20000,
                     seed: int = 0, slots0: np.ndarray | None = None,
                     requests: tuple[np.ndarray, np.ndarray] | None = None,
                     tol: float = SWAP_TOL,
                     incremental: bool = True) -> DeviceSwapState:
    """Off-line LOCALSWAP on the device, driven by the same host-sampled
    emulated request stream as ``localswap(inst, …)`` (same rng → same
    requests)."""
    from repro_torch.core.placement.localswap import emulated_stream
    _, slots, objs, ings = emulated_stream(dinst.host, n_iters, seed,
                                           slots0, requests)
    st = DeviceSwapState.init(dinst, slots)
    _run_localswap_window(dinst, st, objs, ings, tol,
                          incremental=incremental)
    return st


def device_localswap_polish(dinst: DeviceInstance, slots: np.ndarray,
                            max_passes: int = 50,
                            tol: float = SWAP_TOL,
                            incremental: bool = True) -> DeviceSwapState:
    """Deterministic LOCALSWAP sweep (localswap_polish's device twin):
    round-robin over all requested objects until a full pass makes no
    swap."""
    st = DeviceSwapState.init(dinst, slots)
    ings, objs = np.nonzero(dinst.host.lam > 0)
    for _ in range(max_passes):
        before = st.n_swaps
        _run_localswap_window(dinst, st, objs, ings, tol,
                              incremental=incremental)
        if st.n_swaps == before:
            break
    return st


def device_greedy_then_localswap(dinst: DeviceInstance,
                                 max_passes: int = 50,
                                 topk: int = DEFAULT_TOPK,
                                 scan: bool = True,
                                 tol: float = SWAP_TOL,
                                 timings: dict | None = None
                                 ) -> DeviceSwapState:
    """GREEDY → LOCALSWAP cascade (Remark 1) entirely on the device;
    ``scan`` selects the form of :func:`device_greedy`. ``timings``, when
    given, receives the seconds of each phase (``greedy_s``,
    ``polish_s``; each ends on a host read of its result)."""
    t0 = time.perf_counter()
    slots = device_greedy(dinst, topk=topk, scan=scan)
    t1 = time.perf_counter()
    if np.any(slots < 0):
        slots = slots.copy()
        slots[slots < 0] = 0
    st = device_localswap_polish(dinst, slots, max_passes=max_passes,
                                 tol=tol)
    if timings is not None:
        st.slots_np                      # the polish ends on this read
        timings.update(greedy_s=t1 - t0,
                       polish_s=time.perf_counter() - t1)
    return st
