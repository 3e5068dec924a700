"""The NETDUEL duel scan between promotions and its re-arm: the
wrappers of kernel F's two entries.

Kernel F (``kernels/csrc/duel.cu``) replaces ``_duel_scan`` of
``repro/core/placement/netduel.py``, an XLA ``lax.scan`` over the
request window (no Pallas kernel). Its first entry,
``simcache_duel_scan``, walks the window's steps in order in one thread
block, the duel carry on chip, and gives control back at the first step
that promotes. That step's whole settle (the slot writes, the clears,
the arm) is done and its event is in the event buffers. Its second
entry, ``simcache_duel_rearm``, is the scan's ``rearm`` closure
(``netduel.py:254``): the pre-fold and serving best-two tables after the
slot writes, on the card, with no host sync. The host then launches the
steps again from the next one (core/placement/netduel.py). A window
without a promotion is one launch.

:func:`duel_scan_cuda` launches the steps for CUDA tensors and runs the
plain version, :func:`duel_steps_ref`, for CPU tensors: the same steps
in torch ops, updating the same tensors in place.
:func:`duel_rearm_cuda` launches the re-arm for CUDA tensors and runs
its plain version, :func:`duel_rearm_ref` (the incremental refresh
``best_two_delta`` or, past ``PROMOTE_CAP`` promotions, the full
rebuild, then the fold), for CPU tensors. Each wrapper's ``launches``
counts its kernel's launches and nothing else.

The arguments of the steps:

* ``tables`` — the serving tables (best1 f32, arg1 int64, best2 f32),
  each (I, O); read only.
* ``h_slots`` — (I, K) f32 retrieval cost of each slot's cache, +inf
  off the path.
* ``state`` — (slots, virt, real_sav, virt_sav, deadline, n_prom): (K,)
  int64, (K,) int64, (K,) f32, (K,) f32, (K,) int64 and a one-element
  int64; updated in place.
* ``xs`` — the window, a :class:`DuelXs`.
* ``out`` — (T,) f32, the served cost of each step (0 on a masked one).
* ``event`` — (promote (K,) bool, virt (K,) int64, real_sav, virt_sav
  (K,) f32): at a promoting step, each slot's promote flag and its duel
  before the clear.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.build import LIBRARY, check, stream_ptr
from repro_torch.kernels.knn.knn import _metric_id

# Slots a settle step may promote and still re-arm through the plain
# version's incremental refresh; more promotions at once take its full
# rebuild. The kernel's re-arm takes any number the same way.
PROMOTE_CAP = 8


class DuelXs(NamedTuple):
    """One window of requests: object, ingress and duel time of each
    step (int64), the arming flag (bool) and the slot draw (f32); the
    served cost from the fused lookup (f32, or None to read ``best1``)
    and the validity of each step (bool, or None: all valid)."""
    objs: torch.Tensor
    ings: torch.Tensor
    ts: torch.Tensor
    armf: torch.Tensor
    slotu: torch.Tensor
    b1_ext: torch.Tensor | None = None
    valid: torch.Tensor | None = None


def duel_steps_ref(coords, ca, metric: str, gamma: float, tables, h_slots,
                   state, xs: DuelXs, t_begin: int, one_delta: float,
                   window: int, out, event) -> int:
    """Plain version of kernel F: the steps from ``t_begin`` up to and
    including the first that promotes. Returns that step's index, or T
    when no step promoted. The f32 operations are the scan's: real
    saving best2 − b1 added at slot max(a1, 0) (0.0 on a repository hit
    or a masked step), virtual saving max(b1 − (C_a + h), 0), the settle
    vs > f32(1+δ)·rs and vs > 0, the pick ⌊f32(u)·f32(n_free)⌋."""
    from repro_torch.kernels.knn.gains import duel_virtual_costs
    best1, arg1, best2 = tables
    slots, virt, rs, vs, deadline, n_prom = state
    ev_promote, ev_virt, ev_rs, ev_vs = event
    has_ca = ca is not None
    on_path = torch.isfinite(h_slots)
    od = torch.tensor(one_delta, dtype=torch.float32, device=rs.device)
    zero = torch.zeros((), dtype=torch.float32, device=rs.device)
    T = xs.objs.shape[0]
    for s in range(t_begin, T):
        valid = xs.valid is None or bool(xs.valid[s])
        o, i, t = int(xs.objs[s]), int(xs.ings[s]), int(xs.ts[s])
        b1 = best1[i, o] if xs.b1_ext is None else xs.b1_ext[s]
        a1 = int(arg1[i, o])
        rs[max(a1, 0)] += best2[i, o] - b1 if valid and a1 >= 0 else zero
        armed = virt >= 0
        expired = torch.zeros_like(armed)
        if valid:
            vcost = duel_virtual_costs(coords, ca, o, virt.clamp_min(0),
                                       h_slots[i], metric, gamma, has_ca)
            vs.copy_(torch.where(armed, vs + (b1 - vcost).clamp_min(0.0),
                                 vs))
            expired = armed & (deadline <= t)
        promote = expired & (vs > od * rs) & (vs > 0.0)
        n_p = int(promote.sum())
        if n_p:
            ev_promote.copy_(promote)
            ev_virt.copy_(virt)
            ev_rs.copy_(rs)
            ev_vs.copy_(vs)
            slots.copy_(torch.where(promote, virt, slots))
            n_prom += n_p
        virt.masked_fill_(expired, -1)
        rs.masked_fill_(expired, 0.0)
        vs.masked_fill_(expired, 0.0)
        free = (virt < 0) & on_path[i]
        n_free = int(free.sum())
        if valid and bool(xs.armf[s]) and n_free:
            m = min(int(np.float32(float(xs.slotu[s])) * np.float32(n_free)),
                    n_free - 1)
            y = int(torch.nonzero(free)[m])
            virt[y] = o
            deadline[y] = t + window
            rs[y] = 0.0
            vs[y] = 0.0
        out[s] = b1 if valid else zero
        if n_p:
            return s
    return T


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_args(coords, ca, tables, h_slots, state, xs, out, event):
    """Refuse what kernel F does not take: every tensor on the coords'
    card, contiguous, of the dtype and shape the module docstring
    names."""
    dev = coords.device
    O, _ = coords.shape
    I, K = h_slots.shape
    T = xs.objs.shape[0]
    f32, i64, b8 = torch.float32, torch.int64, torch.bool
    want = [(coords, f32, (O, coords.shape[1])), (h_slots, f32, (I, K)),
            (tables[0], f32, (I, O)), (tables[1], i64, (I, O)),
            (tables[2], f32, (I, O)), (state[0], i64, (K,)),
            (state[1], i64, (K,)), (state[2], f32, (K,)),
            (state[3], f32, (K,)), (state[4], i64, (K,)),
            (state[5], i64, (1,)), (xs.objs, i64, (T,)),
            (xs.ings, i64, (T,)), (xs.ts, i64, (T,)), (xs.armf, b8, (T,)),
            (xs.slotu, f32, (T,)), (out, f32, (T,)),
            (event[0], b8, (K,)), (event[1], i64, (K,)),
            (event[2], f32, (K,)), (event[3], f32, (K,))]
    if ca is not None:
        want.append((ca, f32, (O, O)))
    if xs.b1_ext is not None:
        want.append((xs.b1_ext, f32, (T,)))
    if xs.valid is not None:
        want.append((xs.valid, b8, (T,)))
    for n, (t, dt, shape) in enumerate(want):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"kernel F argument {n}: want {dt} {shape} "
                             f"contiguous on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def duel_scan_cuda(coords, ca, metric: str, gamma: float, tables, h_slots,
                   state, xs: DuelXs, t_begin: int, one_delta: float,
                   window: int, out, event) -> int:
    """Kernel F: the steps from ``t_begin`` up to and including the first
    that promotes; returns that step's index, or T. One launch, then one
    read of the index (the host's only wait in a window)."""
    if not coords.is_cuda:
        return duel_steps_ref(coords, ca, metric, gamma, tables, h_slots,
                              state, xs, t_begin, one_delta, window, out,
                              event)
    _check_args(coords, ca, tables, h_slots, state, xs, out, event)
    O, D = coords.shape
    I, K = h_slots.shape
    T = xs.objs.shape[0]
    if not 0 <= t_begin < T:
        raise ValueError(f"kernel F: step {t_begin} outside [0, {T})")
    stop = torch.empty(1, dtype=torch.int32, device=coords.device)
    check(LIBRARY.fn("simcache_duel_scan")(
        coords.data_ptr(), _ptr(ca), O, D, _metric_id(metric), float(gamma),
        *(t.data_ptr() for t in tables), h_slots.data_ptr(), I, K,
        *(t.data_ptr() for t in state),
        *(t.data_ptr() for t in xs[:5]), _ptr(xs.b1_ext), _ptr(xs.valid),
        t_begin, T, float(one_delta), int(window), out.data_ptr(),
        *(t.data_ptr() for t in event), stop.data_ptr(),
        stream_ptr(coords)), "simcache_duel_scan")
    duel_scan_cuda.launches += 1
    return int(stop.item())


duel_scan_cuda.launches = 0


def duel_rearm_ref(pre, slots_new, promote, slot_cache, H, h_repo, coords,
                   ca, metric: str, gamma: float) -> tuple:
    """Plain version of the re-arm: the pre-fold tables (b1, a1, b2, a2)
    after a settle wrote the ``promote`` slots of ``slots_new``, by the
    incremental refresh (``objective.best_two_delta``, its dirty-row cap
    ``default_delta_cap``) when at most ``PROMOTE_CAP`` slots promoted,
    else by the full rebuild; then the serving tables (best1, arg1,
    best2) by the fold. Bitwise the full rebuild folded either way, and
    so bitwise a sharded instance's tables too."""
    from repro_torch.core.objective import (_best_two_rows_pre,
                                            best_two_delta,
                                            default_delta_cap,
                                            fold_best_two)
    has_ca = ca is not None
    K = promote.shape[0]
    ys = torch.nonzero(promote).reshape(-1)
    if ys.numel() > PROMOTE_CAP:
        npre = _best_two_rows_pre(
            ca if has_ca else coords,
            None if has_ca else coords[slots_new.clamp_min(0)],
            slots_new, slot_cache, H, metric, gamma, has_ca)
    else:
        ys = torch.cat([ys, ys.new_full((PROMOTE_CAP - ys.numel(),), K)])
        n_obj = (ca if has_ca else coords).shape[0]
        npre = best_two_delta(coords, ca, *pre, slots_new, ys, slot_cache,
                              H, metric, gamma, has_ca,
                              cap=default_delta_cap(n_obj))
    return (*npre, *fold_best_two(npre[0], npre[1], npre[2], h_repo))


def _check_rearm(pre, slots_new, promote, slot_cache, H, h_repo, coords, ca):
    """Refuse what the re-arm does not take (as :func:`_check_args`)."""
    dev = coords.device
    I, O = pre[0].shape
    K = slots_new.shape[0]
    f32, i64, b8 = torch.float32, torch.int64, torch.bool
    want = [(pre[0], f32, (I, O)), (pre[1], i64, (I, O)),
            (pre[2], f32, (I, O)), (pre[3], i64, (I, O)),
            (slots_new, i64, (K,)), (promote, b8, (K,)),
            (slot_cache, i64, (K,)), (H, f32, (I, H.shape[1])),
            (h_repo, f32, (I,))]
    want.append((ca, f32, (O, O)) if ca is not None
                else (coords, f32, (O, coords.shape[1])))
    for n, (t, dt, shape) in enumerate(want):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"re-arm argument {n}: want {dt} {shape} "
                             f"contiguous on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def duel_rearm_cuda(pre, slots_new, promote, slot_cache, H, h_repo, coords,
                    ca, metric: str, gamma: float) -> tuple:
    """Kernel F's second entry: the re-arm after a promoting step, one
    call, no host sync. Returns new tensors (b1, a1, b2, a2, best1,
    arg1, best2), bitwise :func:`duel_rearm_ref`'s for any number of
    promoted slots; the inputs are not written."""
    if not coords.is_cuda:
        return duel_rearm_ref(pre, slots_new, promote, slot_cache, H,
                              h_repo, coords, ca, metric, gamma)
    _check_rearm(pre, slots_new, promote, slot_cache, H, h_repo, coords, ca)
    I, O = pre[0].shape
    K, J, D = slots_new.shape[0], H.shape[1], coords.shape[1]
    dev = coords.device
    out = [torch.empty((I, O), dtype=t.dtype, device=dev)
           for t in (*pre, *pre[:3])]
    scratch = torch.empty(O + 1, dtype=torch.int32, device=dev)
    check(LIBRARY.fn("simcache_duel_rearm")(
        coords.data_ptr(), _ptr(ca), O, D, _metric_id(metric), float(gamma),
        *(t.data_ptr() for t in pre), slots_new.data_ptr(),
        promote.data_ptr(), slot_cache.data_ptr(), H.data_ptr(),
        h_repo.data_ptr(), I, K, J, *(t.data_ptr() for t in out),
        scratch.data_ptr(), stream_ptr(coords)), "simcache_duel_rearm")
    duel_rearm_cuda.launches += 1
    return tuple(out)


duel_rearm_cuda.launches = 0
