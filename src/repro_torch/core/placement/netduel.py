"""NETDUEL — online, λ-unaware dynamic policy (paper §5).

Networked extension of DUEL [12]: each *real* cached object is paired
with a *virtual* competitor (metadata only, drawn from the arrival
process). Over an observation window we accumulate, per duel, the cost
saving each contender produces:

* real object in slot y:    saving_r = C(r, A \\ {y}) − C(r, A)
  (positive only for requests whose best approximizer is y; equals
  best2 − best1 for those requests);
* virtual object v at cache j(y): saving_r = max(0, C(r, A) − C_a(o, v)
  − h(i, j(y))) — the cost reduction v *would* have produced.

At the end of the window the virtual replaces the real iff its
accumulated saving exceeds the real's by a relative margin δ; otherwise
it is discarded and the slot is re-armed with a fresh virtual object
taken later from the arrival stream. The policy needs no knowledge of λ.

Counterpart of ``repro.core.placement.netduel``, with its bit-exact
contract between the host policy and the device scan:

* :func:`netduel` — the host NumPy policy. All duel bookkeeping (the
  savings, the δ-margin settle test, the armed-slot pick) is float32
  with the same elementary operations in the same order as the scan,
  and every random draw is taken up front (``_duel_draws``), so a
  trajectory is a function of (requests, draws) alone.
* :func:`device_netduel` — the scan over the whole request window on a
  :class:`~repro_torch.core.objective.DeviceInstance`. The carry
  (slots, the pre-fold and serving best-two tables, virtual ids, f32
  savings, deadlines, the promotion count) lives on the device. On CUDA
  tensors the steps between two promotions are one launch of kernel F
  (kernels/duel/duel.py); the host re-arms the tables after each
  promoting step and launches again from the next one. On CPU tensors
  it runs :func:`_duel_scan_ref`, the plain version: the reference's
  scan step in torch ops, one step at a time.
* :class:`DuelPlane` — the scan for the serving engine
  (serve/engine.py, ``EngineConfig.netduel``): the carry persists
  across ``serve()`` batches, each batch observed in one scan, priced
  by the costs the fused lookup just computed (``b1_ext``).

A promotion re-arms the tables (``_rearm``). Through kernel F the
incremental re-arm is F's second entry (``duel_rearm_cuda``), any
number of promoted slots in one launch, on a sharded
``DeviceInstance`` (``mesh``, ``axes``) as on an unsharded one. The
plain scan takes its plain version: ``best_two_delta`` when at most
``PROMOTE_CAP`` slots promote at once, else a full rebuild. All give
the full rebuild's bits, which a sharded instance's tables are too
(``objective.sharded_best_two_tables`` shards the request axis of the
initial tables and of ``incremental=False``'s full rebuild, as the
reference's does; the scan and the re-arm stay unsharded, as there).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.objective import (DeviceInstance, Instance,
                                        fold_best_two)
from repro_torch.core.placement.localswap import SwapState, emulated_stream
from repro_torch.kernels.duel.duel import (PROMOTE_CAP, DuelXs,
                                          duel_rearm_cuda, duel_rearm_ref,
                                          duel_scan_cuda)
from repro_torch.kernels.knn.gains import duel_virtual_costs

F32_ZERO = np.float32(0.0)


def _duel_draws(rng: np.random.Generator, n: int):
    """All randomness NETDUEL consumes, drawn up front: per-request
    arming coin flips and armed-slot picks. A draw order that does not
    depend on the data is what lets the device scan replay the host
    policy bit for bit."""
    return rng.random(n), rng.random(n)


@dataclasses.dataclass
class DuelState:
    sw: SwapState                       # reuse best1/arg1/best2 bookkeeping
    virt: np.ndarray                    # (K,) virtual object id or −1
    real_sav: np.ndarray                # (K,) f32 accumulated real savings
    virt_sav: np.ndarray                # (K,) f32
    deadline: np.ndarray                # (K,) request-count when duel ends
    n_promotions: int = 0
    served_cost: float = 0.0
    n_served: int = 0
    promotions: list = dataclasses.field(default_factory=list)
    # promotions: (t, slot, new_obj, real_sav, virt_sav) per event


def netduel(inst: Instance, n_iters: int = 200000, seed: int = 0,
            window: int = 2000, delta: float = 0.05, arm_prob: float = 0.25,
            slots0: np.ndarray | None = None,
            requests: tuple[np.ndarray, np.ndarray] | None = None,
            record_every: int = 0) -> DuelState:
    """Run NETDUEL over a request stream; returns the final state.

    ``delta`` is the relative winning margin: promote iff
    virt_sav > (1+δ)·real_sav. ``window`` is the duel length in requests.
    Duel arithmetic is float32 end to end (savings accumulation, the
    settle comparison ``virt_sav > f32(1+δ)·real_sav``, the armed-slot
    pick ``⌊f32(u)·f32(n_free)⌋``), each operation mirroring the device
    scan of :func:`device_netduel`.
    """
    rng, slots, objs, ings = emulated_stream(inst, n_iters, seed, slots0,
                                             requests)
    K = slots.shape[0]
    st = DuelState(
        sw=SwapState.init(inst, slots),
        virt=np.full(K, -1, dtype=np.int64),
        real_sav=np.zeros(K, dtype=np.float32),
        virt_sav=np.zeros(K, dtype=np.float32),
        deadline=np.zeros(K, dtype=np.int64))
    arm_draws, slot_draws = _duel_draws(rng, len(objs))

    H, ca = inst.net.H, inst.ca
    h_slots = H[:, inst.slot_cache]                  # (I, K) f32, +inf off-path
    on_path = np.isfinite(h_slots)                   # (I, K)
    one_delta = np.float32(1.0 + delta)
    for t in range(len(objs)):
        o, i = int(objs[t]), int(ings[t])
        b1 = st.sw.best1[i, o]                       # np.float32 scalar
        a1 = int(st.sw.arg1[i, o])
        st.served_cost += float(b1)
        st.n_served += 1

        # -- real savings: only the best slot saves anything for r
        if a1 >= 0:
            st.real_sav[a1] += st.sw.best2[i, o] - b1

        # -- virtual savings for every armed duel on the path of i
        armed = st.virt >= 0
        vcost = ca[o, np.maximum(st.virt, 0)] + h_slots[i]
        st.virt_sav = np.where(
            armed, st.virt_sav + np.maximum(b1 - vcost, F32_ZERO),
            st.virt_sav)

        # -- settle expired duels
        expired = armed & (st.deadline <= t)
        if expired.any():
            promote = expired & (st.virt_sav > one_delta * st.real_sav) \
                & (st.virt_sav > 0.0)
            if promote.any():
                for y in np.nonzero(promote)[0]:
                    st.promotions.append(
                        (t, int(y), int(st.virt[y]),
                         float(st.real_sav[y]), float(st.virt_sav[y])))
                st.sw.slots[promote] = st.virt[promote]
                st.sw.refresh(inst)
                st.n_promotions += int(promote.sum())
            st.virt[expired] = -1
            st.real_sav[expired] = 0.0
            st.virt_sav[expired] = 0.0

        # -- arm a new duel: pair this request's object with a uniformly
        #    random free slot on the path of i
        if arm_draws[t] < arm_prob:
            free = (st.virt < 0) & on_path[i]
            n_free = int(free.sum())
            if n_free:
                m = min(int(np.float32(slot_draws[t]) * np.float32(n_free)),
                        n_free - 1)
                y = int(np.nonzero(free)[0][m])
                st.virt[y] = o
                st.deadline[y] = t + window
                st.real_sav[y] = st.virt_sav[y] = 0.0

        if record_every and t % record_every == 0:
            st.sw.cost_trace.append(st.sw.cost(inst))
    return st


# ==================================================================== device
@dataclasses.dataclass
class DeviceDuelState:
    """Final state of a device NETDUEL run (host-side copy of the scan
    carry, plus the traces the scan emitted)."""
    slots: np.ndarray                   # (K,) final allocation
    virt: np.ndarray                    # (K,) armed virtual ids or −1
    real_sav: np.ndarray                # (K,) f32
    virt_sav: np.ndarray                # (K,) f32
    deadline: np.ndarray                # (K,)
    n_promotions: int
    served_cost: float
    n_served: int
    promotions: list                    # (t, slot, new_obj, real, virt)
    b1_trace: np.ndarray                # (T,) f32 per-request served cost
    cost_trace: list


class DuelCarry(NamedTuple):
    """The scan carry: the allocation, the pre-fold best-two tables (the
    witnesses the incremental re-arm keys on), the serving tables, and
    the duels."""
    slots: torch.Tensor                 # (K,) int64
    b1p: torch.Tensor                   # (I, O) f32, pre-fold
    a1p: torch.Tensor                   # (I, O) int64
    b2p: torch.Tensor
    a2p: torch.Tensor
    best1: torch.Tensor                 # (I, O) serving tables
    arg1: torch.Tensor
    best2: torch.Tensor
    virt: torch.Tensor                  # (K,) int64, −1 unarmed
    real_sav: torch.Tensor              # (K,) f32
    virt_sav: torch.Tensor              # (K,) f32
    deadline: torch.Tensor              # (K,) int64
    n_prom: torch.Tensor                # (1,) int64


def _duel_carry(dinst: DeviceInstance, slots: np.ndarray) -> DuelCarry:
    """Initial scan carry from a host allocation vector."""
    slots_d = torch.as_tensor(np.asarray(slots), dtype=torch.int64,
                              device=dinst.device)
    b1p, a1p, b2p, a2p = dinst.best_two_tables(slots_d)
    b1, a1, b2 = fold_best_two(b1p, a1p, b2p, dinst.h_repo)
    K = slots_d.shape[0]
    dev = dinst.device
    return DuelCarry(slots_d.clone(), b1p, a1p, b2p, a2p, b1, a1, b2,
                     torch.full((K,), -1, dtype=torch.int64, device=dev),
                     torch.zeros((K,), dtype=torch.float32, device=dev),
                     torch.zeros((K,), dtype=torch.float32, device=dev),
                     torch.zeros((K,), dtype=torch.int64, device=dev),
                     torch.zeros((1,), dtype=torch.int64, device=dev))


def _rearm(dinst: DeviceInstance, slots_new: torch.Tensor,
           promote: torch.Tensor, pre: tuple, incremental: bool,
           kernel: bool = False) -> tuple:
    """Pre-fold and serving tables after a settle wrote ``promote``:
    the incremental re-arm, through kernel F's second entry (``kernel``)
    or its plain version; with ``incremental=False`` the full rebuild
    (request-axis sharded when the instance shards). Bitwise the same
    tables every way, sharded or not."""
    if not incremental:
        npre = dinst.best_two_tables(slots_new)
        return (*npre, *fold_best_two(npre[0], npre[1], npre[2],
                                      dinst.h_repo))
    coords, ca, metric, gamma, _ = dinst._ca_args()
    args = (pre, slots_new, promote, dinst.slot_cache, dinst.H,
            dinst.h_repo, coords, ca, metric, gamma)
    return (duel_rearm_cuda if kernel else duel_rearm_ref)(*args)


class ScanOut(NamedTuple):
    """What a scan emits: the served cost of each step (0 on a masked
    one), the cost-trace value of each step (``record_every``: C(A) at
    steps with t % record_every == 0, else −1; None when off), and the
    promoting steps' events (step, promote, virt, real_sav, virt_sav)."""
    b1: torch.Tensor
    cost: np.ndarray | None
    events: list


def _duel_scan_ref(dinst: DeviceInstance, h_slots, on_path,
                   carry: DuelCarry, xs: DuelXs, one_delta: float,
                   window: int, record_events: bool, external_b1: bool,
                   record_every: int, masked: bool = False,
                   incremental: bool = True) -> tuple[DuelCarry, ScanOut]:
    """Plain version of the scan: the reference's step
    (``repro.core.placement.netduel._duel_scan``) in torch ops, one step
    at a time. It is what kernel F is held against, and what CPU tensors
    run. ``masked`` reads ``xs.valid``: an invalid step is a complete
    no-op (no savings, settle, arming or promotion; cost 0).
    ``external_b1`` prices each step with ``xs.b1_ext`` in place of the
    serving table."""
    coords, ca, metric, gamma, has_ca = dinst._ca_args()
    (slots, b1p, a1p, b2p, a2p, best1, arg1, best2,
     virt, rs, vs, deadline, n_prom) = carry
    dev = dinst.device
    od = torch.tensor(one_delta, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ts_host = xs.ts.cpu().numpy()
    b1_out, cost_out, events = [], [], []
    for s in range(xs.objs.shape[0]):
        valid = xs.valid[s] if masked else torch.ones((), dtype=torch.bool,
                                                      device=dev)
        o, i, t = xs.objs[s], xs.ings[s], xs.ts[s]
        b1 = xs.b1_ext[s] if external_b1 else best1[i, o]
        a1 = arg1[i, o]

        # real saving — scatter to the winning slot (no-op for repo hits)
        rs = rs.index_add(0, a1.clamp_min(0).reshape(1), torch.where(
            valid & (a1 >= 0), best2[i, o] - b1, zero).reshape(1))

        # virtual savings — the gain-machinery pricing row
        armed = virt >= 0
        vcost = duel_virtual_costs(coords, ca, o, virt.clamp_min(0),
                                   h_slots[i], metric, gamma, has_ca)
        vs = torch.where(valid & armed, vs + (b1 - vcost).clamp_min(0.0),
                         vs)

        # settle expired duels
        expired = valid & armed & (deadline <= t)
        promote = expired & (vs > od * rs) & (vs > 0.0)
        any_p = bool(promote.any())
        slots = torch.where(promote, virt, slots)
        if any_p:
            b1p, a1p, b2p, a2p, best1, arg1, best2 = _rearm(
                dinst, slots, promote, (b1p, a1p, b2p, a2p), incremental)
        n_prom = n_prom + promote.sum()
        if record_events and any_p:
            events.append((s, promote, virt, rs, vs))
        virt = torch.where(expired, -1, virt)
        rs = torch.where(expired, zero, rs)
        vs = torch.where(expired, zero, vs)

        # arm a new duel on a uniformly random free on-path slot
        free = (virt < 0) & on_path[i]
        n_free = free.sum()
        arm = valid & xs.armf[s] & (n_free > 0)
        m = torch.minimum((xs.slotu[s] * n_free.to(torch.float32))
                          .to(torch.int64), n_free - 1)
        y_arm = ((torch.cumsum(free, 0) - 1) == m) & free & arm
        virt = torch.where(y_arm, o, virt)
        deadline = torch.where(y_arm, t + window, deadline)
        rs = torch.where(y_arm, zero, rs)
        vs = torch.where(y_arm, zero, vs)

        b1_out.append(torch.where(valid, b1, zero))
        if record_every:
            cost_out.append(float((dinst.lam * best1).sum())
                            if ts_host[s] % record_every == 0 else -1.0)
    carry = DuelCarry(slots, b1p, a1p, b2p, a2p, best1, arg1, best2,
                      virt, rs, vs, deadline, n_prom)
    b1 = torch.stack(b1_out) if b1_out else torch.zeros(
        0, dtype=torch.float32, device=dev)
    return carry, ScanOut(b1, np.asarray(cost_out) if record_every
                          else None, events)


def _duel_scan_kernel(dinst: DeviceInstance, h_slots, carry: DuelCarry,
                      xs: DuelXs, one_delta: float, window: int,
                      record_events: bool, record_every: int,
                      incremental: bool = True,
                      timings: dict | None = None
                      ) -> tuple[DuelCarry, ScanOut]:
    """The scan through kernel F: one launch runs the steps up to the
    next promotion and settles it; the re-arm (:func:`_rearm`, F's
    second entry) follows on the same stream, and the steps launch again
    from the step after. The re-arm of step t reads only the slots, the
    promote flags and the pre-fold tables, which nothing after step t's
    slot writes changes, and step t + 1 runs after it: the reference's
    order. A promotion costs one launch of the steps, one read of the
    stopping step and one launch of the re-arm; nothing else waits for
    the card, apart from ``record_every``'s C(A) and ``timings``. The
    cost trace is C(A) once per table version, at the record points
    where that version served. ``timings`` (a dict) receives the
    re-arms' seconds (``rearm_s``, the device synchronized around each)
    and their count."""
    coords, ca, metric, gamma, _ = dinst._ca_args()
    (slots, b1p, a1p, b2p, a2p, best1, arg1, best2,
     virt, rs, vs, deadline, n_prom) = carry
    # the duels, updated in place by F: copies, so the caller's carry
    # stays what it was
    state = tuple(x.clone() for x in (slots, virt, rs, vs, deadline,
                                      n_prom))
    K, T, dev = slots.shape[0], xs.objs.shape[0], dinst.device
    out = torch.zeros(T, dtype=torch.float32, device=dev)
    event = (torch.zeros(K, dtype=torch.bool, device=dev),
             torch.zeros(K, dtype=torch.int64, device=dev),
             torch.zeros(K, dtype=torch.float32, device=dev),
             torch.zeros(K, dtype=torch.float32, device=dev))
    pre, tables = (b1p, a1p, b2p, a2p), (best1, arg1, best2)
    versions = [(0, float((dinst.lam * best1).sum()))] if record_every \
        else []
    events = []
    s = 0
    while s < T:
        stop = duel_scan_cuda(coords, ca, metric, gamma, tables, h_slots,
                              state, xs, s, one_delta, window, out, event)
        if stop >= T:
            break
        if record_events:
            events.append((stop, *(e.clone() for e in event)))
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        new = _rearm(dinst, state[0], event[0], pre, incremental,
                     kernel=True)
        pre, tables = new[:4], new[4:]
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings["rearm_s"] = timings.get("rearm_s", 0.0) + \
                time.perf_counter() - t0
            timings["rearms"] = timings.get("rearms", 0) + 1
        if record_every:
            versions.append((stop, float((dinst.lam * tables[0]).sum())))
        s = stop + 1
    cost = None
    if record_every:
        ts_host = xs.ts.cpu().numpy()
        starts = np.asarray([v[0] for v in versions])
        vals = np.asarray([v[1] for v in versions])
        live = vals[np.searchsorted(starts, np.arange(T), side="right") - 1]
        cost = np.where(ts_host % record_every == 0, live, -1.0)
    slots, virt, rs, vs, deadline, n_prom = state
    return (DuelCarry(slots, *pre, *tables, virt, rs, vs, deadline, n_prom),
            ScanOut(out, cost, events))


def _duel_scan(dinst: DeviceInstance, h_slots, on_path, carry: DuelCarry,
               xs: DuelXs, one_delta: float, window: int,
               record_events: bool, external_b1: bool, record_every: int,
               masked: bool = False, incremental: bool = True,
               kernel: bool | None = None, timings: dict | None = None
               ) -> tuple[DuelCarry, ScanOut]:
    """One scan over a request window: through kernel F (``kernel``,
    the default on CUDA tensors) or the plain version (the default on
    CPU tensors). Both read ``xs.b1_ext`` only with ``external_b1`` and
    ``xs.valid`` only with ``masked``."""
    if kernel is None:
        kernel = dinst.device.type == "cuda"
    if kernel:
        xs = xs._replace(b1_ext=xs.b1_ext if external_b1 else None,
                         valid=xs.valid if masked else None)
        return _duel_scan_kernel(dinst, h_slots, carry, xs, one_delta,
                                 window, record_events, record_every,
                                 incremental, timings)
    return _duel_scan_ref(dinst, h_slots, on_path, carry, xs, one_delta,
                          window, record_events, external_b1, record_every,
                          masked, incremental)


def _duel_xs(objs, ings, t0, arm_flags, slot_draws, b1_ext=None,
             valid=None, device="cpu") -> DuelXs:
    """Scan inputs on ``device``. ``valid`` (bool mask) adds the
    bucketing validity flag; invalid rows reuse the last valid row's
    ``t``, so the duel timeline only advances with real requests
    (deadlines are measured in served requests, not in padded steps)."""
    n = len(objs)
    if valid is None:
        ts = np.arange(t0, t0 + n, dtype=np.int64)
    else:
        valid = np.asarray(valid, bool)
        ts = (t0 + np.maximum(np.cumsum(valid) - 1, 0)).astype(np.int64)
    i64 = dict(dtype=torch.int64, device=device)
    return DuelXs(
        torch.as_tensor(np.asarray(objs), **i64),
        torch.as_tensor(np.asarray(ings), **i64),
        torch.as_tensor(ts, **i64),
        torch.as_tensor(np.asarray(arm_flags, bool), device=device),
        torch.as_tensor(np.asarray(slot_draws, np.float32), device=device),
        None if b1_ext is None else torch.as_tensor(
            b1_ext, dtype=torch.float32, device=device).contiguous(),
        None if valid is None else torch.as_tensor(valid, device=device))


def _scan_args(dinst: DeviceInstance):
    """(h_slots, on_path): each slot's retrieval cost from each ingress
    (+inf off the path), and where it is finite."""
    h_slots = dinst.H[:, dinst.slot_cache].contiguous()
    return h_slots, torch.isfinite(h_slots)


def _events_from_trace(events: list, t0: int = 0) -> list:
    """Host-side unpack of the recorded settle tensors into the event
    list the host policy appends: (t, slot, new_obj, real_sav, virt_sav),
    slots in ascending order within a step."""
    out = []
    for s, promote, virt, rs, vs in events:
        promote, virt = promote.cpu().numpy(), virt.cpu().numpy()
        rs, vs = rs.cpu().numpy(), vs.cpu().numpy()
        for y in np.nonzero(promote)[0]:
            out.append((int(s) + t0, int(y), int(virt[y]), float(rs[y]),
                        float(vs[y])))
    return out


def device_netduel(dinst: DeviceInstance, n_iters: int = 200000,
                   seed: int = 0, window: int = 2000, delta: float = 0.05,
                   arm_prob: float = 0.25,
                   slots0: np.ndarray | None = None,
                   requests: tuple[np.ndarray, np.ndarray] | None = None,
                   record_every: int = 0,
                   record_events: bool = False,
                   incremental: bool = True,
                   plain: bool = False) -> DeviceDuelState:
    """NETDUEL as one scan on the device: the rng consumption of
    :func:`netduel` (same seed → same start slots, requests and draws)
    and its duel decisions bit for bit on materialized-C_a instances.

    ``record_events`` keeps each promoting step's settle state, from
    which the promotion-event list is rebuilt. ``plain`` runs the plain
    scan even on CUDA tensors (what kernel F is held against on the
    card)."""
    rng, slots, objs, ings = emulated_stream(dinst.host, n_iters, seed,
                                             slots0, requests)
    arm_draws, slot_draws = _duel_draws(rng, len(objs))
    arm_flags = arm_draws < arm_prob                 # exact f64 compare

    h_slots, on_path = _scan_args(dinst)
    carry = _duel_carry(dinst, slots)
    xs = _duel_xs(objs, ings, 0, arm_flags, slot_draws, device=dinst.device)
    carry, out = _duel_scan(
        dinst, h_slots, on_path, carry, xs, float(np.float32(1.0 + delta)),
        int(window), record_events, False, record_every,
        incremental=incremental, kernel=False if plain else None)

    b1_trace = out.b1.cpu().numpy()
    cost_trace = []
    if record_every:
        cost_trace = [float(c) for t, c in enumerate(out.cost)
                      if t % record_every == 0]
    events = _events_from_trace(out.events) if record_events else []
    # cumsum accumulates sequentially in f64 — the host's per-step
    # ``served_cost += float(b1)``
    served = float(np.cumsum(b1_trace, dtype=np.float64)[-1]) \
        if b1_trace.size else 0.0
    return DeviceDuelState(
        slots=carry.slots.cpu().numpy().astype(np.int64),
        virt=carry.virt.cpu().numpy().astype(np.int64),
        real_sav=carry.real_sav.cpu().numpy(),
        virt_sav=carry.virt_sav.cpu().numpy(),
        deadline=carry.deadline.cpu().numpy().astype(np.int64),
        n_promotions=int(carry.n_prom.sum()), served_cost=served,
        n_served=len(b1_trace), promotions=events, b1_trace=b1_trace,
        cost_trace=cost_trace)


class DuelPlane:
    """Persistent online control plane for the serving engine (§5 run
    inside the data plane): holds the duel carry on the device across
    serve() batches, observing each batch in one scan.

    ``observe(objs, b1_ext=...)`` takes the batch's request object ids
    and (optionally) the costs the fused lookup already computed for
    them — the request is then priced once for serving and dueling.
    Returns True iff at least one promotion settled in the batch, i.e.
    the placement changed and the data-plane cache must be rebuilt.

    ``n_valid`` marks a bucketed batch (serve/engine.py): only the first
    ``n_valid`` rows are real requests, the tail is power-of-two padding.
    Randomness is drawn for the valid prefix only and the scan masks the
    padded steps into no-ops, so the duel trajectory is bitwise that of
    observing the unpadded batch. ``plain`` runs the plain scan even on
    CUDA tensors (what kernel F is held against).
    """

    def __init__(self, dinst: DeviceInstance, slots0: np.ndarray,
                 window: int = 512, delta: float = 0.05,
                 arm_prob: float = 0.25, seed: int = 0,
                 incremental: bool = True, plain: bool = False):
        self.dinst = dinst
        self.incremental = bool(incremental)
        self.plain = bool(plain)
        self.window = int(window)
        self.one_delta = float(np.float32(1.0 + delta))
        self.arm_prob = float(arm_prob)
        self.rng = np.random.default_rng(seed)
        self.carry = _duel_carry(dinst, np.asarray(slots0))
        self.t = 0
        self.n_promotions = 0
        self.served_cost = 0.0
        self._args = _scan_args(dinst)

    def observe(self, objs: np.ndarray, ings: np.ndarray | None = None,
                b1_ext=None, n_valid: int | None = None) -> bool:
        objs = np.asarray(objs)
        if ings is None:
            ings = np.zeros(objs.shape[0], np.int64)
        # masked whenever the caller buckets, even with zero padding rows
        masked = n_valid is not None
        n_real = objs.shape[0] if n_valid is None else int(n_valid)
        # draw only for real requests: the rng stream position after a
        # bucketed observe equals the unpadded one
        arm_flags = np.zeros(objs.shape[0], bool)
        slot_draws = np.zeros(objs.shape[0], np.float64)
        arm_flags[:n_real] = self.rng.random(n_real) < self.arm_prob
        slot_draws[:n_real] = self.rng.random(n_real)
        valid = None
        if masked:
            valid = np.zeros(objs.shape[0], bool)
            valid[:n_real] = True
        h_slots, on_path = self._args
        xs = _duel_xs(objs, ings, self.t, arm_flags, slot_draws,
                      b1_ext=b1_ext, valid=valid, device=self.dinst.device)
        self.carry, out = _duel_scan(
            self.dinst, h_slots, on_path, self.carry, xs, self.one_delta,
            self.window, False, b1_ext is not None, 0, masked=masked,
            incremental=self.incremental,
            kernel=False if self.plain else None)
        self.t += n_real
        self.served_cost += float(out.b1.cpu().numpy()
                                  .astype(np.float64).sum())
        n_prom = int(self.carry.n_prom.sum())
        changed = n_prom > self.n_promotions
        self.n_promotions = n_prom
        return changed

    @property
    def slots_np(self) -> np.ndarray:
        return self.carry.slots.cpu().numpy().astype(np.int64)
