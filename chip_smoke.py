#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each before the last:

1. ``device`` — the card's name and count, and ``nvidia-smi``'s name and
   power limit line.
2. ``build`` — seconds to build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel); for each instantiation of kernels A and B, and of kernels
   C and D, and of kernel F, ptxas's registers and spills; for kernel E's
   bf16 (tensor-core)
   instantiations, the same, their dynamic shared memory, and where
   ``cuobjdump`` exists the ``HGMMA`` (and ``HMMA``) instructions in
   their SASS, which must be there.
3. ``kernel`` — each kernel (A fused lookup, B 1-NN, C placement gains,
   D greedy gain, E flash attention) against its plain PyTorch version
   on the card at main-path shapes: errors against a stated tolerance,
   index equality, time from CUDA events, the least time the card could
   take (its bound), the plain version's time, and where PyTorch
   computes the same function in a library call that call's time, which
   the port never uses: E ``scaled_dot_product_attention``; A and B the
   matmul form (one cuBLAS product for the (Q, K) C_a, then a masked
   min), the plain version of PR 11, which the per-pair plain version
   replaced. A and E are also held at the ``stream`` phase's shapes
   (A at its lookup buckets, E at its miss-prefill buckets). E is also
   held to ``flash_blocked``, its plain counterpart step for step, and
   reports its achieved TFLOP/s, its share of the bound and the
   exponential floor. D's entry point, ``greedy_gain``, is its own path:
   counted in a run of its own. A, B, C and D also report their device
   time per launch (``device_ms``, from torch.profiler's trace), which
   separates the kernel from the host's part of a call, and their plan;
   A and B at K 65,536 must beat the matmul form. C is held at the
   engine's R = O = 10⁵ and the stream phase's 20,000; its columns for a
   ragged slice of the candidates must be those of the full call bit for
   bit, and D must equal C bit for bit on equal H rows. Past 8 caches
   (``gain_groups``): C at I 4 and J 9, 17 and 32, D at J 9, on the
   stream phase's catalog, in ⌈J/8⌉ launches, against their plain
   versions and bitwise against J ≤ 8 slices of H.
4. ``stable`` — bitwise pair equality of the shape-stable distance form
   across column, k-batch and row-block shapes on the card (and its
   largest relative difference from the CPU).
5. ``bigcache`` — a 65,536-key three-level network from
   ``SimCacheNetwork.from_placement`` (slots by popularity rank) serving
   16 batches of 256 sampled queries fused and looped: bitwise equal
   results, mean cost below h_repo, 16 launches of A and 48 of B; then,
   outside the counted runs, A's served batch and B on each level held
   against their plain versions at these shapes (split plans of their
   own).
   Then ``duel``: kernel F, the NETDUEL scan between promotions, at the
   engine's scale (10⁵ objects, K 448, C_a streamed, from random slots,
   4,096 requests, window 256), once through F (counted) and once
   through the plain scan on the card: every output bitwise equal, at
   least one promotion, F's launches one per promoting step plus one;
   both scans' times per request, the re-arms' time, F's device time.
6. ``engine`` — ``SimCacheEngine`` with granite-3-2b at full width
   (random weights from a seed) in front of a 100,000-object catalog.
   The main path: cold serving, ``refresh_placement()`` (cascade on the
   card), warm serving and one background ``request_refresh`` →
   ``wait_refresh`` → ``poll_refresh`` cycle; kernel launch counts are
   zeroed just before it and read just after it. Then checks outside
   it: the installed lookup pricing the observed window at the
   predicted C(A), the looped lookup (kernel B, its own path, counted
   alone) serving the last warm batch as the fused one did, and
   ``calibrate()`` timed once.
   Then ``warmstart``: the same engine with ``warm_start`` on, on the
   same weights and batches — every refresh the §4 continuous-limit
   warm start (solve and Prop 4.2 band map in NumPy, a 512-request
   LOCALSWAP polish on the card): its refresh split into solve, map and
   polish, its swaps, its predicted C(A) beside the cascade's, warm
   serving, one background refresh; launches counted over the run
   (kernel A's among them). The warm start of the refresh's window is
   then held against the same call on a CPU ``DeviceInstance`` over the
   first 64 polish requests: ``slots_warm`` bitwise, the polished slots
   equal or first parted at an f32 edge.
   Then ``warm_1e6``: the warm start at 10⁶ objects (the reference
   suite's chain, tandem and tree on a 1000 × 1000 grid, and the §4.4
   tandem with arrivals at both nodes), unpolished: seconds of the
   solve and the map, a valid banded allocation, the card's streamed
   C(A) against the empty allocation's, a total under 60 s, and the
   tandem's f32 descent on the card held against the CPU's.
7. ``prefill`` — granite-3-2b at full width, B = 2, S = 2048 (bf16),
   with ``use_flash_attention`` on and then off on the same weights:
   logit agreement, both times, kernel E's launches per flash forward
   (one per layer); and once more in f32 at B = 1, S = 512, where the
   two attentions must agree to f32 rounding.
8. ``stream`` — ``SimCacheEngine`` at full width with
   ``use_flash_attention=True`` in front of a 20,000-object catalog,
   driven by ``StreamDriver`` (4 Zipf streams): a cold run, a
   ``refresh_placement()``, a warm run whose cadence starts a background
   refresh, and ``drain_refresh()``. Kernel E's and A's launches are
   counted over the phase.
   Then ``duel_engine``: the online plane on the serving path — the
   same engine with ``netduel`` and ``refresh_on_promotion`` (1,024 cold
   requests, ``refresh_placement()``, 4,096 warm requests, the drain),
   its launches counted over the run (F's among them); every batch each
   duel plane observed is replayed through a second ``DuelPlane`` on the
   plain scan, whose carry must equal the engine's bitwise.
   Then ``scenario``: a multi-ingress ISP-like network (37 caches, 448
   slots, 4 ingresses) on the stream's catalog rescaled by the reference
   hit-rate bench's rule; GREEDY on the card (kernel C in 5 groups a
   call, counted; C then held against its plain version at the seed's
   inputs) and 4,096 requests through the engine's strategy plane for
   each of the five strategies (kernel E on the misses, counted): hit
   rate, mean cost and batch percentiles beside GREEDY's C(A).
   Then ``hitrate``: the Che plane on the card on the reference's
   full-scale network (scale-free, 41 caches, 4,096 slots, 6
   ingresses) at 20,000 objects (cut from 10⁶: no LSH enumeration yet):
   exact balls, the SIM-LRU and RND-LRU predictions against a 40,000-
   request replay, the balls held against the CPU's on a slice, and the
   refresh surrogate's time a call at 10⁵ and 10⁶ objects, its cost
   bitwise from call to call.
   Then ``gate``: the ``stream`` configuration with
   ``refresh_min_gain`` 100: every stationary request skipped (no solve,
   no swap), a drift to uniform demand (``set_streams``) triggering a
   solve that swaps in; the surrogate's time a call; launches counted
   over the phase.
9. ``launch`` — ``python -m repro_torch.launch.serve`` in a subprocess,
   batch loop, streaming, streaming with ``--netduel``, the batch loop
   with ``--warm-start``, and ``--scenario scale_free --strategy lce``
   in both loops; each must exit 0 and print its final ``[serve] …
   hit-rate`` line (and the duel churn with ``--netduel``, the scenario
   with ``--scenario``).
10. ``kernels`` — one JSON object with every kernel's numbers; A's and
   B's entries also carry each of their two shapes (K 448 and 65,536),
   C's its two (R = O = 10⁵ and 20,000) and its times past 8 caches; F's
   launches are those of the ``duel_engine`` run; A's entry also carries
   its launches in the ``warmstart`` run, C's and E's their launches in
   the ``scenario`` runs, and every entry its launches in the ``gate``
   run.

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script then exits non-zero and prints no result. It
needs a CUDA card and the repository's ``src/`` beside it.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp32
# outside the tensor cores — the kernels run fp32 on the CUDA cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
EX2_PER_CLOCK = 16 * 132  # hardware exponentials per clock: 16 per SM
U32 = 2.0 ** -24          # f32 unit roundoff
U_BF16 = 2.0 ** -8        # bf16 unit roundoff


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_ms(n_bytes: float, n_flops: float,
             peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """The least time for the work: the larger of bytes over the memory
    rate and operations over the peak for their type (fp32 unless
    named), and which one it is."""
    tb, tf = n_bytes / PEAK_BYTES_PER_S, n_flops / peak_flops
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def cuda_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back runs, from
    CUDA events, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int, match: str, tries: int = 3) -> dict:
    """Device time per call of ``fn`` from torch.profiler's trace (its
    CUDA events, as ``trace_solve.py`` reads them): the kernels whose name
    contains ``match``, their launches per call, and the memsets beside
    them, over ``iters`` calls after one warm-up call. Now and then (once
    in ~60 windows on the card) a window's trace comes back without its
    device events; a window whose kernel count is not a whole number per
    call is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        kern = [e for e in dev if match in e.name]
        if kern and len(kern) % iters == 0:
            break
    else:
        raise RuntimeError(f"the profiler recorded no whole window of "
                           f"{match} kernels in {tries} tries")
    mem = [e for e in dev if e.name.startswith("Memset")]
    span = lambda es: sum(e.time_range.end - e.time_range.start  # noqa
                          for e in es) / 1e3 / iters
    return dict(device_ms=span(kern), launches_per_call=len(kern) / iters,
                memset_ms=span(mem), memsets_per_call=len(mem) / iters)


def l2_tolerance(torch, q, keys, d):
    """Per-query tolerance on an l2 distance near ``d`` computed with the
    |q|² + |k|² − 2q·k identity: its cancellation error is about
    eps·(|q|² + |k|²) in d² space; 16 unit roundoffs cover the rounding
    of both implementations' dot products over D = 100 terms, and
    |√a − √b| ≤ |a − b| / (√a + √b) carries it to d."""
    t2 = 16 * U32 * ((q * q).sum(1) + (keys * keys).sum(1).max())
    return t2 / (d + t2.sqrt())


def gain_tolerance(torch, x, lam, block: int = 1024):
    """(1, O) bound on the C_a-induced error of each candidate's gain:
    Σ_r λ_r·tol(C_a(x_r, x_o)), the per-pair tolerance of
    :func:`l2_tolerance` with both norms taken per pair."""
    from repro_torch.kernels.knn.ref import _dense_ca
    n2 = (x * x).sum(1)
    parts = []
    for s in range(0, x.shape[0], block):
        d = _dense_ca(x, x[s:s + block], "l2", 1.0)
        t2 = 16 * U32 * (n2[:, None] + n2[None, s:s + block])
        parts.append(lam @ (t2 / (d + t2.sqrt())))
    return torch.cat(parts, dim=1)


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    log("device", kind=name, count=torch.cuda.device_count(),
        nvidia_smi=smi, max_sm_clock_mhz=clock_mhz,
        torch=torch.__version__, cuda=torch.version.cuda)
    return name, clock_mhz * 1e6


def _ptxas_entries(log_: str) -> dict:
    """ptxas -v's registers and spills for each kernel (entry function)."""
    out, fn = {}, None
    for line in log_.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = out.setdefault(m[1], {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if fn is not None and m:
            fn.update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if fn is not None and m:
            fn["registers"] = int(m[1])
    return out


def _sass_mma_counts(lib_path) -> dict | None:
    """HGMMA and HMMA instructions in each bf16 kernel E of the library's
    SASS, by head width; None where the toolkit has no cuobjdump."""
    import os
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        m = re.search(r"flash_tc_kernelILi(\d+)E", block.split()[0])
        if m:
            counts[f"Dh{m[1]}"] = dict(
                HGMMA=len(re.findall(r"\bHGMMA\.", block)),
                HMMA=len(re.findall(r"\bHMMA\.", block)))
    return counts


def phase_build():
    from repro_torch.kernels.build import BUILD_DIR, LIBRARY
    from repro_torch.kernels.flash_attention.flash import HEAD_DIMS
    LIBRARY.fn("simcache_knn")
    (BUILD_DIR / "ptxas.log").write_text(LIBRARY.ptxas_log)
    log_ = LIBRARY.ptxas_log
    entries = _ptxas_entries(log_)
    flash_tc = {}
    for name, info in entries.items():
        m = re.search(r"flash_tc_kernelILi(\d+)E", name)
        if m:
            dh = int(m[1])
            flash_tc[f"Dh{dh}"] = dict(
                info, dynamic_smem_bytes=LIBRARY.fn(
                    "simcache_flash_tc_smem")(dh))
    sass = _sass_mma_counts(LIBRARY.path("flash.cu"))
    lookup = {}                        # kernels A and B, per instantiation
    for name, info in entries.items():
        m = re.search(r"nn_kernelILi(\d)ELb(\d)ELi(\d+)ELi\d+ELi\d+ELb(\d)E",
                      name)
        if m:
            metric = ("l1", "l2", "l2sq")[int(m[1])]
            wide = " streamed" if m[4] == "1" else ""
            lookup[f"{'AB'[m[2] == '0']} {metric} q_tile {m[3]}{wide}"] = info
    if len(lookup) != 18:              # 3 metrics x (A, B) x 3 tiles
        raise RuntimeError(f"ptxas reported {len(lookup)} lookup kernel "
                           f"instantiations, not 18: {sorted(lookup)}")
    gain = {}                          # kernels C and D, per instantiation
    for name, info in entries.items():
        m = re.search(r"gains_kernelILi(\d)ELb(\d)ELi(\d)ELb(\d)E", name)
        if m:
            metric = ("l1", "l2", "l2sq")[int(m[1])]
            wide = " streamed" if m[4] == "1" else ""
            gain[f"{'CD'[int(m[2])]} {metric} J{m[3]}{wide}"] = info
    if len(gain) != 24:                # 3 metrics x (C, D) x 4 variants
        raise RuntimeError(f"ptxas reported {len(gain)} gain kernel "
                           f"instantiations, not 24: {sorted(gain)}")
    duel = {}                          # kernel F, per instantiation
    for name, info in entries.items():
        m = re.search(r"duel_scan_kernelILb(\d)ELi(\d)E", name)
        if m:
            key = "materialized" if m[1] == "1" else \
                f"streamed {('l1', 'l2', 'l2sq')[int(m[2])]}"
            duel[key] = info
    if len(duel) != 4:                 # materialized + 3 streamed metrics
        raise RuntimeError(f"ptxas reported {len(duel)} duel kernel "
                           f"instantiations, not 4: {sorted(duel)}")
    log("build", seconds=LIBRARY.build_seconds,
        registers=sorted({int(r) for r in re.findall(
            r"Used (\d+) registers", log_)}),
        spill_bytes=max([int(b) for b in re.findall(
            r"(\d+) bytes spill stores", log_)] or [0]),
        flash_bf16_kernels=dict(sorted(flash_tc.items())),
        lookup_kernels=dict(sorted(lookup.items())),
        gain_kernels=dict(sorted(gain.items())),
        duel_kernels=dict(sorted(duel.items())),
        flash_bf16_sass=sass,
        ptxas_log=str(BUILD_DIR / "ptxas.log"))
    if sorted(flash_tc) != sorted(f"Dh{d}" for d in HEAD_DIMS) or (
            sass is not None and (
                sorted(sass) != sorted(flash_tc)
                or not all(c["HGMMA"] > 0 for c in sass.values()))):
        raise RuntimeError(f"kernel E's bf16 build is not on the tensor "
                           f"cores: {flash_tc}, {sass}")


def _lookup_inputs(torch, coords, Q, K, rng):
    """Queries and a segmented key tensor at main-path shapes: three
    levels (h = 0, 15, 150) over catalog rows, one sentinel key per 97
    marked invalid, payload = concatenated key index."""
    dev = torch.device("cuda")
    q = torch.as_tensor(coords[rng.choice(len(coords), Q)], device=dev)
    keys = torch.as_tensor(coords[rng.choice(len(coords), K,
                                             replace=False)], device=dev)
    bounds = [0, K // 7, 3 * K // 7, K]
    h_key = torch.zeros(K, device=dev)
    level = torch.zeros(K, dtype=torch.int32, device=dev)
    slot = torch.zeros(K, dtype=torch.int32, device=dev)
    for lv, (a, b) in enumerate(zip(bounds, bounds[1:])):
        h_key[a:b] = (0.0, 15.0, 150.0)[lv]
        level[a:b] = lv
        slot[a:b] = torch.arange(b - a, dtype=torch.int32, device=dev)
    valid = (torch.arange(K, device=dev) % 97 != 5).to(torch.int32)
    pay = torch.where(valid > 0, torch.arange(K, dtype=torch.int32,
                                              device=dev), -1)
    meta = torch.stack([level, slot, pay, valid])
    return q, keys, h_key, meta


def matmul_lookup(torch, q, keys, h_key, meta, h_repo):
    """The fused lookup in the matmul form: one library product for the
    (Q, K) C_a, then a masked min with the repository folded in on a
    strict ``<``. Timed only, as kernel A's ``library_ms``."""
    from repro_torch.kernels.knn.ref import _dense_ca
    ca = _dense_ca(q, keys, "l2", 1.0)
    cost = torch.where(meta[3][None, :] > 0, ca + h_key[None, :],
                       torch.full_like(ca, 3.0e38))
    bcost, best = cost.min(dim=1)
    use_repo = h_repo < bcost
    bca = ca.gather(1, best[:, None])[:, 0]
    return (torch.where(use_repo, h_repo, bcost),
            torch.where(use_repo, 0.0, bca),
            torch.where(use_repo, -1, meta[0, best]),
            torch.where(use_repo, 0, meta[1, best]),
            torch.where(use_repo, -1, meta[2, best]))


def _plan_fields(torch, Q, K, D) -> dict:
    """The split plan kernels A and B take at this shape on this card."""
    from repro_torch.kernels.knn.knn import _sm_count, _split_plan
    plan = _split_plan(Q, K, D, _sm_count(torch.device("cuda")))
    return dict(q_tile=plan.q_tile, n_splits=plan.n_splits)


def hold_fused(torch, q, keys, h_key, meta, h_repo, got) -> dict:
    """Kernel A's outputs ``got`` (l2, γ = 1, keys segmented by ascending
    level) against its plain version on the same inputs: every cost
    within the per-query tolerance, and a differing winner (a key named
    by its level and slot) only where the plain version sees a near-tie:
    its own cost at the kernel's key within 2·tol of its min. The fields
    of the check and ``ok``."""
    from repro_torch.kernels.knn.ref import _dense_ca, fused_lookup_ref
    Q, K = q.shape[0], keys.shape[0]
    cost_k, ca_k, lvl_k, slot_k, pay_k = got
    cost_p, ca_p, lvl_p, slot_p, pay_p = fused_lookup_ref(
        q, keys, h_key, meta, "l2", 1.0, h_repo, -1)
    tol = l2_tolerance(torch, q, keys, ca_p) + 2 * U32 * cost_p
    err = (cost_k - cost_p).abs()
    full = torch.where(meta[3][None, :] > 0,
                       _dense_ca(q, keys, "l2", 1.0) + h_key[None, :],
                       torch.full((Q, K), 3.0e38, device=q.device))
    start = torch.searchsorted(meta[0].contiguous(), torch.arange(
        int(meta[0].max()) + 1, dtype=torch.int32, device=q.device))

    def key_index(lvl, slot):                  # −1: the repository
        return torch.where(lvl >= 0, start[lvl.clamp_min(0).long()] + slot,
                           -1)

    idx_k, idx_p = key_index(lvl_k, slot_k), key_index(lvl_p, slot_p)
    diff = idx_k != idx_p
    rows = torch.nonzero(diff).reshape(-1)
    at_k = torch.where(idx_k[rows] >= 0,
                       full[rows, idx_k[rows].clamp_min(0)],
                       torch.full_like(cost_p[rows], h_repo))
    unjustified = int((at_k - cost_p[rows] > 2 * tol[rows]).sum())
    return dict(max_abs_err=float(err.max()),
                max_rel_err=float((err / cost_p.abs().clamp_min(1e-30))
                                  .max()),
                tol_max=float(tol.max()), index_equal=int((~diff).sum()),
                index_near_tie=int(diff.sum()), unjustified=unjustified,
                payload_equal_where_key_equal=bool(
                    (pay_k == pay_p)[~diff].all()),
                ok=bool((err <= tol).all()) and unjustified == 0
                and bool((pay_k == pay_p)[~diff].all()))


def hold_knn(torch, q, keys, got) -> dict:
    """Kernel B's outputs ``got`` (l2, γ = 1) against its plain version
    on the same inputs, with :func:`hold_fused`'s tolerance and near-tie
    rule. The fields of the check and ``ok``."""
    from repro_torch.kernels.knn.ref import _dense_ca, knn_ref
    cost_k, idx_k = got
    cost_p, idx_p = knn_ref(q, keys, "l2")
    tol = l2_tolerance(torch, q, keys, cost_p)
    err = (cost_k - cost_p).abs()
    diff = idx_k != idx_p
    rows = torch.nonzero(diff).reshape(-1)
    full = _dense_ca(q, keys, "l2", 1.0)
    at_k = full[rows, idx_k[rows].long()]
    unjustified = int((at_k - cost_p[rows] > 2 * tol[rows]).sum())
    return dict(max_abs_err=float(err.max()), tol_max=float(tol.max()),
                index_equal=int((~diff).sum()),
                index_near_tie=int(diff.sum()), unjustified=unjustified,
                ok=bool((err <= tol).all()) and unjustified == 0)


def phase_kernel_a(torch, coords, rng, Q, K):
    from repro_torch.kernels.knn.knn import fused_lookup_cuda
    from repro_torch.kernels.knn.ref import fused_lookup_ref
    q, keys, h_key, meta = _lookup_inputs(torch, coords, Q, K, rng)
    h_repo = 1000.0
    args = (q, keys, h_key, meta, "l2", 1.0, h_repo, -1)
    held = hold_fused(torch, q, keys, h_key, meta, h_repo,
                      fused_lookup_cuda(*args))
    cost_p = fused_lookup_ref(*args)[0]
    ms = cuda_ms(torch, lambda: fused_lookup_cuda(*args), 50)
    dev = device_ms(torch, lambda: fused_lookup_cuda(*args), 50, "nn_kernel")
    plain = cuda_ms(torch, lambda: fused_lookup_ref(*args), 10)
    lib = matmul_lookup(torch, q, keys, h_key, meta, h_repo)
    lib_ms = cuda_ms(torch, lambda: matmul_lookup(torch, q, keys, h_key,
                                                  meta, h_repo), 10)
    D = q.shape[1]
    bms, by = bound_ms(4 * (Q * D + K * D + K + 4 * K + 5 * Q),
                       2 * Q * K * D + 5 * Q * K)
    ok = held.pop("ok")
    res = dict(name="fused_lookup", Q=Q, K=K, D=D, **held,
               **_plan_fields(torch, Q, K, D), ms=ms, **dev,
               share_of_bound=bms / dev["device_ms"],
               plain_ms=plain, bound_ms=bms, bound_by=by,
               library="matmul form", library_ms=lib_ms,
               library_max_abs_err=float((lib[0] - cost_p).abs().max()),
               ok=ok)
    log("kernel", **res)
    if not ok:
        raise RuntimeError(f"kernel A disagrees with its plain version: "
                           f"{res}")
    return res


def phase_kernel_b(torch, coords, rng, Q, K):
    from repro_torch.kernels.knn.knn import knn_cuda
    from repro_torch.kernels.knn.ref import _dense_ca, knn_ref
    q, keys, _, _ = _lookup_inputs(torch, coords, Q, K, rng)
    held = hold_knn(torch, q, keys, knn_cuda(q, keys, "l2"))
    ok = held.pop("ok")
    cost_p = knn_ref(q, keys, "l2")[0]
    full = _dense_ca(q, keys, "l2", 1.0)
    ms = cuda_ms(torch, lambda: knn_cuda(q, keys, "l2"), 50)
    dev = device_ms(torch, lambda: knn_cuda(q, keys, "l2"), 50, "nn_kernel")
    plain = cuda_ms(torch, lambda: knn_ref(q, keys, "l2"), 10)
    lib_ms = cuda_ms(torch, lambda: _dense_ca(q, keys, "l2", 1.0).min(1),
                     10)
    D = q.shape[1]
    bms, by = bound_ms(4 * (Q * D + K * D + 2 * Q), 2 * Q * K * D + 4 * Q * K)
    res = dict(name="knn", Q=Q, K=K, D=D, **held,
               **_plan_fields(torch, Q, K, D), ms=ms, **dev,
               share_of_bound=bms / dev["device_ms"],
               plain_ms=plain, bound_ms=bms, bound_by=by,
               library="matmul form", library_ms=lib_ms,
               library_max_abs_err=float(
                   (full.min(1).values - cost_p).abs().max()),
               ok=ok)
    log("kernel", **res)
    if not ok:
        raise RuntimeError(f"kernel B disagrees with its plain version: "
                           f"{res}")
    return res


def _gain_plan_fields(torch, O, D, I, J, per_request_h) -> dict:
    from repro_torch.kernels.knn.gains import _gain_plan
    plan = _gain_plan(O, D, I, J, per_request_h)
    return dict(y_stream=plan.y_stream,
                j_width=plan.j_width, blocks=len(plan.tiles()))


# a ragged slice of the candidates (tile-misaligned at both ends)
GAIN_SLICE = (1001, 77_777)


def phase_kernel_c(torch, coords, lam_np):
    """Kernel C at a GREEDY seed of a catalog: R = O = catalog, I = 1,
    J = 3, cur = h_repo everywhere (the engine's 10⁵ catalog, and the
    stream phase's 20,000). Also the sharding property: C on a ragged
    slice of the candidates gives the full call's columns bit for bit."""
    from repro_torch.kernels.knn.gains import _gains_tiles, gains_cuda
    dev = torch.device("cuda")
    x = torch.as_tensor(coords, device=dev)
    lam = torch.as_tensor(lam_np, dtype=torch.float32, device=dev)
    cur = torch.full_like(lam, 1000.0)
    H = torch.tensor([[0.0, 15.0, 150.0]], device=dev)
    got = gains_cuda(x, x, lam, cur, H, "l2")
    ref = _gains_tiles(x, x, lam, cur, H, "l2", 1.0).T
    a, b = (min(v, x.shape[0]) for v in GAIN_SLICE)
    sliced = bool(torch.equal(gains_cuda(x, x[a:b], lam, cur, H, "l2"),
                              got[:, a:b]))
    torch.cuda.synchronize()
    # each term λ_r·relu(·) moves by at most λ_r times the C_a tolerance
    # of its pair (l2_tolerance, summed per candidate in tiles), plus the
    # two f32 sums over R terms: 1e-4 relative (~ sqrt(R)·eps with margin)
    err = (got - ref).abs()
    tol = gain_tolerance(torch, x, lam) + 1e-4 * ref.abs()
    ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all()) \
        and sliced
    call = lambda: gains_cuda(x, x, lam, cur, H, "l2")  # noqa: E731
    ms = cuda_ms(torch, call, 3)
    dev_t = device_ms(torch, call, 3, "gains_kernel")
    plain = cuda_ms(torch, lambda: _gains_tiles(x, x, lam, cur, H, "l2",
                                                1.0), 1, warmup=0)
    R, D = x.shape
    I, J = H.shape
    bms, by = bound_ms(4 * (2 * R * D + 2 * I * R + I * J + J * R),
                       2 * R * R * D + R * R * (3 + 3 * I * J))
    res = dict(name="placement_gains", R=R, O=R, D=D, I=I, J=J,
               **_gain_plan_fields(torch, R, D, I, J, False),
               max_abs_err=float(err.max()),
               max_rel_err=float((err / ref.abs().clamp_min(1e-30)).max()),
               tol_max=float(tol.max()), slice=[a, b],
               slice_bitwise=sliced, ms=ms, **dev_t,
               share_of_bound=bms / dev_t["device_ms"], plain_ms=plain,
               bound_ms=bms, bound_by=by, library_ms=None, ok=ok)
    log("kernel", **res)
    if not ok:
        raise RuntimeError(f"kernel C disagrees with its plain version or "
                           f"with its own full call: {res}")
    return res


def phase_stable(torch, coords):
    from repro_torch.core.costs import approx_cost_stable
    dev = torch.device("cuda")
    x = torch.as_tensor(coords[:2000], device=dev)
    y = torch.as_tensor(coords[2000:2100], device=dev)
    full = approx_cost_stable(x, y, "l2")
    checks = {
        "column": all(torch.equal(approx_cost_stable(x, y[j:j + 1], "l2"),
                                  full[:, j:j + 1]) for j in (0, 17, 99)),
        "k_batch": torch.equal(approx_cost_stable(x, y[10:74], "l2"),
                               full[:, 10:74]),
        "row_block": torch.equal(approx_cost_stable(x[500:900], y, "l2"),
                                 full[500:900]),
        "single_row": torch.equal(approx_cost_stable(x[7:8], y[3:4], "l2"),
                                  full[7:8, 3:4]),
    }
    # the CPU evaluates the same elementwise sequence; it agrees to
    # rounding (a few ulp of the f32 sum), not bit for bit
    cpu = approx_cost_stable(x.cpu(), y.cpu(), "l2")
    log("stable", **checks, cpu_max_rel_diff=float(
        ((cpu - full.cpu()).abs() / cpu.abs().clamp_min(1e-30)).max()))
    if not all(checks.values()):
        raise RuntimeError(f"shape-stable distances differ: {checks}")


BIGCACHE_SLOTS = (4096, 16_384, 45_056)    # 65,536 keys in all
BIGCACHE_H = (0.0, 15.0, 150.0)


def phase_bigcache(torch, cat, dem):
    """A large cache network on the data plane: three levels of 4,096 /
    16,384 / 45,056 slots (65,536 keys, the shape A and B are timed at)
    at h = 0 / 15 / 150 and h_repo 1000, filled by Zipf(0.8) popularity
    rank (the most requested objects at the cheapest level) and built by
    ``SimCacheNetwork.from_placement`` — a solve at this size would take
    hours. It serves 16 batches of 256 ``Demand.sample`` queries fused
    (kernel A, one launch a batch) and again looped (kernel B, one launch
    a level and batch), each run with the launch counts zeroed just
    before and read just after. The two must give bitwise equal
    ``LookupResult``s, the mean cost must be below h_repo, and the
    launches must be 16 of A and 48 of B. Outside the counted runs the
    kernels are held against their plain versions at these shapes (the
    split plans no other phase runs): the first batch's served fused
    result against ``fused_lookup_ref`` on the network's layout, and B on
    each level's keys against ``knn_ref``, with the ``kernel`` phase's
    tolerance and near-tie rule."""
    from repro_torch.core.simcache import SimCacheNetwork
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.knn.knn import knn_cuda
    h_repo, n_batches, batch = 1000.0, 16, 256
    popularity = np.asarray(dem.lam).reshape(-1, cat.n).sum(0)
    order = np.argsort(-popularity, kind="stable")
    slots = order[:sum(BIGCACHE_SLOTS)].astype(np.int64)
    slot_cache = np.repeat(np.arange(3), BIGCACHE_SLOTS)
    net = SimCacheNetwork.from_placement(cat.coords, slots, slot_cache,
                                         hs=BIGCACHE_H, h_repo=h_repo)
    looped = dataclasses.replace(net, fused=False)
    rng = np.random.default_rng(5)
    queries = [torch.as_tensor(cat.coords[dem.sample(batch, rng)[0]],
                               device="cuda") for _ in range(n_batches)]
    net.lookup(queries[0])                        # layout and warm-up
    looped.lookup(queries[0])
    torch.cuda.synchronize()

    def serve(network):
        reset_launch_counts()                     # this path's run
        out, secs = [], []
        for q in queries:
            t = time.perf_counter()
            out.append(network.lookup(q))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        return out, launch_counts(), secs

    fused, f_counts, f_secs = serve(net)
    loop, l_counts, l_secs = serve(looped)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    fields = ("cost", "approx_cost", "level", "slot", "payload", "hit")
    equal = all(torch.equal(bits(getattr(a, f)), bits(getattr(b, f)))
                for a, b in zip(fused, loop) for f in fields)
    cost = torch.cat([r.cost for r in fused])
    level = torch.cat([r.level for r in fused])
    f0 = fused[0]
    held = {"A": hold_fused(torch, queries[0], *net.fused_layout(), h_repo,
                            (f0.cost, f0.approx_cost, f0.level, f0.slot,
                             f0.payload))}
    for j, lv in enumerate(net.levels):
        held[f"B level {j}"] = dict(
            hold_knn(torch, queries[0], lv.keys,
                     knn_cuda(queries[0], lv.keys, "l2")),
            K=lv.keys.shape[0],
            **_plan_fields(torch, batch, lv.keys.shape[0], cat.dim))
    held["A"].update(K=sum(BIGCACHE_SLOTS), **_plan_fields(
        torch, batch, sum(BIGCACHE_SLOTS), cat.dim))
    res = dict(levels=list(BIGCACHE_SLOTS), h=list(BIGCACHE_H),
               h_repo=h_repo, keys=sum(BIGCACHE_SLOTS), catalog=cat.n,
               dim=cat.dim, batches=n_batches, batch=batch,
               fused_equals_looped_bitwise=equal,
               mean_cost=float(cost.mean()),
               hit_rate=float((level >= 0).float().mean()),
               level_share=[float((level == j).float().mean())
                            for j in range(3)],
               fused_launches=f_counts, looped_launches=l_counts,
               fused_ms_per_batch=float(np.mean(f_secs)) * 1e3,
               looped_ms_per_batch=float(np.mean(l_secs)) * 1e3,
               held_against_plain=held)
    log("bigcache", **res)
    checks = [equal, res["mean_cost"] < h_repo,
              all(h["ok"] for h in held.values()),
              f_counts["fused_lookup"] == n_batches, f_counts["knn"] == 0,
              l_counts["knn"] == 3 * n_batches, l_counts["fused_lookup"] == 0]
    if not all(checks):
        raise RuntimeError(f"bigcache phase failed its checks: {checks}")
    return res


# the engine phase's serving: batches of 256 requests, 16-token prompts
ENGINE_BATCHES, ENGINE_BATCH, ENGINE_SEQ = 16, 256, 16


def serve_batches(eng, cfg, dem, seed):
    """Serve the engine phase's 16 batches drawn from ``dem`` with
    ``seed``; returns the stats row (then reset) and the last batch's
    ids."""
    r = np.random.default_rng(seed)
    t = time.perf_counter()
    last = None
    for _ in range(ENGINE_BATCHES):
        ids, _ = dem.sample(ENGINE_BATCH, r)
        last = ids
        out, _ = eng.serve(ids, r.integers(0, cfg.vocab,
                                           (ENGINE_BATCH, ENGINE_SEQ)))
        if len(out) != ENGINE_BATCH:
            raise RuntimeError("serve() lost requests")
    s = eng.stats
    row = dict(hit_rate=s.hit_rate, mean_cost=s.mean_cost,
               model_calls=s.model_calls, requests=s.n_requests,
               seconds=time.perf_counter() - t, p50_ms=s.p50_ms,
               p99_ms=s.p99_ms)
    eng.stats = type(eng.stats)()
    return row, last


def phase_engine(torch, cat, dem):
    """The main path; returns its launch counts, the model's weights
    (the ``warmstart`` phase reuses them) and the cascade's refresh."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import init_params
    from repro_torch.serve import EngineConfig, SimCacheEngine

    cfg = get_config("granite-3-2b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ecfg = EngineConfig(h_ici=15.0, h_dcn=150.0, h_model=1000.0)
    eng = SimCacheEngine(cfg, params, ecfg, cat.coords)
    rng = np.random.default_rng(0)
    seq = ENGINE_SEQ

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                        # the main path's run
    cold, _ = serve_batches(eng, cfg, dem, 1)
    t = time.perf_counter()
    pred = eng.refresh_placement()
    refresh_s = time.perf_counter() - t
    timings = dict(eng.solve_timings)
    warm, last_ids = serve_batches(eng, cfg, dem, 2)
    v0 = eng.placement_version
    started = eng.request_refresh()
    done = eng.wait_refresh(timeout=900)
    swapped = eng.poll_refresh()
    bg = dict(started=started, done=done, swapped=swapped,
              version=eng.placement_version, predicted_cost=
              eng.last_predicted_cost, **eng.solve_timings)
    counts = launch_counts()                      # read just after

    # the data plane prices the observed window as the control plane
    # predicted: C(A) of the allocation the background solve installed
    # (it saw this same window: nothing was served since), through the
    # installed lookup (matmul-form C_a) against the solver's device
    # evaluator (shape-stable C_a), within the per-query matmul-form
    # bound weighted by λ
    inst = eng.observed_instance()
    ing, obj = np.nonzero(inst.lam)
    q = torch.as_tensor(cat.coords[obj], device="cuda")
    w = torch.as_tensor(inst.lam[ing, obj], dtype=torch.float32,
                        device="cuda")
    res_obs = eng.simcache.lookup(q)
    served = float((w * res_obs.cost).sum() / w.sum())
    k_win = torch.as_tensor(cat.coords, device="cuda")[
        res_obs.payload.clamp_min(0).long()]
    t2 = 16 * U32 * ((q * q).sum(1) + (k_win * k_win).sum(1))
    tol_q = torch.where(res_obs.hit, t2 / (res_obs.approx_cost + t2.sqrt()),
                        0.0)
    bg_pred = eng.last_predicted_cost
    bound = float((w * tol_q).sum() / w.sum()) + 1e-5 * abs(bg_pred)
    priced = dict(served=served, predicted=bg_pred, bound=bound,
                  ok=abs(served - bg_pred) <= bound)

    # the looped path (kernel B per level), its own run: it serves the
    # last warm batch exactly as the fused path does, the reference's
    # own contract
    q = torch.as_tensor(cat.coords[last_ids], device="cuda")
    fused = eng.simcache.lookup(q)
    looped_net = dataclasses.replace(eng.simcache, fused=False)
    reset_launch_counts()
    looped = looped_net.lookup(q)
    twin_counts = launch_counts()
    twin = {n: bool(torch.equal(getattr(fused, n), getattr(looped, n)))
            for n in ("level", "slot", "payload", "hit")}
    twin["cost_max_abs_diff"] = float((fused.cost - looped.cost).abs()
                                      .max())
    twin["launches"] = twin_counts
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    # the repository's logits on one prompt batch: finite, full shape
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (8, seq)),
                           device="cuda")
    logits, _ = eng._prefill(eng.params, {"tokens": toks})
    logits_ok = (tuple(logits.shape) == (8, seq, cfg.padded_vocab)
                 and bool(torch.isfinite(logits.float()).all()))
    h_model = ecfg.h_model
    calib_ms = eng.calibrate(toks)               # timed once, not used

    res = dict(model=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               params=sum(p.numel() for p in params.parameters()),
               init_s=init_s, catalog=cat.n, dim=cat.dim, cold=cold,
               predicted_cost=pred, priced=priced, refresh_s=refresh_s,
               **timings,
               warm=warm, twin=twin, background=bg, launches=counts,
               max_memory_allocated_gib=peak_gb, logits_ok=logits_ok,
               calibrate_ms=calib_ms)
    log("engine", **res)
    checks = [counts["fused_lookup"] > 0, counts["placement_gains"] > 0,
              twin_counts["knn"] > 0, warm["hit_rate"] > 0,
              warm["mean_cost"] < h_model, logits_ok,
              all(twin[n] for n in ("level", "slot", "payload", "hit")),
              priced["ok"],
              started and done and swapped and bg["version"] == v0 + 1]
    if not all(checks):
        raise RuntimeError(f"engine phase failed its checks: {checks}")
    # kernel B runs on the looped path only, so its count is that run's
    return dict(counts, knn=twin_counts["knn"]), params, dict(
        predicted_cost=pred, refresh_s=refresh_s, **timings)

# requests of the polish window held on the card against the CPU, a
# cut of the engine's 512: on an H100 host's CPU 64 take ~10 s at 10⁵
# objects
HOLD_POLISH = 64
# relative bound on an f32 ΔC sum's difference across devices, for a
# decision shown to sit at an edge (P1: the card's distances are one ulp
# from the CPU's, and each ΔC sums many of them)
EDGE_RTOL = 1e-5


def _polish_divergence(inst, slots0, n_iters: int, tol: float, devices):
    """Walk the device polish window from ``slots0`` on two devices in
    lockstep (the moves of ``device_localswap``, incremental re-arm);
    return the first step whose decision differs, with each side's ΔC at
    both sides' picks, or None."""
    import torch
    from repro_torch.core.objective import DeviceInstance
    from repro_torch.core.placement.device import (DeviceSwapState,
                                                   _accepts, _swap_deltas)
    from repro_torch.core.placement.localswap import emulated_stream
    _, _, objs, ings = emulated_stream(inst, n_iters, 0, slots0, None)
    sides = []
    for dev in devices:
        d = DeviceInstance.from_instance(inst, materialize_ca=False,
                                         device=dev)
        sides.append((d, DeviceSwapState.init(d, slots0)))
    for t, (o, i) in enumerate(zip(objs.tolist(), ings.tolist())):
        deltas = [_swap_deltas(d, st.best1, st.arg1, st.best2, o, i).cpu()
                  for d, st in sides]
        ys = [int(torch.argmin(x)) for x in deltas]
        acc = [_accepts(x[y], tol) for x, y in zip(deltas, ys)]
        if (acc[0] or acc[1]) and (ys[0], acc[0]) != (ys[1], acc[1]):
            return dict(step=t, obj=o, y=ys, accept=acc, delta_at=[
                [float(x[y]) for y in ys] for x in deltas])
        if acc[0]:
            for d, st in sides:
                y = torch.tensor(ys[0], device=d.device)
                st.slots = st.slots.index_put((y,), torch.tensor(
                    o, dtype=torch.int64, device=d.device))
                st._set_pre(d, d.best_two_delta(
                    st.b1p, st.a1p, st.b2p, st.a2p, st.slots, y[None]))
    return None


def _at_edge(div: dict, tol: float) -> bool:
    """A divergence of two polish windows is an f32 edge, not a fault,
    when the sides' ΔC agree within EDGE_RTOL and either straddle the
    accept threshold −tol (one side accepts, the other does not) or put
    the two picks within that bound of each other on both sides (a
    near-tie of slots)."""
    (a0, a1), (b0, b1) = div["delta_at"]
    vals = [a0, a1, b0, b1]
    eps = EDGE_RTOL * max(max(abs(v) for v in vals), tol)
    agree = abs(a0 - b0) <= eps and abs(a1 - b1) <= eps
    thr = -float(np.float32(tol))
    if div["accept"][0] != div["accept"][1]:
        mine = [a0, b1]                # each side's ΔC at its own pick
        return agree and min(mine) < thr <= max(mine) and \
            max(mine) - min(mine) <= 2 * eps
    return agree and abs(a0 - a1) <= eps and abs(b0 - b1) <= eps


def phase_warmstart(torch, cat, dem, params, cascade):
    """The engine phase's configuration with ``warm_start`` on, on the
    engine phase's weights: the same cold batches, ``refresh_placement()``
    (the §4 warm start: solve and band map in NumPy, the polish on the
    card), the same warm batches and one background refresh; launches
    counted over the run. Then the warm start of that refresh's window
    held against the same call on a CPU ``DeviceInstance``, over the
    first HOLD_POLISH polish requests."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.objective import DeviceInstance
    from repro_torch.core.placement import warmstart
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import EngineConfig, SimCacheEngine

    cfg = get_config("granite-3-2b")
    ecfg = EngineConfig(h_ici=15.0, h_dcn=150.0, h_model=1000.0,
                        warm_start=True)
    eng = SimCacheEngine(cfg, params, ecfg, cat.coords)
    reset_launch_counts()                        # this path's run
    cold, _ = serve_batches(eng, cfg, dem, 1)
    inst = eng.observed_instance()               # the window it solves
    t = time.perf_counter()
    pred = eng.refresh_placement()
    refresh_s = time.perf_counter() - t
    timings = dict(eng.solve_timings)
    warm, _ = serve_batches(eng, cfg, dem, 2)
    v0 = eng.placement_version
    started = eng.request_refresh()
    done = eng.wait_refresh(timeout=900)
    swapped = eng.poll_refresh()
    bg = dict(started=started, done=done, swapped=swapped,
              version=eng.placement_version,
              predicted_cost=eng.last_predicted_cost, **eng.solve_timings)
    counts = launch_counts()                     # read just after

    red = warmstart.classify_topology(inst.net, gamma=inst.cat.gamma)
    reps, hold = {}, dict(polish_iters=HOLD_POLISH)
    for dev in ("cuda", "cpu"):
        d = DeviceInstance.from_instance(inst, materialize_ca=False,
                                         device=dev)
        t = time.perf_counter()
        reps[dev] = warmstart.warm_start(inst, reduction=red, dinst=d,
                                         polish_iters=HOLD_POLISH,
                                         tol=ecfg.swap_tol)
        hold[f"{dev}_s"] = time.perf_counter() - t
    a, b = reps["cuda"], reps["cpu"]
    hold.update(kind=a.kind, swaps=[a.n_swaps, b.n_swaps],
                slots_warm_equal=bool(np.array_equal(a.slots_warm,
                                                     b.slots_warm)),
                slots_equal=bool(np.array_equal(a.slots, b.slots)))
    if not hold["slots_equal"]:
        div = _polish_divergence(inst, a.slots_warm, HOLD_POLISH,
                                 ecfg.swap_tol, ("cuda", "cpu"))
        hold["divergence"] = div
        hold["at_edge"] = div is not None and _at_edge(div, ecfg.swap_tol)

    c_pred = cascade["predicted_cost"]
    res = dict(catalog=cat.n, cold=cold, refresh_s=refresh_s, **timings,
               predicted_cost=pred, cascade_predicted_cost=c_pred,
               gap_to_cascade=(pred - c_pred) / c_pred,
               cascade_refresh_s=cascade["refresh_s"], warm=warm,
               background=bg, launches=counts, hold=hold)
    log("warmstart", **res)
    checks = [counts["fused_lookup"] > 0, warm["hit_rate"] > 0,
              warm["mean_cost"] < ecfg.h_model, timings["warm_swaps"] >= 0,
              started and done and swapped and bg["version"] == v0 + 1,
              hold["slots_warm_equal"],
              hold["slots_equal"] or hold["at_edge"]]
    if not all(checks):
        raise RuntimeError(f"warmstart phase failed its checks: {checks}")
    return counts


def warm_instance(topo: str, O: int, k: int = 64):
    """The reference warm-start suite's instances (tests/test_warmstart.py
    ``make_instance``): grid catalog of side √O, Gaussian demand of
    σ = L/4, k slots a cache — and the §4.4 tandem with arrivals at both
    nodes on the same catalog."""
    import math
    from repro_torch.core import catalog as catalog_api
    from repro_torch.core import demand as demand_api
    from repro_torch.core import topology as topology_api
    from repro_torch.core.objective import Instance
    L = math.isqrt(O)
    cat = catalog_api.grid(L=L)
    n_ingress = 1
    if topo == "tandem":
        net = topology_api.tandem(k_leaf=k, k_parent=k, h=2.0, h_repo=100.0)
    elif topo == "chain":
        net = topology_api.chain(3, [k, k, k], [0.0, 2.0, 6.0], 100.0)
    elif topo == "tandem_both":
        net, n_ingress = topology_api.tandem_both(k, k, 2.0, 100.0), 2
    else:
        net = topology_api.equi_depth_tree(branching=2, depth=1,
                                           k_per_level=[k, k],
                                           h_per_level=[0.0, 3.0],
                                           h_repo=100.0)
        n_ingress = 2
    dem = demand_api.gaussian_grid(cat, sigma=L / 4, n_ingress=n_ingress)
    return Instance(net=net, cat=cat, dem=dem)


def _banded_valid(inst, rep) -> bool:
    """Every slot a distinct in-range object of its cache, and every
    chain-position cache inside its Prop 4.2 band window."""
    from repro_torch.core.placement import warmstart
    n = inst.cat.n
    ok = rep.slots_warm.min() >= 0 and rep.slots_warm.max() < n
    for j in range(inst.net.n_caches):
        stored = rep.slots_warm[inst.slot_cache == j]
        ok &= len(np.unique(stored)) == int(inst.net.capacities[j])
    rank_of = np.empty(n, np.int64)
    rank_of[rep.order] = np.arange(n)
    for p, caches in enumerate(rep.groups):
        for j in caches:
            lo, hi = warmstart.rank_window(
                n, int(rep.bounds[p]), int(rep.bounds[p + 1]),
                int(inst.net.capacities[j]))
            r = rank_of[rep.slots_warm[inst.slot_cache == j]]
            ok &= r.min() >= lo and r.max() < hi
    return bool(ok)


def phase_warm_1e6(torch):
    """The warm start at 10⁶ objects, where no discrete solver runs: the
    reference suite's chain, tandem and tree (grid L = 1000, σ = L/4,
    k = 64) and the §4.4 tandem with arrivals at both nodes, unpolished.
    Each allocation is valid and banded, and the card's streamed C(A)
    beats the empty allocation's; the tandem's descent on the card is
    held against the CPU's on the same inputs."""
    from repro_torch.core.objective import DeviceInstance
    from repro_torch.core.placement import warmstart
    rows = []
    for topo in ("chain", "tandem", "tree", "tandem_both"):
        inst = warm_instance(topo, 1_000_000)
        rep = warmstart.warm_start(inst, polish_iters=0)
        t = time.perf_counter()
        cost = DeviceInstance.from_instance(
            inst, materialize_ca=False).total_cost(rep.slots)
        rows.append(dict(topology=topo, kind=rep.kind, solve_s=rep.solve_s,
                         map_s=rep.map_s, total_s=rep.total_s,
                         total_cost=cost, empty_cost=inst.empty_cost(),
                         cost_s=time.perf_counter() - t,
                         valid=_banded_valid(inst, rep)))
    tandem = inst                                # the last: tandem_both
    red = warmstart.classify_topology(tandem.net)
    sols, hold = {}, {}
    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        sols[dev] = warmstart.solve_continuous(tandem, red, device=dev)
        hold[f"{dev}_s"] = time.perf_counter() - t
    a, b = sols["cuda"], sols["cpu"]
    last_step = 0.05 / np.sqrt(1.0 + 2999 / 100.0)
    hold.update(regions=tandem.cat.n, max_abs_dw1=float(np.abs(
        a.w1 - b.w1).max()), last_step=last_step,
        rel_dcost=abs(a.cost - b.cost) / abs(b.cost))
    log("warm_1e6", rows=rows, tandem_both_descent=hold)
    checks = [r["valid"] and r["total_cost"] < r["empty_cost"]
              and r["total_s"] < 60.0 for r in rows]
    checks += [hold["max_abs_dw1"] <= last_step, hold["rel_dcost"] <= 1e-5]
    if not all(checks):
        raise RuntimeError(f"warm_1e6 phase failed its checks: {checks}")


# (B, S): the long prefills (the last ragged), then the miss-prefill
# buckets of 128-token prompts: up to 64 in the stream phase, 128 and 256
# in the scenario and gate phases (batches of 256, padded to a power of 2)
FLASH_SHAPES = ((1, 4096), (4, 2048), (2, 1000),
                (8, 128), (16, 128), (32, 128), (64, 128),
                (128, 128), (256, 128))


def phase_kernel_e(torch, clock_hz: float):
    """Kernel E in bf16 at granite-3-2b's attention shape (H 32, KH 8,
    Dh 64), causal, at each (B, S) of ``FLASH_SHAPES``, on the tensor
    cores.

    Against ``flash_ref`` (the exact f32 softmax, output rounded once to
    bf16), the kernel has two roundings: each p to bf16 before the PV
    product (|δp| ≤ u·p, u = 2^-8) and its output to bf16. So per element
    |o − ref| ≤ u·|o| + u·|ref| + u·Σ_t p_t·|v_t| / l + f32 terms, and
    Σ_t p_t·|v_t| / l is exactly ``flash_ref(q, k, |v|)``. The check
    allows 2^-7·|ref| + 2^-7·flash_ref(q, k, |v|) + 1e-4: twice the p
    term, and 1e-4 absolute for the f32 sums and ``ex2.approx`` (about 2
    ulp) near zero. It stays far inside the reference's own 2e-2.

    Against ``flash_blocked`` (the same tiles, online softmax and bf16 p,
    in plain PyTorch), only f32 rounding differs: the two outputs are
    one bf16 step apart at most (≤ 2^-7·|blocked|), plus, where the
    kernel's p may round to the other bf16 neighbour (its f32 p within
    ``ref.P_REL`` of a rounding boundary), that neighbour's gap times |v| / l
    (``flash_blocked``'s slack), plus 1e-4.

    Reported beside the time: achieved TFLOP/s, the share of the bound
    (operations at the bf16 peak), the exponential floor (the causal
    B·H·S·(S+1)/2 exponentials at 16 per clock per SM on 132 SMs, at the
    card's maximum SM clock) and SDPA's time."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_blocked,
                                                     flash_cuda, flash_ref)
    from repro_torch.kernels.flash_attention.ref import P_REL
    dev = torch.device("cuda")
    H, KH, Dh = 32, 8, 64
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for B, S in FLASH_SHAPES:
        q = torch.randn(B, S, H, Dh, generator=g, device=dev).bfloat16()
        k = torch.randn(B, S, KH, Dh, generator=g, device=dev).bfloat16()
        v = torch.randn(B, S, KH, Dh, generator=g, device=dev).bfloat16()

        def sdpa():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True).transpose(1, 2)

        got = flash_cuda(q, k, v, causal=True)
        ref = flash_ref(q, k, v, causal=True)
        abs_v = flash_ref(q.float(), k.float(), v.float().abs(), causal=True)
        blk, slack = flash_blocked(q, k, v, causal=True,
                                   p_dtype=torch.bfloat16, p_rel=P_REL)
        lib = sdpa()
        torch.cuda.synchronize()
        got32, ref32, blk32 = got.float(), ref.float(), blk.float()
        err = (got32 - ref32).abs()
        tol = 2.0 ** -7 * ref32.abs() + 2.0 ** -7 * abs_v + 1e-4
        err_b = (got32 - blk32).abs()
        tol_b = 2.0 ** -7 * blk32.abs() + slack + 1e-4
        ok = (bool((err <= tol).all()) and bool((err_b <= tol_b).all())
              and got.dtype == torch.bfloat16)
        ms = cuda_ms(torch, lambda: flash_cuda(q, k, v, causal=True), 20)
        plain = cuda_ms(torch, lambda: flash_ref(q, k, v, causal=True), 3)
        lib_ms = cuda_ms(torch, sdpa, 20)
        flops = 4 * Dh * H * B * S * (S + 1) / 2      # causal QK^T and PV
        n_bytes = 2 * (2 * B * S * H * Dh + 2 * B * S * KH * Dh)
        bms, by = bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)
        n_exp = B * H * S * (S + 1) / 2
        res = dict(name="flash_attention", B=B, S=S, H=H, KH=KH, Dh=Dh,
                   dtype="bfloat16", causal=True,
                   max_abs_err=float(err.max()),
                   max_rel_err=float((err / ref32.abs().clamp_min(1e-30))
                                     .max()),
                   tol_max=float(tol.max()),
                   worst_err_over_tol=float((err / tol).max()),
                   vs_blocked_max_abs_err=float(err_b.max()),
                   vs_blocked_worst_err_over_tol=float((err_b / tol_b).max()),
                   library_max_abs_err=float((lib.float() - ref32).abs()
                                             .max()),
                   gflop=flops / 1e9, mbytes=n_bytes / 1e6, ms=ms,
                   tflop_per_s=flops / ms / 1e9,
                   plain_ms=plain, bound_ms=bms, bound_by=by,
                   share_of_bound=bms / ms,
                   exp_floor_ms=n_exp / (EX2_PER_CLOCK * clock_hz) * 1e3,
                   library="scaled_dot_product_attention", library_ms=lib_ms,
                   ok=ok)
        log("kernel", **res)
        if not ok:
            raise RuntimeError(f"kernel E disagrees with its plain versions: "
                               f"{res}")
        rows.append(res)
        del q, k, v, got, ref, abs_v, blk, slack, lib, got32, ref32, blk32
        del err, tol, err_b, tol_b
        torch.cuda.empty_cache()
    return rows[0]


def phase_kernel_d(torch, coords, lam_np):
    """Kernel D at the single-ingress GREEDY seed of the engine's 10⁵
    catalog: R = O = 10⁵, D = 100, J = 3, cur = h_repo, every H row
    (0, 15, 150). Tolerance as kernel C's (each term moves by at most
    λ_r times its pair's C_a tolerance, plus 1e-4 relative for the two
    f32 sums over R). On these inputs D computes C's function at I = 1,
    in C's order, so the two must agree bit for bit. Then the entry point,
    ``greedy_gain``, runs once with the launch counts zeroed: D's path."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.gain import gain_cuda, gain_ref, greedy_gain
    from repro_torch.kernels.knn.gains import gains_cuda
    dev = torch.device("cuda")
    x = torch.as_tensor(coords, device=dev)
    lam = torch.as_tensor(lam_np, dtype=torch.float32, device=dev)
    lam = lam.reshape(-1)
    cur = torch.full_like(lam, 1000.0)
    h1 = torch.tensor([[0.0, 15.0, 150.0]], device=dev)
    hr = h1.expand(x.shape[0], 3).contiguous()
    got = gain_cuda(x, x, lam, cur, hr, "l2")
    ref = gain_ref(x, x, lam, cur, hr, "l2").T
    c = gains_cuda(x, x, lam[None], cur[None], h1, "l2")
    torch.cuda.synchronize()
    err = (got - ref).abs()
    tol = gain_tolerance(torch, x, lam[None]) + 1e-4 * ref.abs()
    ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all())
    call = lambda: gain_cuda(x, x, lam, cur, hr, "l2")  # noqa: E731
    ms = cuda_ms(torch, call, 3)
    dev_t = device_ms(torch, call, 3, "gains_kernel")
    plain = cuda_ms(torch, lambda: gain_ref(x, x, lam, cur, hr, "l2"), 1,
                    warmup=0)
    reset_launch_counts()                        # D's own path
    out = greedy_gain(x, x, lam, cur, hr, "l2")
    torch.cuda.synchronize()
    launches = launch_counts()["greedy_gain"]
    R, D = x.shape
    J = 3
    bms, by = bound_ms(4 * (2 * R * D + 2 * R + R * J + J * R),
                       2 * R * R * D + R * R * (3 + 3 * J))
    res = dict(name="greedy_gain", R=R, O=R, D=D, J=J,
               **_gain_plan_fields(torch, R, D, 1, J, True),
               max_abs_err=float(err.max()),
               max_rel_err=float((err / ref.abs().clamp_min(1e-30)).max()),
               tol_max=float(tol.max()),
               vs_kernel_c_max_abs_diff=float((got - c).abs().max()),
               vs_kernel_c_bitwise=bool(torch.equal(got, c)),
               entry_point_shape=list(out.shape), launches=launches,
               ms=ms, **dev_t, share_of_bound=bms / dev_t["device_ms"],
               plain_ms=plain, bound_ms=bms, bound_by=by,
               library_ms=None, ok=ok)
    log("kernel", **res)
    if not ok or launches != 1 or not res["vs_kernel_c_bitwise"]:
        raise RuntimeError(f"kernel D disagrees: {res}")
    return res


# J of the P7 checks: the reference's scenario networks have 17–32 caches
GAIN_GROUP_J = (9, 17, 32)


def _j_slices(J):
    """Each group of 8 caches, and slices of at most 8 across groups."""
    from repro_torch.kernels.knn.gains import J_GROUP, _j_groups
    out = _j_groups(J)
    out += [(a, min(J, a + w)) for a, w in ((4, 8), (7, 2), (J - 3, 3),
                                           (J // 2, 5))]
    return sorted({s for s in out if s[1] - s[0] <= J_GROUP})


def phase_gain_groups(torch, coords, lam_np):
    """Kernels C and D past 8 caches (ROADMAP P7): C at I = 4 ingresses
    and J 9, 17 and 32 (the reference's scenario networks have 17–32
    caches), D at J 9, on the stream phase's catalog (R = O = 20,000,
    D 100), cur 1000, H random in [0, 300) with every 7th entry off the
    path. Each call is ⌈J/8⌉ launches, held against its plain version
    (kernel C's tolerance, summed over the ingresses) and bitwise against
    J ≤ 8 slices of H (the groups, and slices across them). Device times
    per call; each group recomputes the C_a tile, so the bound is that
    of the function (the tile once)."""
    from repro_torch.kernels.gain import gain_cuda, gain_ref
    from repro_torch.kernels.knn.gains import (H_SENTINEL, _gains_tiles,
                                               _j_groups, gains_cuda)
    dev = torch.device("cuda")
    x = torch.as_tensor(coords, device=dev)
    R, D = x.shape
    lam = torch.as_tensor(lam_np, dtype=torch.float32, device=dev)
    I = lam.shape[0]
    cur = torch.full_like(lam, 1000.0)
    tol_pair = gain_tolerance(torch, x, lam).sum(0, keepdim=True)
    rng = np.random.default_rng(7)
    rows = []
    for J in GAIN_GROUP_J:
        H = torch.as_tensor(rng.random((I, J), dtype=np.float32) * 300.0,
                            device=dev)
        H.view(-1)[::7] = H_SENTINEL
        n0 = gains_cuda.launches
        got = gains_cuda(x, x, lam, cur, H, "l2")
        launches = gains_cuda.launches - n0
        ref = _gains_tiles(x, x, lam, cur, H, "l2", 1.0).T
        sliced = all(torch.equal(gains_cuda(x, x, lam, cur,
                                            H[:, a:b].contiguous(), "l2"),
                                 got[a:b]) for a, b in _j_slices(J))
        torch.cuda.synchronize()
        err = (got - ref).abs()
        tol = tol_pair + 1e-4 * ref.abs()
        call = lambda: gains_cuda(x, x, lam, cur, H, "l2")  # noqa: E731
        dev_t = device_ms(torch, call, 2, "gains_kernel")
        bms, by = bound_ms(4 * (2 * R * D + 2 * I * R + I * J + J * R),
                           2 * R * R * D + R * R * (3 + 3 * I * J))
        rows.append(dict(kernel="C", R=R, O=R, D=D, I=I, J=J,
                         groups=_j_groups(J), launches=launches,
                         max_abs_err=float(err.max()),
                         tol_max=float(tol.max()),
                         slices_bitwise=sliced, ms=cuda_ms(torch, call, 2),
                         **dev_t, bound_ms=bms, bound_by=by,
                         share_of_bound=bms / dev_t["device_ms"],
                         ok=bool((err <= tol).all()) and sliced
                         and launches == len(_j_groups(J))
                         and bool(torch.isfinite(got).all())))
        del got, ref, err, tol
    J = 9
    hr = torch.as_tensor(rng.random((R, J), dtype=np.float32) * 300.0,
                         device=dev)
    hr[::5, 3] = H_SENTINEL
    n0 = gain_cuda.launches
    got = gain_cuda(x, x, lam[0], cur[0], hr, "l2")
    launches = gain_cuda.launches - n0
    ref = gain_ref(x, x, lam[0], cur[0], hr, "l2").T
    sliced = all(torch.equal(gain_cuda(x, x, lam[0], cur[0],
                                       hr[:, a:b].contiguous(), "l2"),
                             got[a:b]) for a, b in _j_slices(J))
    torch.cuda.synchronize()
    err = (got - ref).abs()
    tol = gain_tolerance(torch, x, lam[:1]) + 1e-4 * ref.abs()
    rows.append(dict(kernel="D", R=R, O=R, D=D, I=1, J=J,
                     launches=launches, max_abs_err=float(err.max()),
                     tol_max=float(tol.max()), slices_bitwise=sliced,
                     ok=bool((err <= tol).all()) and sliced
                     and launches == 2))
    log("gain_groups", rows=rows)
    if not all(r["ok"] for r in rows):
        raise RuntimeError(f"kernels C and D past 8 caches failed: {rows}")
    return rows


DUEL_T, DUEL_WINDOW, DUEL_ARM = 4096, 256, 0.25


def _duel_bound(torch, objs, arm_flags, K, D, I):
    """Kernel F's bound for a window, from this run's data: each armed
    duel is priced from the step after its arming to its expiry (every
    free-slot count stays positive here: at most ``DUEL_WINDOW``·p duels
    are armed at once, far below K), each pricing a streamed chain of 3·D
    operations and 5 more (sqrt, + h, − b1, max, + vs). Bytes: the
    window (objs, ings, ts 8 B, the flag 1 B, the draw 4 B a step), the
    rows of C_a's objects (the requested ones; the virtuals are
    requested objects too), each requested (i, o) entry of best1, arg1
    and best2, h_slots, the carry read and written, and the served cost
    written."""
    T = len(objs)
    arms = np.nonzero(arm_flags)[0]
    starts = np.zeros(T + DUEL_WINDOW + 2, np.int64)
    np.add.at(starts, arms + 1, 1)
    np.add.at(starts, arms + DUEL_WINDOW + 1, -1)
    priced = int(np.cumsum(starts)[:T].sum())
    distinct = len(np.unique(objs))
    n_bytes = 29 * T + distinct * (4 * D + 16) + 4 * I * K + 2 * 32 * K \
        + 4 * T
    return bound_ms(n_bytes, priced * (3 * D + 5)) + (priced,)


def phase_duel(torch, cat, dem, clock_hz: float):
    """Kernel F at the engine's scale: the 10⁵-object catalog, its
    Zipf(0.8) demand, its three levels (64 / 128 / 256 slots, K = 448,
    h = 0 / 15 / 150, h_repo 1000), C_a streamed (``materialize_ca=False``,
    the engine's duel plane), from ``random_slots`` so that duels
    promote. The scan runs over 4,096 requests with window 256 once
    through F (counted) and once through ``_duel_scan_ref``, both on the
    card; every output must be bitwise equal (events, slots, virt,
    deadlines, both savings, the per-step served cost), with at least one
    promotion. The public entry, ``device_netduel``, must give the same.
    Times: each scan over the window (host included, re-arms included),
    per request; the re-arms alone; F's device time (torch.profiler).
    Beside the bound from the card's rates, the chain floor: a step's
    streamed pricing is one chain of D dependent rounded adds (4 clocks
    each at the card's maximum SM clock), and the steps run in order."""
    import importlib

    from repro_torch.core.objective import DeviceInstance, Instance
    from repro_torch.core.placement import device_netduel
    from repro_torch.core.placement.localswap import emulated_stream
    from repro_torch.core.topology import tpu_hierarchy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    nd = importlib.import_module("repro_torch.core.placement.netduel")
    net = tpu_hierarchy(64, 128, 256, 15.0, 150.0, 1000.0)
    inst = Instance(net=net, cat=cat, dem=dem)
    t0 = time.perf_counter()
    dinst = DeviceInstance.from_instance(inst, materialize_ca=False)
    rng, slots0, objs, ings = emulated_stream(inst, DUEL_T, 0)
    arm_draws, slot_draws = nd._duel_draws(rng, DUEL_T)
    arm_flags = arm_draws < DUEL_ARM
    h_slots, on_path = nd._scan_args(dinst)
    xs = nd._duel_xs(objs, ings, 0, arm_flags, slot_draws,
                     device=dinst.device)
    carry0 = nd._duel_carry(dinst, slots0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    one_delta = float(np.float32(1.05))

    def scan(kernel, timings=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = nd._duel_scan(dinst, h_slots, on_path, carry0, xs, one_delta,
                            DUEL_WINDOW, True, False, 0, kernel=kernel,
                            timings=timings)
        torch.cuda.synchronize()
        return (*out, time.perf_counter() - t)

    timings = {}
    reset_launch_counts()                        # F's own run
    kc, ko, k_s = scan(True, timings)
    launches = launch_counts()["duel_scan"]
    pc, po, p_s = scan(False)
    fields = list(nd.DuelCarry._fields)
    carry_equal = {f: bool(torch.equal(a, b))
                   for f, a, b in zip(fields, kc, pc)}
    b1_equal = bool(torch.equal(ko.b1, po.b1))
    events_equal = len(ko.events) == len(po.events) and all(
        ek[0] == ep[0] and all(torch.equal(a, b)
                               for a, b in zip(ek[1:], ep[1:]))
        for ek, ep in zip(ko.events, po.events))
    diffs = [float((a.double() - b.double()).abs().max())
             for a, b in ((kc.real_sav, pc.real_sav),
                          (kc.virt_sav, pc.virt_sav), (ko.b1, po.b1))]
    n_prom = int(kc.n_prom.sum())
    promoting_steps = len(ko.events)
    # the public entry point: the same draws, the same result
    st = device_netduel(dinst, n_iters=DUEL_T, seed=0, window=DUEL_WINDOW,
                        arm_prob=DUEL_ARM)
    entry_equal = (np.array_equal(st.slots, kc.slots.cpu().numpy())
                   and np.array_equal(st.virt_sav, kc.virt_sav.cpu().numpy())
                   and st.n_promotions == n_prom)
    dev_t = device_ms(torch, lambda: scan(True), 1, "duel_scan_kernel")
    K, D, I = h_slots.shape[1], cat.dim, h_slots.shape[0]
    bms, by, priced = _duel_bound(torch, objs, arm_flags, K, D, I)
    res = dict(name="duel_scan", catalog=cat.n, dim=D, K=K, T=DUEL_T,
               window=DUEL_WINDOW, arm_prob=DUEL_ARM, setup_s=setup_s,
               promotions=n_prom, promoting_steps=promoting_steps,
               launches=launches, carry_bitwise=carry_equal,
               b1_bitwise=b1_equal, events_bitwise=events_equal,
               entry_point_equal=entry_equal,
               max_abs_err=max(diffs), ms=k_s * 1e3, plain_ms=p_s * 1e3,
               ms_per_request=k_s * 1e3 / DUEL_T,
               plain_ms_per_request=p_s * 1e3 / DUEL_T,
               rearm_ms=timings.get("rearm_s", 0.0) * 1e3,
               rearms=timings.get("rearms", 0),
               kernel_device_ms=dev_t["device_ms"],
               kernel_device_ms_per_request=dev_t["device_ms"] / DUEL_T,
               priced_duels=priced, bound_ms=bms, bound_by=by,
               chain_floor_ms=DUEL_T * D * 4 / clock_hz * 1e3,
               library_ms=None)
    log("duel", **res)
    ok = (all(carry_equal.values()) and b1_equal and events_equal
          and entry_equal and n_prom > 0 and max(diffs) == 0.0
          and launches == promoting_steps + (
              0 if ko.events and ko.events[-1][0] == DUEL_T - 1 else 1))
    if not ok:
        raise RuntimeError(f"kernel F disagrees with the plain scan: {res}")
    return res


def phase_duel_engine(torch, params):
    """The online plane on the serving path, at full width: the ``stream``
    phase's engine (granite-3-2b, 40 layers, flash attention, the
    20,000-object catalog, 4 Zipf(1.0) streams) with ``netduel`` and
    ``refresh_on_promotion``: 1,024 cold requests, ``refresh_placement()``
    (which arms the duel plane), 4,096 warm requests behind
    ``StreamDriver``, ``drain_refresh()``. The launch counts are zeroed
    just before and read just after. Every batch each duel plane observed
    (objects, the lookup's b1 at the bucket shape, n_valid) is recorded;
    outside the counted run each plane's batches are replayed through a
    second ``DuelPlane`` on the plain scan, whose carry must equal the
    engine plane's bitwise."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import catalog as catalog_api
    from repro_torch.core import demand as demand_api
    from repro_torch.core.placement import DuelPlane
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import (EngineConfig, SimCacheEngine,
                                   StreamDriver, StreamSpec)

    cfg = dataclasses.replace(get_config("granite-3-2b"),
                              use_flash_attention=True)
    cat = catalog_api.embedding_catalog(n=20_000, dim=100, seed=1)
    ecfg = EngineConfig(h_ici=15.0, h_dcn=150.0, h_model=1000.0,
                        netduel=True, refresh_on_promotion=True)
    eng = SimCacheEngine(cfg, params, ecfg, cat.coords)
    planes = []
    arm = eng._arm_duel

    def recording_arm(inst, slots):
        arm(inst, slots)
        rec = dict(plane=eng.duel, slots0=np.asarray(slots).copy(),
                   batches=[])
        observe = eng.duel.observe

        def recording_observe(objs, ings=None, b1_ext=None, n_valid=None):
            rec["batches"].append((np.asarray(objs).copy(),
                                   b1_ext.detach().clone(), n_valid))
            return observe(objs, ings, b1_ext, n_valid)
        eng.duel.observe = recording_observe
        planes.append(rec)
    eng._arm_duel = recording_arm
    streams = [StreamSpec(demand=demand_api.zipf(cat, alpha=1.0, seed=s + 1),
                          rate=1.0 + s, seed=s + 1, name=f"stream{s}")
               for s in range(4)]
    drv = StreamDriver(eng, streams, max_batch=256, batch_window=2.0,
                       prompt_len=128, refresh_every=0)
    reset_launch_counts()                        # the main path's run
    t0 = time.perf_counter()
    cold = drv.run(1024)
    cold_stats, eng.stats = eng.stats, type(eng.stats)()
    pred = eng.refresh_placement()
    warm = drv.run(4096)
    t = time.perf_counter()
    drained = drv.drain_refresh()
    drain_s = time.perf_counter() - t
    counts = launch_counts()                      # read just after
    phase_s = time.perf_counter() - t0
    w = eng.stats

    held = []
    t = time.perf_counter()
    for rec in planes:
        p = rec["plane"]
        twin = DuelPlane(p.dinst, rec["slots0"], window=ecfg.duel_window,
                         delta=ecfg.duel_delta, arm_prob=ecfg.duel_arm_prob,
                         seed=ecfg.duel_seed, plain=True)
        for objs, b1, n_valid in rec["batches"]:
            twin.observe(objs, b1_ext=b1, n_valid=n_valid)
        held.append(dict(
            batches=len(rec["batches"]), promotions=p.n_promotions,
            carry_bitwise=all(torch.equal(a, b)
                              for a, b in zip(p.carry, twin.carry)),
            served_equal=p.served_cost == twin.served_cost,
            t_equal=p.t == twin.t))
    replay_s = time.perf_counter() - t
    res = dict(model=cfg.name, n_layers=cfg.n_layers, catalog=cat.n,
               streams=len(streams), duel_window=ecfg.duel_window,
               cold=dict(requests=cold.n_requests, batches=cold.n_batches,
                         p50_ms=cold.p50_ms, hit_rate=cold_stats.hit_rate),
               predicted_cost=pred,
               warm=dict(requests=warm.n_requests, batches=warm.n_batches,
                         req_per_s=warm.requests_per_s, p50_ms=warm.p50_ms,
                         p95_ms=warm.p95_ms, p99_ms=warm.p99_ms,
                         hit_rate=w.hit_rate, mean_cost=w.mean_cost,
                         placement_events=warm.placement_events,
                         swaps_in_run=warm.swaps),
               placement_events=eng.placement_events,
               n_promotions=sum(r["plane"].n_promotions for r in planes),
               duel_planes=len(planes), drain=dict(swapped=drained,
                                                   seconds=drain_s),
               swaps=eng.swap_count, launches=counts, phase_s=phase_s,
               held_against_plain=held, replay_s=replay_s)
    log("duel_engine", **res)
    checks = [counts["duel_scan"] > 0, counts["fused_lookup"] > 0,
              counts["flash_attention"] > 0, w.hit_rate > 0,
              w.mean_cost < ecfg.h_model, not eng.refresh_in_flight,
              any(h["batches"] for h in held),
              all(h["carry_bitwise"] and h["served_equal"] and h["t_equal"]
                  for h in held)]
    if not all(checks):
        raise RuntimeError(f"duel_engine phase failed its checks: {checks}")
    return counts


def _logit_diff(torch, a, b):
    a, b = a.float(), b.float()
    return (float((a - b).abs().max()),
            float((a.argmax(-1) == b.argmax(-1)).float().mean()))


def phase_prefill(torch):
    """granite-3-2b at full width, B = 2, S = 2048, on one set of random
    weights: the prefill with ``use_flash_attention`` on (kernel E) and
    off (plain attention), in bf16 and in f32 compute. Tolerances: in
    f32 the two attentions agree to f32 rounding, so the logits (of
    order 1) to 1e-3; in bf16 flash-vs-plain must differ by no more than
    bf16 itself moves the plain logits away from f32 (the same forward
    computed in f32): kernel E adds no error beyond the compute type's
    own. Returns the weights for the ``stream`` phase."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import flash_cuda
    from repro_torch.models.model import init_params, make_prefill

    cfg = get_config("granite-3-2b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S = 2, 2048
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S)), device="cuda")
    batch = {"tokens": toks}
    logits, times, flash_launches, by_dtype = {}, {}, {}, {}
    for dt in ("bfloat16", "float32"):
        for flash in (True, False):
            run_cfg = dataclasses.replace(cfg, compute_dtype=dt,
                                          use_flash_attention=flash)
            pre = make_prefill(run_cfg)
            before = dict(flash_cuda.launches_by_dtype)
            reset_launch_counts()
            out, _ = pre(params, batch)
            torch.cuda.synchronize()
            flash_launches[(dt, flash)] = launch_counts()["flash_attention"]
            by_dtype[(dt, flash)] = {
                str(t).removeprefix("torch."): n - before[t]
                for t, n in flash_cuda.launches_by_dtype.items()}
            logits[(dt, flash)] = out
            times[(dt, flash)] = cuda_ms(torch, lambda: pre(params, batch),
                                         2, warmup=0)
    d_bf16, top1_bf16 = _logit_diff(torch, logits[("bfloat16", True)],
                                    logits[("bfloat16", False)])
    d_f32, top1_f32 = _logit_diff(torch, logits[("float32", True)],
                                  logits[("float32", False)])
    d_noise, top1_noise = _logit_diff(torch, logits[("bfloat16", False)],
                                      logits[("float32", False)])
    shape_ok = all(tuple(v.shape) == (B, S, cfg.padded_vocab)
                   and bool(torch.isfinite(v.float()).all())
                   for v in logits.values())
    res = dict(model=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               B=B, S=S, init_s=init_s,
               bf16=dict(flash_ms=times[("bfloat16", True)],
                         plain_ms=times[("bfloat16", False)],
                         max_abs_logit_diff=d_bf16, top1_agreement=top1_bf16,
                         tol=d_noise),
               f32=dict(flash_ms=times[("float32", True)],
                        plain_ms=times[("float32", False)],
                        max_abs_logit_diff=d_f32, top1_agreement=top1_f32,
                        tol=1e-3),
               bf16_vs_f32_plain=dict(max_abs_logit_diff=d_noise,
                                      top1_agreement=top1_noise),
               flash_launches_per_forward=flash_launches[("bfloat16", True)],
               plain_forward_flash_launches=flash_launches[("bfloat16",
                                                            False)],
               flash_launches_by_dtype={f"{dt} flash": by_dtype[(dt, True)]
                                        for dt in ("bfloat16", "float32")},
               shape_ok=shape_ok)
    log("prefill", **res)
    checks = [shape_ok, d_f32 <= 1e-3, d_bf16 <= d_noise,
              flash_launches[("bfloat16", True)] == cfg.n_layers,
              flash_launches[("float32", True)] == cfg.n_layers,
              flash_launches[("bfloat16", False)] == 0,
              # bf16 reaches the tensor-core kernel, f32 the CUDA-core one
              by_dtype[("bfloat16", True)]["bfloat16"] == cfg.n_layers,
              by_dtype[("float32", True)]["float32"] == cfg.n_layers]
    if not all(checks):
        raise RuntimeError(f"prefill phase failed its checks: {checks}")
    return params


def phase_stream(torch, params):
    """The engine with ``use_flash_attention=True`` behind the streaming
    driver, on the ``prefill`` phase's full-width weights."""
    from repro_torch import tracecount
    from repro_torch.configs.registry import get_config
    from repro_torch.core import catalog as catalog_api
    from repro_torch.core import demand as demand_api
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import (EngineConfig, SimCacheEngine,
                                   StreamDriver, StreamSpec, bucket_size)

    cfg = dataclasses.replace(get_config("granite-3-2b"),
                              use_flash_attention=True)
    cat = catalog_api.embedding_catalog(n=20_000, dim=100, seed=1)
    ecfg = EngineConfig(h_ici=15.0, h_dcn=150.0, h_model=1000.0)
    eng = SimCacheEngine(cfg, params, ecfg, cat.coords)
    streams = [StreamSpec(demand=demand_api.zipf(cat, alpha=1.0, seed=s + 1),
                          rate=1.0 + s, seed=s + 1, name=f"stream{s}")
               for s in range(4)]
    drv = StreamDriver(eng, streams, max_batch=256, batch_window=2.0,
                       prompt_len=128, refresh_every=0)
    refresh_every = 32
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                        # the main path's run
    t0 = time.perf_counter()
    with tracecount.snapshot() as snap:
        cold = drv.run(2048)
        cold_stats, eng.stats = eng.stats, type(eng.stats)()
        t = time.perf_counter()
        pred = eng.refresh_placement()
        refresh_s = time.perf_counter() - t
        drv.refresh_every = refresh_every
        warm = drv.run(4096)
        t = time.perf_counter()
        drained = drv.drain_refresh()
        drain_s = time.perf_counter() - t
        signatures = snap.delta("fused_lookup")
    counts = launch_counts()                      # read just after
    phase_s = time.perf_counter() - t0
    w = eng.stats
    buckets = sorted({bucket_size(n, ecfg.min_bucket)
                      for n in warm.batch_sizes})
    res = dict(model=cfg.name, n_layers=cfg.n_layers, catalog=cat.n,
               dim=cat.dim, streams=len(streams), max_batch=256,
               batch_window=2.0, prompt_len=128,
               cold=dict(requests=cold.n_requests, batches=cold.n_batches,
                         req_per_s=cold.requests_per_s, p50_ms=cold.p50_ms,
                         p95_ms=cold.p95_ms, p99_ms=cold.p99_ms,
                         hit_rate=cold_stats.hit_rate,
                         mean_cost=cold_stats.mean_cost,
                         model_calls=cold_stats.model_calls),
               refresh_s=refresh_s, predicted_cost=pred,
               solve=dict(eng.solve_timings),
               warm=dict(requests=warm.n_requests, batches=warm.n_batches,
                         req_per_s=warm.requests_per_s, p50_ms=warm.p50_ms,
                         p95_ms=warm.p95_ms, p99_ms=warm.p99_ms,
                         hit_rate=w.hit_rate, mean_cost=w.mean_cost,
                         model_calls=w.model_calls,
                         distinct_batch_sizes=warm.distinct_batch_sizes,
                         buckets=buckets,
                         refresh_every=refresh_every,
                         refreshes_started=warm.refreshes_started,
                         swaps_in_run=warm.swaps,
                         max_swap_stall_ms=warm.max_swap_stall_s * 1e3),
               drain=dict(swapped=drained, seconds=drain_s),
               swaps=eng.swap_count, fused_lookup_signatures=signatures,
               launches=counts, phase_s=phase_s,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30)
    log("stream", **res)
    checks = [counts["flash_attention"] > 0, counts["fused_lookup"] > 0,
              eng.swap_count >= 1, w.hit_rate > 0,
              w.mean_cost < ecfg.h_model, signatures <= len(buckets),
              warm.refreshes_started >= 1, not eng.refresh_in_flight]
    if not all(checks):
        raise RuntimeError(f"stream phase failed its checks: {checks}")
    return counts


SCENARIO_CATALOG = dict(n=20_000, dim=100, seed=1)   # the stream's
SCENARIO_BUDGET = 448                                # the engine's K
SCENARIO_REQUESTS, SCENARIO_BATCH, SCENARIO_SEQ = 4096, 256, 128


def rescaled_catalog(net, n: int, dim: int, seed: int):
    """``embedding_catalog(n, dim, seed)`` scaled by the reference
    hit-rate bench's rule (``rescaled_coords``), so that C_a is on the
    network's cost scale; returns the scaled f32 coordinates, θ and the
    unscaled catalog."""
    from repro_torch.core import catalog as catalog_api
    from repro_torch.core.analysis import rescaled_coords
    cat = catalog_api.embedding_catalog(n=n, dim=dim, seed=seed)
    coords, theta = rescaled_coords(net, cat.coords, seed)
    return coords, theta, cat


def phase_scenario(torch, params):
    """A multi-ingress ISP-like network (37 caches, 448 slots by degree
    centrality, 4 ingresses) on the stream's catalog rescaled by the
    reference bench's rule: GREEDY on the device (kernel C in ⌈37/8⌉ = 5
    groups a call; C then held against its plain version at the seed's
    inputs, outside the counted run), then 4,096 requests in batches of
    256 through the engine's strategy plane for each of the five
    strategies, misses prefilled through kernel E. Counts are zeroed
    before each run and read after it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import demand as demand_api
    from repro_torch.core import scenarios
    from repro_torch.core.catalog import Catalog
    from repro_torch.core.objective import DeviceInstance, Instance
    from repro_torch.core.placement import device_greedy
    from repro_torch.core.routing import STRATEGIES
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.knn.gains import (H_SENTINEL, _gains_tiles,
                                               _j_groups)
    from repro_torch.serve import EngineConfig, SimCacheEngine

    sc = scenarios.scenario("isp", cache_budget=SCENARIO_BUDGET,
                            placement="degree", n_ingress=4, seed=0)
    net = sc.net
    coords, theta, cat0 = rescaled_catalog(net, **SCENARIO_CATALOG)
    cat = Catalog(coords=coords, metric="l2", gamma=1.0)
    dem = demand_api.zipf(cat0, alpha=1.0, n_ingress=net.n_ingress, seed=1)
    inst = Instance(net=net, cat=cat, dem=dem)
    dinst = DeviceInstance.from_instance(inst, materialize_ca=False)
    reset_launch_counts()                        # GREEDY's run
    t = time.perf_counter()
    slots = device_greedy(dinst)
    greedy_s = time.perf_counter() - t
    greedy_counts = launch_counts()
    picks = int((slots >= 0).sum())
    cost = float(dinst.total_cost(np.where(slots < 0, 0, slots)))
    empty = float(dinst.total_cost(np.zeros_like(slots)))

    # kernel C at the seed's inputs against its plain version (kernel C's
    # tolerance of the gain_groups phase, summed over the ingresses)
    x = dinst.coords
    lam = dinst.lam
    cur = dinst.initial_costs()
    Hs = torch.where(torch.isfinite(dinst.H), dinst.H, H_SENTINEL)
    got = dinst.gains(cur).T
    ref = _gains_tiles(x, x, lam, cur, Hs, "l2", 1.0).T
    torch.cuda.synchronize()
    err = (got - ref).abs()
    tol = gain_tolerance(torch, x, lam).sum(0, keepdim=True) \
        + 1e-4 * ref.abs()
    hold = dict(R=x.shape[0], O=x.shape[0], D=x.shape[1], I=lam.shape[0],
                J=net.n_caches, groups=len(_j_groups(net.n_caches)),
                max_abs_err=float(err.max()), tol_max=float(tol.max()),
                ok=bool((err <= tol).all()) and bool(torch.isfinite(got)
                                                     .all()))
    del got, ref, err, tol

    cfg = dataclasses.replace(get_config("granite-3-2b"),
                              use_flash_attention=True)
    rows, counts = {}, {}
    for s in STRATEGIES:
        eng = SimCacheEngine(cfg, params, EngineConfig(strategy=s),
                             coords, net=net)
        rng = np.random.default_rng(2)
        reset_launch_counts()                    # this strategy's run
        t = time.perf_counter()
        for _ in range(SCENARIO_REQUESTS // SCENARIO_BATCH):
            ids, ings = dem.sample(SCENARIO_BATCH, rng)
            prompts = torch.as_tensor(rng.integers(
                0, cfg.vocab, (SCENARIO_BATCH, SCENARIO_SEQ)),
                device="cuda")
            out, _ = eng.serve(ids, prompts, ingress_ids=ings)
            if len(out) != SCENARIO_BATCH:
                raise RuntimeError("serve() lost requests")
        seconds = time.perf_counter() - t
        counts[s] = launch_counts()
        st = eng.stats
        rows[s] = dict(hit_rate=st.hit_rate, mean_cost=st.mean_cost,
                       approx_cost=st.total_approx_cost / st.n_requests,
                       model_calls=st.model_calls, p50_ms=st.p50_ms,
                       p95_ms=st.p95_ms, seconds=seconds,
                       occupancy=int(eng.routing.occupancy().sum()),
                       launches=counts[s])
        del eng
    res = dict(net=net.name, nodes=sc.graph.n_nodes, caches=net.n_caches,
               slots=net.total_slots, ingress=net.n_ingress,
               path_lengths=[len(p) for p in sc.paths], catalog=cat.n,
               dim=cat.dim, theta=theta, demand="zipf1.0",
               greedy=dict(seconds=greedy_s, picks=picks, cost=cost,
                           empty_cost=empty, launches=greedy_counts),
               kernel_c_hold=hold, strategies=rows)
    log("scenario", **res)
    checks = [greedy_counts["placement_gains"] > 0, picks > 0,
              cost < empty, hold["ok"],
              all(c["flash_attention"] > 0 for c in counts.values()),
              all(0.0 < r["hit_rate"] < 1.0 for r in rows.values()),
              all(r["mean_cost"] <= float(net.h_repo.max())
                  for r in rows.values())]
    if not all(checks):
        raise RuntimeError(f"scenario phase failed its checks: {checks}")
    return dict(greedy=greedy_counts["placement_gains"],
                flash_attention=sum(c["flash_attention"]
                                    for c in counts.values()))


HITRATE_REQUESTS = 40_000
SURROGATE_OBJECTS = (100_000, 1_000_000)
SURROGATE_CALLS = 5


def surrogate_breakdown(torch, net, lam) -> dict:
    """Where one ``surrogate_cost`` call spends its time: a call under
    torch.profiler (the device's kernel and copy time, launches, and the
    idle share of the call's wall time), then a call with the solve and
    the pass each timed to the end of their device work (the rest is
    the host's f64 composition)."""
    import collections
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.analysis import hitrate, surrogate_cost
    surrogate_cost(net, lam)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        surrogate_cost(net, lam)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e for e in dev if e.name.startswith("Memcpy")]
    kern = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    span = lambda es: sum(e.time_range.end - e.time_range.start  # noqa
                          for e in es) / 1e3
    spent = collections.Counter()
    saved = hitrate.solve_characteristic_time, hitrate._cache_pass

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] += (time.perf_counter() - t0) * 1e3
            return out
        return call
    hitrate.solve_characteristic_time = timed("solve_ms", saved[0])
    hitrate._cache_pass = timed("pass_ms", saved[1])
    try:
        t = time.perf_counter()
        surrogate_cost(net, lam)
        total = (time.perf_counter() - t) * 1e3
    finally:
        hitrate.solve_characteristic_time, hitrate._cache_pass = saved
    return dict(profiled_wall_ms=wall, kernel_ms=span(kern),
                copy_ms=span(copies), launches=len(kern),
                idle_share=1.0 - (span(kern) + span(copies)) / wall,
                split_wall_ms=total, **spent,
                host_ms=total - sum(spent.values()))


def phase_hitrate(torch):
    """The Che plane on the card: the reference's full-scale network
    (scale-free, 41 caches, 4,096 slots, 6 ingresses) on the stream's
    catalog rescaled as the reference bench rescales it (cut from 10⁶
    objects: the LSH enumeration is not ported), exact balls for SIM-LRU
    and RND-LRU, the fixed point of each against a ``StrategyPlane``
    replay of 40,000 Zipf(0.9) requests measured as the bench measures
    it (the warm half); then the engine surrogate's time a call on the
    engine's three-level hierarchy at 10⁵ and 10⁶ objects with exact-hit
    balls. The balls are also held against the CPU's on a 2,000-object
    slice of the catalog."""
    from repro_torch.core import demand as demand_api
    from repro_torch.core import scenarios, topology
    from repro_torch.core.analysis import (predict_hitrates,
                                           similarity_balls,
                                           surrogate_cost)
    from repro_torch.core.catalog import Catalog
    from repro_torch.core.routing import StrategyPlane

    sc = scenarios.scenario("scale_free", cache_budget=4096,
                            placement="degree", n_ingress=6, seed=0)
    net = sc.net
    coords, theta, cat0 = rescaled_catalog(net, **SCENARIO_CATALOG)
    dem = demand_api.zipf(cat0, alpha=0.9, n_ingress=net.n_ingress, seed=7)
    objs, ings = dem.sample(HITRATE_REQUESTS, np.random.default_rng(7))
    half = HITRATE_REQUESTS // 2
    rows = {}
    for strat, q_mode in (("sim-lru", "hard"), ("rnd-lru", "rnd")):
        torch.cuda.synchronize()
        t = time.perf_counter()
        balls = similarity_balls(coords, theta, q_mode=q_mode)
        balls_s = time.perf_counter() - t
        t = time.perf_counter()
        pred = predict_hitrates(net, dem.lam, balls)
        solve_s = time.perf_counter() - t
        pl = StrategyPlane(net, coords, strategy=strat, threshold=theta,
                           seed=7)
        t = time.perf_counter()
        dec = pl.serve(objs, ings)
        replay_s = time.perf_counter() - t
        rows[strat] = dict(
            balls_s=balls_s, mean_ball=balls.mean_size,
            max_ball=int(balls.sizes.max()), solve_s=solve_s,
            predicted_hit_rate=pred.hit_rate,
            predicted_mean_cost=pred.mean_cost, residual=pred.residual,
            replay_s=replay_s,
            replayed_warm_hit_rate=float(dec.hit[half:].mean()),
            replayed_warm_mean_cost=float(dec.cost[half:].mean()),
            finite=bool(np.isfinite(pred.occupancy).all()
                        and np.isfinite(pred.mean_cost)))
        rows[strat]["abs_gap"] = abs(rows[strat]["predicted_hit_rate"]
                                     - rows[strat]["replayed_warm_hit_rate"])
        del balls, pred
    # the exact enumeration on the card against the CPU's, on a slice
    part = coords[:2000]
    b_dev = similarity_balls(part, theta)
    b_cpu = similarity_balls(part, theta, device="cpu")
    balls_hold = dict(
        objects=2000, idx_equal=bool(np.array_equal(b_dev.idx, b_cpu.idx)),
        q_equal=bool(np.array_equal(b_dev.q, b_cpu.q)),
        dist_max_rel=float(np.max(np.abs(b_dev.dist - b_cpu.dist)
                                  / np.maximum(b_cpu.dist, 1e-30))))

    hier = topology.tpu_hierarchy(64, 128, 256, 15.0, 150.0, 1000.0)
    surrogate = {}
    for n in SURROGATE_OBJECTS:
        lam = demand_api.zipf(Catalog(coords=np.zeros((n, 1), np.float32)),
                              alpha=0.8, seed=0).lam
        ms, vals = [], set()
        for _ in range(SURROGATE_CALLS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            vals.add(surrogate_cost(hier, lam))
            ms.append((time.perf_counter() - t) * 1e3)
        surrogate[str(n)] = dict(median_ms=float(np.median(ms)), ms=ms,
                                 cost=vals.pop(), repeats_bitwise=not vals,
                                 **surrogate_breakdown(torch, hier, lam))
    res = dict(net=net.name, caches=net.n_caches, slots=net.total_slots,
               ingress=net.n_ingress, catalog=len(coords),
               dim=coords.shape[1], cut_from=1_000_000, theta=theta,
               demand="zipf0.9", requests=HITRATE_REQUESTS,
               strategies=rows, balls_hold=balls_hold, surrogate=surrogate)
    log("hitrate", **res)
    checks = [all(r["finite"] and 0.0 < r["predicted_hit_rate"] < 1.0
                  for r in rows.values()),
              all(r["mean_ball"] > 1.0 for r in rows.values()),
              balls_hold["idx_equal"], balls_hold["q_equal"],
              balls_hold["dist_max_rel"] <= 2.0 ** -23,
              all(s["repeats_bitwise"] for s in surrogate.values())]
    if not all(checks):
        raise RuntimeError(f"hitrate phase failed its checks: {checks}")


GATE_MIN_GAIN = 100.0        # 10 % of h_model 1000
GATE_PROBE, GATE_COLD = 2048, 6144
GATE_WINDOW = 4096


def phase_gate(torch, params):
    """The ``stream`` configuration with the refresh gate at 100 (10 % of
    h_model, the reference test's ratio): cold requests, then
    ``refresh_placement()`` (the gate's baseline), then a stationary
    window with a cadence of 32 batches, where every request must be
    skipped (no solve started, no swap), then a drift to uniform demand
    (``set_streams``), where a request must trigger and its solve swap
    in by the drain. The surrogate is also read at 2,048 cold requests:
    its rise from there to the baseline at 6,144 is why the baseline
    waits that long (the observed window's support still grows), and
    the stationary cadence calls that a baseline taken there would have
    let through are counted. Every surrogate call is timed and logged
    with its stage and, for a cadence call, |surrogate − baseline| and
    its margin to the gate (gate − |Δ|: positive skips); launches are
    counted over the phase."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import catalog as catalog_api
    from repro_torch.core import demand as demand_api
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import (EngineConfig, SimCacheEngine,
                                   StreamDriver, StreamSpec)

    cfg = dataclasses.replace(get_config("granite-3-2b"),
                              use_flash_attention=True)
    cat = catalog_api.embedding_catalog(**SCENARIO_CATALOG)
    ecfg = EngineConfig(h_ici=15.0, h_dcn=150.0, h_model=1000.0,
                        refresh_min_gain=GATE_MIN_GAIN)
    eng = SimCacheEngine(cfg, params, ecfg, cat.coords)
    calls = []
    stage = ["probe"]
    surrogate = eng._surrogate

    def timed_surrogate(inst):
        base = eng._surrogate_baseline
        t = time.perf_counter()
        v = surrogate(inst)
        call = dict(stage=stage[0], ms=(time.perf_counter() - t) * 1e3,
                    cost=v, requests=int(eng.counts.sum()))
        if stage[0] in ("stationary", "drift"):
            call.update(baseline=base, abs_delta=abs(v - base),
                        margin=GATE_MIN_GAIN - abs(v - base))
        calls.append(call)
        return v
    eng._surrogate = timed_surrogate
    streams = [StreamSpec(demand=demand_api.zipf(cat, alpha=1.0, seed=s + 1),
                          rate=1.0 + s, seed=s + 1, name=f"stream{s}")
               for s in range(4)]
    drv = StreamDriver(eng, streams, max_batch=256, batch_window=2.0,
                       prompt_len=128, refresh_every=0)
    times = {}
    reset_launch_counts()                        # the phase's run
    t0 = time.perf_counter()
    drv.run(GATE_PROBE)
    probe = eng._surrogate(eng.observed_instance())
    drv.run(GATE_COLD - GATE_PROBE)
    times["cold_s"] = time.perf_counter() - t0
    stage[0] = "baseline"
    t = time.perf_counter()
    eng.refresh_placement()
    times["refresh_s"] = time.perf_counter() - t
    base = eng._surrogate_baseline
    drv.refresh_every = 32
    stage[0] = "stationary"
    t = time.perf_counter()
    stat = drv.run(GATE_WINDOW)
    times["stationary_s"] = time.perf_counter() - t
    in_flight_after_stationary = eng.refresh_in_flight
    swaps_stationary = eng.swap_count
    drv.set_streams([StreamSpec(demand=demand_api.uniform(cat), rate=5.0,
                                seed=99, name="uniform")])
    stage[0] = "drift"
    t = time.perf_counter()
    drift = drv.run(GATE_WINDOW)
    times["drift_s"] = time.perf_counter() - t
    t = time.perf_counter()
    drained = drv.drain_refresh()
    times["drain_s"] = time.perf_counter() - t
    counts = launch_counts()                      # read just after
    times["phase_s"] = time.perf_counter() - t0

    def window(st):
        return dict(requests=st.n_requests, batches=st.n_batches,
                    refresh_skipped=st.refresh_skipped,
                    refresh_triggered=st.refresh_triggered,
                    refreshes_started=st.refreshes_started, swaps=st.swaps,
                    req_per_s=st.requests_per_s, p50_ms=st.p50_ms,
                    p95_ms=st.p95_ms)
    gate_ms = [c["ms"] for c in calls]
    st_calls = [c for c in calls if c["stage"] == "stationary"]
    dr_calls = [c for c in calls if c["stage"] == "drift"]
    margins = dict(
        # the least room any stationary call left below the gate
        stationary_min_margin=min((c["margin"] for c in st_calls),
                                  default=None),
        # the drift calls that skipped, and by how little the last did
        drift_skipped_margins=[c["margin"] for c in dr_calls
                               if c["margin"] > 0],
        # by how much the first triggering drift call crossed the gate
        drift_trigger_excess=next((-c["margin"] for c in dr_calls
                                   if c["margin"] <= 0), None),
        # stationary calls that a baseline at GATE_PROBE requests would
        # have triggered (|cost − probe| ≥ gate); the first starts a solve
        stationary_triggers_at_probe_baseline=sum(
            int(abs(c["cost"] - probe) >= GATE_MIN_GAIN) for c in st_calls))
    res = dict(model=cfg.name, catalog=cat.n, dim=cat.dim,
               refresh_min_gain=GATE_MIN_GAIN, cold_requests=GATE_COLD,
               surrogate_at_probe=dict(requests=GATE_PROBE, cost=probe,
                                       rise_to_baseline=base - probe),
               baseline=base, margins=margins, stationary=window(stat),
               drift=window(drift), drained=drained,
               swaps=eng.swap_count, hit_rate=eng.stats.hit_rate,
               mean_cost=eng.stats.mean_cost,
               surrogate_calls=calls,
               surrogate_median_ms=float(np.median(gate_ms)),
               launches=counts, **times)
    log("gate", **res)
    checks = [stat.refresh_skipped > 0, stat.refreshes_started == 0,
              stat.refresh_triggered == 0, stat.swaps == 0,
              swaps_stationary == 0, not in_flight_after_stationary,
              drift.refresh_triggered > 0,
              drift.refreshes_started == drift.refresh_triggered,
              eng.swap_count > 0, not eng.refresh_in_flight,
              counts["fused_lookup"] > 0, counts["flash_attention"] > 0,
              counts["placement_gains"] > 0]
    if not all(checks):
        raise RuntimeError(f"gate phase failed its checks: {checks}")
    return counts


def phase_launch():
    """The command-line entry point, as a user runs it, in a subprocess
    of its own (its kernel launches are its own, counted nowhere): the
    batch loop, streaming, streaming with ``--netduel``, whose printout
    must carry the duel churn, the batch loop with ``--warm-start``, and
    ``--scenario scale_free --strategy lce`` in both loops, whose
    printout must name the scenario."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = []
    for extra in (["--requests", "256"],
                  ["--streaming", "--streams", "4", "--requests", "1024"],
                  ["--streaming", "--streams", "4", "--requests", "1024",
                   "--netduel"],
                  ["--requests", "256", "--warm-start"],
                  ["--scenario", "scale_free", "--strategy", "lce",
                   "--requests", "256"],
                  ["--scenario", "scale_free", "--strategy", "lce",
                   "--streaming", "--requests", "1024"]):
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               "granite-3-2b", *extra]
        t = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=600)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("[serve]")]
        final = next((ln for ln in reversed(lines) if "hit-rate" in ln), None)
        runs.append(dict(args=extra, rc=p.returncode,
                         seconds=time.perf_counter() - t, serve_lines=lines))
        if final:
            print(final, flush=True)
        churn = "--netduel" not in extra or any(
            "duel churn" in ln for ln in lines)
        named = "--scenario" not in extra or any(
            "[serve] scenario scale_free" in ln for ln in lines)
        if p.returncode != 0 or final is None or not churn or not named:
            log("launch", runs=runs, stderr_tail=p.stderr[-3000:])
            raise RuntimeError(f"the launcher failed: {' '.join(extra)}")
    log("launch", runs=runs)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e}); run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    from repro_torch.core import catalog as catalog_api
    from repro_torch.core import demand as demand_api

    t_start = time.perf_counter()
    kind, clock_hz = phase_device(torch)
    phase_build()
    # the repo's emulation of the paper's §6.2 Amazon embeddings at the
    # 10⁵-object scale, Zipf(0.8) demand
    cat = catalog_api.embedding_catalog(n=100_000, dim=100, seed=0)
    dem = demand_api.zipf(cat, alpha=0.8, seed=0)
    rng = np.random.default_rng(0)
    a = phase_kernel_a(torch, cat.coords, rng, 256, 448)
    a_big = phase_kernel_a(torch, cat.coords, rng, 256, 65536)
    for q_bucket in (8, 16, 32, 64):             # the stream's buckets
        phase_kernel_a(torch, cat.coords, rng, q_bucket, 448)
    b = phase_kernel_b(torch, cat.coords, rng, 256, 448)
    b_big = phase_kernel_b(torch, cat.coords, rng, 256, 65536)
    for r in (a_big, b_big):
        if not r["ms"] < r["library_ms"]:
            raise RuntimeError(f"kernel {r['name']} at K 65,536 is slower "
                               f"than the matmul form: {r}")
    c = phase_kernel_c(torch, cat.coords, dem.lam)
    # the stream phase's catalog and its first stream's demand
    scat = catalog_api.embedding_catalog(n=20_000, dim=100, seed=1)
    c_stream = phase_kernel_c(torch, scat.coords,
                              demand_api.zipf(scat, alpha=1.0, seed=1).lam)
    d = phase_kernel_d(torch, cat.coords, dem.lam)
    groups = phase_gain_groups(
        torch, scat.coords,
        demand_api.zipf(scat, alpha=1.0, n_ingress=4, seed=1).lam)
    e = phase_kernel_e(torch, clock_hz)
    phase_stable(torch, cat.coords)
    phase_bigcache(torch, cat, dem)
    f = phase_duel(torch, cat, dem, clock_hz)
    counts, params, cascade = phase_engine(torch, cat, dem)
    warm_counts = phase_warmstart(torch, cat, dem, params, cascade)
    del params
    gc.collect()                                  # the engine's model
    torch.cuda.empty_cache()
    phase_warm_1e6(torch)
    params = phase_prefill(torch)
    stream_counts = phase_stream(torch, params)
    duel_counts = phase_duel_engine(torch, params)
    scenario_counts = phase_scenario(torch, params)
    phase_hitrate(torch)
    gate_counts = phase_gate(torch, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase_launch()
    counts["greedy_gain"] = d["launches"]         # its entry point's run
    counts["flash_attention"] = stream_counts["flash_attention"]
    counts["duel_scan"] = duel_counts["duel_scan"]  # the online plane's run

    sources = {"fused_lookup": ("src/repro_torch/kernels/csrc/knn.cu",
                                "src/repro/kernels/knn/knn.py:88"),
               "knn": ("src/repro_torch/kernels/csrc/knn.cu",
                       "src/repro/kernels/knn/knn.py:58"),
               "placement_gains": ("src/repro_torch/kernels/csrc/gains.cu",
                                   "src/repro/kernels/knn/gains.py:90"),
               "greedy_gain": ("src/repro_torch/kernels/csrc/gains.cu",
                               "src/repro/kernels/gain/gain.py:36"),
               "flash_attention": (
                   "src/repro_torch/kernels/csrc/flash.cu",
                   "src/repro/kernels/flash_attention/flash.py:36"),
               "duel_scan": ("src/repro_torch/kernels/csrc/duel.cu",
                             "src/repro/core/placement/netduel.py:215")}
    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    shapes = {"fused_lookup": (a, a_big), "knn": (b, b_big),
              "placement_gains": (c, c_stream)}
    kernels = []
    for r in (a, b, c, d, e, f):
        src, repl = sources[r["name"]]
        kernels.append(dict(
            name=r["name"], route="cuda", source=src, replaces=repl,
            launches=counts[r["name"]], **{k: r[k] for k in timed}))
        if "device_ms" in r:
            kernels[-1]["device_ms"] = r["device_ms"]
        if r["name"] == "fused_lookup":          # the warm start's path
            kernels[-1]["launches_warmstart"] = warm_counts["fused_lookup"]
        if r["name"] == "placement_gains":       # GREEDY on the scenario
            kernels[-1]["launches_scenario"] = scenario_counts["greedy"]
        if r["name"] == "flash_attention":       # the strategy engines
            kernels[-1]["launches_scenario"] = \
                scenario_counts["flash_attention"]
        if r["name"] in gate_counts:             # the gated stream engine
            kernels[-1]["launches_gate"] = gate_counts[r["name"]]
        if r["name"] in shapes:        # A, B: K 448, 65,536; C: O 10⁵, 2e4
            dims = ("R", "O", "D") if "R" in r else ("Q", "K", "D")
            kernels[-1]["shapes"] = [
                dict(**{k: x[k] for k in dims}, device_ms=x["device_ms"],
                     **{k: x[k] for k in timed})
                for x in shapes[r["name"]]]
    # C past 8 caches (P7): its device time per call at each J
    kernels[2]["groups"] = [
        dict(**{k: g[k] for k in ("R", "O", "D", "I", "J", "launches",
                                  "device_ms", "bound_ms")})
        for g in groups if g["kernel"] == "C"]
    kernels[5]["device_ms"] = f["kernel_device_ms"]
    print(json.dumps({"kernels": kernels}), flush=True)
    log("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
