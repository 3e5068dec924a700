#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each before the last:

1. ``device`` — the card's name and count, and ``nvidia-smi``'s name and
   power limit line.
2. ``build`` — seconds to build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel); for each instantiation of kernels A and B, of kernels C
   and D, and of kernel F (its steps, registers or runs of slots, and
   its re-arm's two passes), ptxas's registers and spills; for kernel E's
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
   Then ``compress``: the compressed and pruned data plane at 10⁶ keys
   (D 64, two levels, 64 queries; the reference's
   ``scripts/quantized_smoke.py --full``, unsharded): the exact fused
   lookup, then verified quantize, LSH, k-means and LSH + quantize runs,
   each bitwise the exact one with kernel A launched once per rescore
   plus once per re-scan (the re-scanned share printed), the unverified
   quantized run admissible; kernel A held against its plain version at
   every shape the phase gives it (the exact scan over 10⁶ keys, each
   run's rescore over its gathered rows and its re-scan); times from
   CUDA events and the profiler, split into first pass, union and
   gather, rescore and re-scan; table builds on the host. The same four
   runs on the ``bigcache`` network's 16 batches against its fused
   results, A held likewise on the first batch.
   Then ``sharded_lookup``: item 11's data plane, the key axis in n
   contiguous shards with one launch of A's shard-local entry
   (``fold_repo=False``) per shard: ``bigcache``'s network at n = 2, 3
   and 8 (every batch bitwise the fused result, n launches a lookup, the
   sharded and fused lookups timed side by side), A on every chunk at
   n = 8 against its plain version, 5 keys over 8 shards (chunks of
   padding only) and no keys; then ``compress``'s 10⁶ keys at n = 8,
   exact and the four verified flag sets, each bitwise the exact result,
   with A's launches, the re-scanned share and the per-shard table
   builds.
   Then ``duel``: kernel F, the NETDUEL scan between promotions and its
   re-arm, at the engine's scale (10⁵ objects, K 448, C_a streamed, from
   random slots, 2,048 requests, window 256), once through F (counted)
   and once through the plain scan on the card: every output bitwise
   equal, at least one promotion, F's launches one per promoting step
   plus one and one re-arm launch per promoting step; every re-arm held
   bitwise against the torch re-arm on its inputs; both scans' times
   per request, the re-arms' time, F's device time and its share of the
   chain floor; the re-arm's device time a call, its time, its plain
   version's and its bound.
6. ``engine`` — ``SimCacheEngine`` with granite-3-2b at full width
   (random weights from a seed) in front of a 100,000-object catalog.
   The main path: cold serving, ``refresh_placement()`` (cascade on the
   card), warm serving and one background ``request_refresh`` →
   ``wait_refresh`` → ``poll_refresh`` cycle (solved by the §4 warm
   start: the synchronous refresh ran the cascade on the same window); kernel
   launch counts are
   zeroed just before it and read just after it. Then checks outside
   it: the installed lookup pricing the observed window at the
   predicted C(A), the looped lookup (kernel B, its own path, counted
   alone) serving the last warm batch as the fused one did, the 16
   warm batches re-served on the installed placement with the flags
   off and with each verified flag set (quantize, LSH, LSH + quantize),
   equal to the digit, and ``calibrate()`` timed once.
   Then ``warmstart``: the same engine with ``warm_start`` on, on the
   same weights and batches — every refresh the §4 continuous-limit
   warm start (solve and Prop 4.2 band map in NumPy, a 512-request
   LOCALSWAP polish on the card): its refresh split into solve, map and
   polish, its swaps, its predicted C(A) beside the cascade's, warm
   serving (the engine phase's background refresh runs this warm
   start on a worker thread);
   launches counted over the run (kernel A's among them). The warm start of the refresh's window is
   then held against the same call on a CPU ``DeviceInstance`` over the
   first 32 polish requests: ``slots_warm`` bitwise, the polished slots
   equal or first parted at an f32 edge.
   Then ``warm_1e6``: the warm start at 10⁶ objects (the reference
   suite's chain, tandem and tree on a 1000 × 1000 grid, and the §4.4
   tandem with arrivals at both nodes), unpolished: seconds of the
   solve and the map, a valid banded allocation, the card's streamed
   C(A) against the empty allocation's, a total under 60 s, and the
   tandem's f32 descent on the card held against the CPU's over its
   first 1,000 iterations.
7. ``prefill`` — granite-3-2b at full width, B = 2, S = 2048 (bf16),
   with ``use_flash_attention`` on and then off on the same weights:
   logit agreement, both times, kernel E's launches per flash forward
   (one per layer); and once more in f32 at B = 1, S = 512, where the
   two attentions must agree to f32 rounding.
   Then ``generate``: ``greedy_generate`` (prefill, padded cache, serve
   steps) on those weights at full depth, B 4, a 512-token prompt, 16
   new tokens, in f32 (flash off), bf16 (flash on: E in the prefill)
   and bf16 with the int8 KV cache; the same loops step by step for the
   holds: f32 logits against the teacher-forced full forward to 1e-3
   and its argmax off near-ties, bf16 against the bf16 full forward
   within what bf16 moves the f32 one, int8 against the bf16-cache
   decode within the move of a decode whose cache is shifted by the
   int8 step; E held against its plain versions and timed beside SDPA
   on the layer-0 Q/K/V of the counted bf16 call (B 4, S 512, H 32, KH
   8, Dh 64); prefill and step times, tokens/s, cache bytes and the
   step's bound.
8. ``stream`` — ``SimCacheEngine`` at full width with
   ``use_flash_attention=True`` in front of a 20,000-object catalog,
   driven by ``StreamDriver`` (4 Zipf streams): a cold run, a
   ``refresh_placement()``, a warm run whose cadence starts a background
   refresh, and ``drain_refresh()``. Kernel E's and A's launches are
   counted over the phase.
   Then ``sharded_engine``: the same run with ``EngineConfig.sharded``
   on a 4-shard mesh: the refresh's and the drain's allocations bitwise
   the ``stream`` phase's, warm hit rate and mean cost equal, A launched
   4 times a served lookup and C 4 times a synchronous GREEDY seed (once
   a background one), the batch percentiles beside the ``stream``
   phase's.
   Then ``duel_engine``: the online plane on the serving path — the
   same engine with ``netduel`` and ``refresh_on_promotion``, its solves
   GREEDY alone (1,024 cold requests, ``refresh_placement()``, 2,048
   warm requests, the drain),
   its launches counted over the run (F's steps and re-arms among
   them); every batch each duel plane observed is replayed through a
   second ``DuelPlane`` on the plain scan, whose carry must equal the
   engine's bitwise, and through a third on F with every re-arm held
   bitwise against the torch re-arm.
   Then ``scenario``: a multi-ingress ISP-like network (37 caches, 448
   slots, 4 ingresses) on the stream's catalog rescaled by the reference
   hit-rate bench's rule; GREEDY on the card (kernel C in 5 groups a
   call, counted; C then held against its plain version at the seed's
   inputs) and 2,048 requests through the engine's strategy plane for
   each of the five strategies (kernel E on the misses, counted): hit
   rate, mean cost and batch percentiles beside GREEDY's C(A).
   Then ``gain_quant``: on the stream's catalog and the engine's
   hierarchy, ``placement_gains(quantize=True)`` never below kernel C's
   gains less their tolerance, ``device_greedy(quantize=True)`` bitwise
   the exact-seeded allocation, both timed.
   Then ``sharded_control``: the candidate-sharded gain oracle (C once a
   shard and group of 8 caches) at n = 4 on that instance and n = 3 on
   the ``scenario`` net (J 37), bitwise the unsharded columns; GREEDY on
   a 4-shard ``DeviceInstance`` bitwise the unsharded allocation; the
   best-two tables at 10⁵ objects, K 448, n = 4, and a delta refresh
   forced into its full rebuild, bitwise.
   Then ``hitrate``: the Che plane on the card on the reference's
   full-scale network (scale-free, 41 caches, 4,096 slots, 6
   ingresses) at 20,000 objects: exact balls, the SIM-LRU and RND-LRU
   predictions against a 40,000-request replay, the balls held against
   the CPU's on a slice, and the refresh surrogate's time a call at 10⁵
   and 10⁶ objects, its cost bitwise from call to call; then the
   reference bench's 10⁶-object path: LSH balls (build, card and host
   time; the balls' sizes before the cut to 64), the fixed point, the bench's check, LSH within exact on a
   20,000-object slice and the card's LSH balls against the CPU's on
   2,000.
   Then ``gate``: the ``stream`` configuration with
   ``refresh_min_gain`` 100: every stationary request skipped (no solve,
   no swap), a drift to uniform demand (``set_streams``) triggering a
   solve (GREEDY alone) that swaps in; the surrogate's time a call; launches counted
   over the phase.
   Then ``mesh``: the mesh layer (item 14d) on the same weights, no new
   model: (a) the train-mode loss under the production train policy
   (heads, the KV heads repeated 8 → 16) against NO_SHARD's, f32, B 2,
   S 512, within 1e-5 relative; (b) a flash prefill under the
   production prefill policy (B 2, S 2048), kernel E at H 32 / KH 16,
   one launch a layer, counted, E held against ``flash_ref`` and
   ``flash_blocked`` at that shape and timed beside SDPA, the logits
   within bf16's own move of NO_SHARD's; (c) 8 serve steps under the
   decode policy bitwise NO_SHARD's; (d) the dry run's argument bytes of
   the ``train`` phase's cell (B 4, S 512, f32 moments, 1 × 1 mesh)
   equal to the state the trainer builds on the card, part for part,
   and the dry run's seconds by pass; (e) ``compressed_crosspod_mean`` on
   a 1-rank NCCL group bitwise dequantize ∘ quantize; (f) granite's
   smoke weights checkpointed and re-meshed onto (4, 2), (2, 4) and
   (8, 1): every leaf reassembled bitwise, the loss bitwise the saved
   model's.
   Then ``generate_wide``: phi3-medium-14b at full width and depth,
   deepseek-coder-33b and deepseek-67b at full width cut to 8 layers
   (B 2, a 1,024-token prompt): a counted bf16 ``greedy_generate`` with
   E in its prefill, E held against its plain versions and timed beside
   SDPA on the first layer's Q/K/V (Dh 128; 4, 7 and 8 query heads a KV
   head), the prefill and decode step times, an f32 decode held against
   the f32 full forward, and peak memory.
   Then ``families``: the other model families at full width, random
   weights from a seed — granite-moe-3b-a800m (40 experts, top-8),
   dbrx-132b cut to 2 layers, jamba-1.5-large-398b cut to one
   super-block of 8 layers with 4 of 16 experts (attention, Mamba at
   full width, MoE), xlstm-350m (mLSTM, sLSTM), qwen2-vl-7b (QKV biases,
   M-RoPE) — B 2, a 512-token prompt, 8 new tokens: a counted bf16
   ``greedy_generate`` with E in its prefill, E held on its first
   layer's Q/K/V, the run step by step for its times, an f32 decode
   held against the f32 teacher-forced forward (MoE at no drop, router
   near-ties below 1e-6 skipped and named; the prefill's drops at
   capacity 1.25 counted), peak memory; qwen2-vl also a counted f32
   prefill of 256 image patches before 256 tokens on a grid of M-RoPE
   ids, held against the train-mode forward; whisper-small whole, 1,500
   audio frames and a 64-token prompt: a counted bf16 prefill (E
   non-causal in the encoder, causal in the decoder, both held) and
   serve steps, then the prefill and 8 serve steps in f32 held against
   ``encdec_forward`` in train mode.
   Then ``train``: training (item 14c), no kernel on its path (kernel E
   has no backward and training runs with ``use_flash_attention=False``,
   as the reference's). ``train()`` on granite-3-2b whole (2.53 B f32
   parameters, bf16 compute, remat on), ``SyntheticLMData(vocab=49155,
   batch=4, seq=512)``, 6 steps from seed 0 with f32 moments, then 6
   with int8 ones: every loss finite, peak memory under 75 GiB, the
   step's p50 and p95 (CUDA events, the first step apart), tokens/s,
   the bound (8·N·T at the bf16 peak, then the update's bytes), and one
   more step profiled (device time and events, idle share); before
   them one SGD step of 0.3 on the first batch's gradient, which must
   lower its loss. Every parameter's gradient on the card held against
   the port's CPU gradient of the same weights (1e-4 of each leaf's
   largest |g|, f32 compute): granite at full width cut to 2 layers (B
   2, S 128) and the nine other archs at their smoke configs. Kill and
   resume at the 2-layer cut (6 straight steps against 4, a checkpoint
   and a resumed 2; 2e-4, and whether bitwise).
9. ``launch`` — ``python -m repro_torch.launch.serve`` in subprocesses
   started together on the card: the batch loop, streaming, streaming
   with ``--netduel``, the batch loop with ``--warm-start``, and
   ``--scenario scale_free --strategy lce`` in both loops, and the batch
   loop with ``--arch jamba-1.5-large-398b``; each must exit 0 and print
   its final ``[serve] … hit-rate`` line (and the duel churn with
   ``--netduel``, the scenario with ``--scenario``). Beside them
   ``python -m repro_torch.launch.train --arch granite-3-2b --steps 6``:
   exit 0 and a finite final loss.
10. ``examples`` — the examples' twins (``examples/*_torch.py``) in
   this process, at their reference examples' sizes: netduel_online,
   serve_simcache, streaming_serve, and train_lm at 30 steps; each
   example's promises held (the host replay equal to the device scan,
   the warm hit rate and cost, the request and batch counts, finite
   losses and a resume from the checkpoint's step), the launches of A,
   C and F counted in each run, and each of those launches held: every
   A and C call of serve_simcache and streaming_serve against its plain
   version, streaming_serve's duel planes replayed bitwise on the plain
   scan and on F.
11. ``kernels`` — one JSON object with every kernel's numbers; A's and
   B's entries also carry each of their two shapes (K 448 and 65,536),
   C's its two (R = O = 10⁵ and 20,000) and its times past 8 caches; F's
   steps (``duel_scan``) and its re-arm (``duel_rearm``) count the
   ``duel_engine`` run's launches, and the ``duel`` phase's as
   ``launches_duel``; A's entry also carries
   its launches in the ``warmstart`` run, C's and E's their launches in
   the ``scenario`` runs, and every entry its launches in the ``gate``
   run; E's its launches in the ``greedy_generate`` calls of
   ``generate`` and ``generate_wide`` (``launches_generate``) and in
   the ``families`` phase's counted runs (``launches_families``), and in
   the ``mesh`` phase's policy prefill (``launches_mesh``, with E's hold
   at that shape, ``mesh_hold``); A's, C's and F's their launches in
   the ``examples`` phase (``launches_examples``); A's also
   its launches over the ``compress`` runs; A's and C's their launches
   in the sharded phases (``launches_sharded``), and A's the hold of its
   shard-local entry (``shard_local_hold``). Beside the
   kernels, ``xla_paths``: item 10's torch paths (``_quantized_select``,
   ``candidate_matrix`` + ``candidate_union``, ``_lb_gains_tiles``,
   ``_cand_ca``; XLA in the reference), each timed beside the exact path
   it sits in front of.

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


T_START = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One phase line; ``elapsed_s`` is the script's seconds so far."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - T_START}),
          flush=True)


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


def device_ms(torch, fn, iters: int, match: str, tries: int = 6) -> dict:
    """Device time per call of ``fn`` from torch.profiler's trace (its
    CUDA events, as ``trace_solve.py`` reads them): the kernels whose name
    contains ``match`` (every device event of the call, kernels, copies
    and memsets, with ``match=""``), their launches per call, and the
    memsets beside them, over ``iters`` calls after one warm-up call.
    Now and then (once in ~60 windows on the card; in one run, three
    windows of B in a row) a window's trace comes back without some of
    its device events, so a window is kept only when its
    count is a whole number per call or, with ``match=""``, the same as
    an earlier window's; else it is taken again, up to ``tries`` times,
    and then refused."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        kern = [e for e in dev if match in e.name]
        if kern and (len(kern) % iters == 0
                     or (not match and len(kern) in seen)):
            break
        seen.append(len(kern))
    else:
        raise RuntimeError(f"the profiler recorded no whole window of "
                           f"{match or 'device'} events in {tries} tries "
                           f"(counts {seen})")
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
        m = re.search(r"(duel_scan|rearm_rows|rearm_dirty)_kernelILb(\d)"
                      r"ELi(\d)E(?:Lb(\d)E)?", name)
        if m:
            key = "materialized" if m[2] == "1" else \
                f"streamed {('l1', 'l2', 'l2sq')[int(m[3])]}"
            if m[1] == "duel_scan":
                key += " registers" if m[4] == "1" else " runs"
            duel[f"{m[1]} {key}"] = info
    # steps: (materialized + 3 streamed metrics) x (registers, runs);
    # re-arm: (materialized + 3 metrics) x (rows pass, dirty pass)
    if len(duel) != 16:
        raise RuntimeError(f"ptxas reported {len(duel)} duel kernel "
                           f"instantiations, not 16: {sorted(duel)}")
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


def hold_fused(torch, q, keys, h_key, meta, h_repo, got,
               fold_repo: bool = True) -> dict:
    """Kernel A's outputs ``got`` (l2, γ = 1, keys segmented by ascending
    level, a whole layout, rows gathered from one or one shard's chunk)
    against its plain version on the same inputs: every cost within the
    per-query tolerance, and a differing winner (a key named by its level
    and slot) only where the plain version sees a near-tie:
    its own cost at the kernel's key within 2·tol of its min. With
    ``fold_repo=False`` (the shard-local entry) the repository is left
    out of both. The fields of the check and ``ok``."""
    from repro_torch.kernels.knn.ref import _dense_ca, fused_lookup_ref
    Q, K = q.shape[0], keys.shape[0]
    cost_k, ca_k, lvl_k, slot_k, pay_k = got
    cost_p, ca_p, lvl_p, slot_p, pay_p = fused_lookup_ref(
        q, keys, h_key, meta, "l2", 1.0, h_repo, -1, fold_repo=fold_repo)
    if not fold_repo:
        h_repo = 3.0e38                  # a repository that never wins
    tol = l2_tolerance(torch, q, keys, ca_p) + 2 * U32 * cost_p
    err = (cost_k - cost_p).abs()
    full = torch.where(meta[3][None, :] > 0,
                       _dense_ca(q, keys, "l2", 1.0) + h_key[None, :],
                       torch.full((Q, K), 3.0e38, device=q.device))
    # the valid keys' (level, slot) ascend with their index, in a whole
    # layout and in rows gathered from one
    valid = torch.nonzero(meta[3] > 0).reshape(-1)
    span = int(meta[1].max()) + 1
    code = meta[0, valid].long() * span + meta[1, valid].long()

    def key_index(lvl, slot):                  # −1: the repository
        if valid.numel() == 0:
            return torch.full_like(lvl, -1).long()
        at = torch.searchsorted(code, lvl.clamp_min(0).long() * span
                                + slot.long())
        return torch.where(lvl >= 0, valid[at.clamp_max(valid.numel() - 1)],
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


LOOKUP_FIELDS = ("cost", "approx_cost", "level", "slot", "payload", "hit")


def bitwise_equal(torch, a, b) -> bool:
    """Two ``LookupResult``s equal in all six fields, floats bit for
    bit."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    return all(torch.equal(bits(getattr(a, f)), bits(getattr(b, f)))
               for f in LOOKUP_FIELDS)


class timed_parts:
    """Context manager: wraps ``attr`` of ``module`` for each (part,
    module, attr) so that every call is timed to the end of its device
    work (a synchronize before and after) and summed under ``part``;
    restores them on exit. ``ms`` holds the sums."""

    def __init__(self, torch, parts):
        self.torch, self.parts, self.ms, self.saved = torch, parts, {}, []

    def __enter__(self):
        torch = self.torch
        for part, module, attr in self.parts:
            fn = getattr(module, attr)
            self.saved.append((module, attr, fn))
            self.ms.setdefault(part, 0.0)

            def call(*a, _fn=fn, _part=part, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                self.ms[_part] += (time.perf_counter() - t) * 1e3
                return out
            setattr(module, attr, call)
        return self

    def __exit__(self, *exc):
        for module, attr, fn in reversed(self.saved):
            setattr(module, attr, fn)


class captured:
    """Context manager: wraps ``attr`` of ``module`` for each (name,
    module, attr, keep) so that ``keep(args, kwargs, result)`` of every
    call, where it is not None, is appended to ``calls[name]``; restores
    them on exit."""

    def __init__(self, targets):
        self.targets, self.calls, self.saved = targets, {}, []

    def __enter__(self):
        for name, module, attr, keep in self.targets:
            fn = getattr(module, attr)
            self.saved.append((module, attr, fn))
            kept = self.calls.setdefault(name, [])

            def call(*a, _fn=fn, _keep=keep, _kept=kept, **kw):
                out = _fn(*a, **kw)
                item = _keep(a, kw, out)
                if item is not None:
                    _kept.append(item)
                return out
            setattr(module, attr, call)
        return self

    def __exit__(self, *exc):
        for module, attr, fn in reversed(self.saved):
            setattr(module, attr, fn)


def a_targets(keep) -> list:
    """:class:`captured`'s targets for kernel A's entries: the rescore
    over gathered rows (``ops.fused_lookup``) and the fused lookup and
    the verifier's re-scan over the whole layout (``simcache``'s)."""
    from repro_torch.core import simcache
    from repro_torch.kernels.knn import ops
    return [("rescore", ops, "fused_lookup", keep),
            ("rescan", simcache, "fused_lookup", keep)]


def hold_captured_a(torch, calls) -> list:
    """Each captured call of kernel A (``captured.calls`` of
    :func:`a_targets`) with a key held against its plain version
    (:func:`hold_fused`); a call with no key launches nothing. The
    checks' fields with the call's role and shape."""
    held = []
    for role in ("rescore", "rescan"):
        for (qs, keys, h_key, meta), kw, out in calls.get(role, []):
            if keys.shape[0] == 0:
                continue
            if (kw["metric"], kw["gamma"], kw["repo_level"],
                    kw.get("fold_repo", True)) != ("l2", 1.0, -1, True):
                raise RuntimeError(f"A's {role} call is not the l2, γ 1, "
                                   f"folded lookup hold_fused checks: {kw}")
            held.append(dict(
                hold_fused(torch, qs, keys, h_key, meta, kw["h_repo"], out),
                role=role, Q=qs.shape[0], K=keys.shape[0], D=keys.shape[1],
                **_plan_fields(torch, qs.shape[0], keys.shape[0],
                               keys.shape[1])))
    return held


def hold_a_calls(torch, net, q, flags) -> list:
    """Kernel A's every call in one lookup of ``q`` with ``flags`` — the
    rescore over the gathered rows and the verifier's re-scan over the
    whole layout, at the shapes and split plans the path gives them —
    each held against its plain version (:func:`hold_captured_a`)."""
    keep = lambda a, kw, out: (a, kw, out)  # noqa: E731
    with captured(a_targets(keep)) as cap:
        net.lookup(q, **flags)
    return hold_captured_a(torch, cap.calls)


def cloned(torch, x):
    """``x`` with every tensor in it (in tuples, lists and dicts) cloned,
    so that a captured call keeps its inputs as the call saw them."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(cloned(torch, v) for v in x)
    if isinstance(x, dict):
        return {k: cloned(torch, v) for k, v in x.items()}
    return x


def c_targets(torch) -> list:
    """:class:`captured`'s target for kernel C's entry on an unsharded
    instance (``DeviceInstance.gains`` → ``placement_gains``): each exact
    call's inputs and output, cloned; a quantized call launches no C."""
    from repro_torch.kernels import knn
    keep = lambda a, kw, out: None if kw.get("quantize") else (  # noqa
        cloned(torch, a), dict(kw), out.clone())
    return [("gains", knn, "placement_gains", keep)]


def hold_captured_c(torch, calls) -> list:
    """Each captured call of kernel C (:func:`c_targets`, R = O: the
    instance's own coordinates) held against its plain version
    (``_gains_tiles``) on the same inputs, at the tolerance of the
    ``scenario`` phase: :func:`gain_tolerance` summed over the ingresses
    plus 1e-4 relative. The checks' fields with the call's shape and its
    launches (one per group of caches)."""
    from repro_torch.kernels.knn.gains import (_gains_tiles, _j_groups,
                                               _sentinel)
    held = []
    for (x, y, lam, cur, hreq), kw, out in calls.get("gains", []):
        if (kw.get("metric", "l2"), kw.get("gamma", 1.0)) != ("l2", 1.0) \
                or not torch.equal(x, y):
            raise RuntimeError(f"C's call is not the l2, γ 1, R = O call "
                               f"the hold checks: {kw}")
        ref = _gains_tiles(x, y, lam, cur, _sentinel(hreq), "l2", 1.0)
        err = (out - ref).abs()
        tol = gain_tolerance(torch, x, lam).sum(0)[:, None] \
            + 1e-4 * ref.abs()
        held.append(dict(R=x.shape[0], O=y.shape[0], D=x.shape[1],
                         I=lam.shape[0], J=hreq.shape[1],
                         launches=len(_j_groups(hreq.shape[1])),
                         max_abs_err=float(err.max()),
                         tol_max=float(tol.max()),
                         ok=bool((err <= tol).all())
                         and bool(torch.isfinite(out).all())))
    return held


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

    equal = all(bitwise_equal(torch, a, b) for a, b in zip(fused, loop))
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
    return net, queries, fused


# the compress phase: the reference's scripts/quantized_smoke.py --full
# on one card, unsharded
COMPRESS_KEYS, COMPRESS_DIM, COMPRESS_QUERIES = 1_000_000, 64, 64
COMPRESS_RUNS = (("quantize_verify", dict(quantize=True, verify=True)),
                 ("lsh_verify", dict(prune="lsh", verify=True)),
                 ("kmeans_verify", dict(prune="kmeans", verify=True)),
                 ("lsh_quantize_verify", dict(prune="lsh", quantize=True,
                                              verify=True)))


def _lookup_parts(torch):
    """The parts of a pruned or quantized lookup, for ``timed_parts``:
    the first pass (int8 select, candidate matrix, the gathered rows'
    quantization), the union and gather, the rescore (kernel A over the
    gathered rows) and the verifier's re-scan (kernel A over all keys)."""
    from repro_torch.core import simcache
    from repro_torch.kernels.knn import ops
    return [("first_pass_ms", ops, "_quantized_select"),
            ("first_pass_ms", ops, "candidate_matrix"),
            ("first_pass_ms", ops.quant, "quantize_rows"),
            ("union_gather_ms", ops, "candidate_union"),
            ("union_gather_ms", ops, "gather_candidate_rows"),
            ("union_gather_ms", ops, "unscanned_h_bound"),
            ("rescore_ms", ops, "fused_lookup"),
            ("rescan_ms", simcache, "fused_lookup")]


def flagged_runs(torch, net, queries, exact, runs, iters: int) -> dict:
    """Each flagged lookup of ``runs`` over every batch of ``queries``:
    its launch counts (zeroed just before, read just after), the
    verifier's re-scans, bitwise equality with ``exact`` (the fused
    results), then, outside the counted run, its time a batch from CUDA
    events, its device time from torch.profiler (every device event of
    the call), its parts timed to the end of their device work, and each
    of kernel A's calls in the first batch's lookup held against A's
    plain version (:func:`hold_a_calls`)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    rows = {}
    for name, flags in runs:
        calls0, q0 = net.rescan_calls, net.rescan_queries
        reset_launch_counts()
        t = time.perf_counter()
        got = [net.lookup(q, **flags) for q in queries]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = launch_counts()
        rescan_calls = net.rescan_calls - calls0
        rescanned = net.rescan_queries - q0
        n_q = sum(q.shape[0] for q in queries)
        q = queries[0]
        with timed_parts(torch, _lookup_parts(torch)) as parts:
            net.lookup(q, **flags)
        held = hold_a_calls(torch, net, q, flags)
        rows[name] = dict(
            bitwise_equal_exact=all(bitwise_equal(torch, a, b)
                                    for a, b in zip(got, exact)),
            fused_lookup_launches=counts["fused_lookup"],
            launches_expected=len(queries) + rescan_calls,
            rescan_calls=rescan_calls,
            rescanned_share=rescanned / n_q,
            first_run_s=secs,
            ms=cuda_ms(torch, lambda: net.lookup(q, **flags), iters),
            device_ms=device_ms(torch, lambda: net.lookup(q, **flags),
                                iters, "", tries=5)["device_ms"],
            parts=parts.ms, held_against_plain=held,
            held_ok=any(h["role"] == "rescore" for h in held)
            and all(h["ok"] for h in held))
    return rows


def phase_compress(torch, big) -> dict:
    """The compressed and pruned data plane (item 10) at the reference's
    headline size: 10⁶ keys, D 64, from ``standard_normal`` (seed 0) in
    two levels of 500,000 keys at h 0 and 0.5, h_repo 1e9; 64 queries
    (catalog rows plus 0.05 noise); ``SimHashPolicy(n_tables=4,
    n_bits=16, n_probes=2, max_candidates=16384)`` and the default
    ``KMeansPolicy``. The exact fused lookup (kernel A over 10⁶ keys),
    then four verified runs — quantize, LSH, k-means, LSH + quantize —
    each bitwise the exact one with kernel A launched once per rescore
    plus once per re-scan, and the unverified quantized run, admissible.
    Kernel A is held against its plain version at each shape the phase
    gives it: the exact scan over 10⁶ keys, and every rescore and re-scan
    of each verified run. Table builds timed on the host. Then the same
    four runs on the ``bigcache`` network's 16 batches against its fused
    results."""
    from repro_torch.core.simcache import CacheLevel, SimCacheNetwork
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.knn import KMeansPolicy, SimHashPolicy
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on: the int8 certificate needs IEEE "
                           "fp32 products")
    n, d, b = COMPRESS_KEYS, COMPRESS_DIM, COMPRESS_QUERIES
    rng = np.random.default_rng(0)
    coords = rng.standard_normal((n, d)).astype(np.float32)
    half = n // 2
    cj = torch.as_tensor(coords, device="cuda")
    levels = [CacheLevel(keys=cj[:half], values=torch.arange(
                  half, dtype=torch.int32, device="cuda"), h=0.0),
              CacheLevel(keys=cj[half:], values=torch.arange(
                  half, n, dtype=torch.int32, device="cuda"), h=0.5)]
    pol = SimHashPolicy(n_tables=4, n_bits=16, n_probes=2,
                        max_candidates=16384)
    net = SimCacheNetwork(levels=levels, h_repo=1e9, metric="l2",
                          candidate_policy=pol)
    q = torch.as_tensor(coords[rng.integers(0, n, b)] + 0.05
                        * rng.standard_normal((b, d)).astype(np.float32),
                        device="cuda")
    net.fused_layout()
    builds = {}
    for name, fn in (("lsh_s", lambda: net._tables_for(pol)),
                     ("kmeans_s", lambda: net._tables_for(KMeansPolicy())),
                     ("quant_rows_s", lambda: net._quant_rows())):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        builds[name] = time.perf_counter() - t
    reset_launch_counts()                         # the exact run
    exact = net.lookup(q)
    torch.cuda.synchronize()
    exact_counts = launch_counts()
    exact_ms = cuda_ms(torch, lambda: net.lookup(q), 5)
    exact_dev = device_ms(torch, lambda: net.lookup(q), 5, "",
                          tries=5)["device_ms"]
    keys, h_key, meta = net.fused_layout()
    exact_held = dict(hold_fused(torch, q, keys, h_key, meta, net.h_repo, (
        exact.cost, exact.approx_cost, exact.level, exact.slot,
        exact.payload)), **_plan_fields(torch, b, n, d))
    runs = flagged_runs(torch, net, [q], [exact], COMPRESS_RUNS, 5)
    raw = net.lookup(q, quantize=True)            # unverified
    admissible = bool((raw.cost >= exact.cost).all()
                      and (raw.cost <= net.h_repo).all())
    # the certificate's premise on a sampled tile: lb ≤ the f64 C_a
    from repro_torch.kernels import quant
    kq = net._quant_rows()
    lb = quant.lb_approx_cost_tiles(
        q, quant.QuantizedRows(*(t[:4096] for t in kq)), "l2", 1.0)
    lb_slack = float((torch.cdist(q.double(), cj[:4096].double())
                      - lb.double()).min())
    del lb
    # the item-10 XLA paths at these shapes, beside kernel A's exact scan
    from repro_torch.kernels.knn import ops
    proj, buckets, n_probes = net._tables_for(pol)
    select_ms = cuda_ms(torch, lambda: ops._quantized_select(
        q, h_key, meta[3] > 0, kq, ops.DEFAULT_TOP_T, ops.DEFAULT_QTILE,
        "l2", 1.0), 5)
    cand_ms = cuda_ms(torch, lambda: ops.candidate_union(
        ops.candidate_matrix("lsh", proj, buckets, q, n_probes), n,
        pol.resolve_cap(n)), 5)
    del raw

    big_net, big_q, big_fused = big
    big_runs = flagged_runs(torch, big_net, big_q, big_fused,
                            COMPRESS_RUNS, 5)
    res = dict(keys=n, dim=d, queries=b, levels=[half, n - half],
               h=[0.0, 0.5], h_repo=1e9, policy="SimHashPolicy(4, 16, 2, "
               "max_candidates=16384)", table_builds=builds,
               exact=dict(ms=exact_ms, device_ms=exact_dev,
                          launches=exact_counts["fused_lookup"],
                          held_against_plain=exact_held),
               runs=runs, unverified_quantize_admissible=admissible,
               lb_below_f64_ca_min_slack=lb_slack,
               bigcache=dict(keys=sum(BIGCACHE_SLOTS), dim=100,
                             batches=len(big_q), batch=big_q[0].shape[0],
                             runs=big_runs))
    log("compress", **res)
    every = list(runs.values()) + list(big_runs.values())
    checks = [exact_counts["fused_lookup"] == 1, admissible, lb_slack >= 0,
              exact_held["ok"], all(r["held_ok"] for r in every),
              all(r["bitwise_equal_exact"] for r in every),
              all(r["fused_lookup_launches"] == r["launches_expected"]
                  for r in every)]
    if not all(checks):
        raise RuntimeError(f"compress phase failed its checks: {checks}")
    xla = [dict(name="_quantized_select",
                replaces="src/repro/kernels/knn/ops.py:213",
                shape=dict(Q=b, K=n, D=d, top_t=ops.DEFAULT_TOP_T),
                ms=select_ms, exact_path="fused_lookup (A), K 10⁶",
                exact_ms=exact_ms),
           dict(name="candidate_matrix + candidate_union",
                replaces="src/repro/kernels/knn/lsh.py:293, :327",
                shape=dict(Q=b, K=n, D=d, tables=4, bits=16, probes=2),
                ms=cand_ms, exact_path="fused_lookup (A), K 10⁶",
                exact_ms=exact_ms)]
    launches = sum(r["fused_lookup_launches"] for r in every)
    return dict(launches=launches, xla=xla, plane=(net, q, exact))


# the engine phase's serving: batches of 256 requests, 16-token prompts
ENGINE_BATCHES, ENGINE_BATCH, ENGINE_SEQ = 16, 256, 16
# the verified flag sets the engine re-serves its warm batches with
ENGINE_RERUNS = (("quantize", dict(quantize=True, verify=True)),
                 ("lsh", dict(prune="lsh", verify=True)),
                 ("lsh_quantize", dict(prune="lsh", quantize=True,
                                       verify=True)))


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
               p95_ms=s.p95_ms, p99_ms=s.p99_ms)
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
    # the background cycle solves by the §4 warm start: the cascade
    # already solved this window, and GREEDY alone took ~43 s at 10⁵
    # objects (~10 s the warm start); the solve reads the config on its
    # thread, so the flag stays on until it ends
    eng.ecfg = dataclasses.replace(ecfg, warm_start=True)
    started = eng.request_refresh()
    done = eng.wait_refresh(timeout=900)
    eng.ecfg = ecfg
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

    # the compressed and pruned data plane behind the engine: the warm
    # batches re-served on the installed placement with the flags off,
    # then with each verified flag set — to the digit the same
    reruns = {}
    for name, flags in (("off", {}),) + ENGINE_RERUNS:
        eng.ecfg = dataclasses.replace(ecfg, **flags)
        q0 = eng.simcache.rescan_queries
        row, _ = serve_batches(eng, cfg, dem, 2)
        reruns[name] = dict(row, rescanned=eng.simcache.rescan_queries - q0)
    eng.ecfg = ecfg
    same = {n: all(r[k] == reruns["off"][k]
                   for k in ("hit_rate", "mean_cost", "model_calls"))
            for n, r in reruns.items()}

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
               flagged_reruns=reruns, reruns_equal_flags_off=same,
               max_memory_allocated_gib=peak_gb, logits_ok=logits_ok,
               calibrate_ms=calib_ms)
    log("engine", **res)
    checks = [counts["fused_lookup"] > 0, counts["placement_gains"] > 0,
              twin_counts["knn"] > 0, warm["hit_rate"] > 0,
              warm["mean_cost"] < h_model, logits_ok,
              all(twin[n] for n in ("level", "slot", "payload", "hit")),
              priced["ok"], all(same.values()),
              started and done and swapped and bg["version"] == v0 + 1]
    if not all(checks):
        raise RuntimeError(f"engine phase failed its checks: {checks}")
    # kernel B runs on the looped path only, so its count is that run's
    return dict(counts, knn=twin_counts["knn"]), params, dict(
        predicted_cost=pred, refresh_s=refresh_s, **timings)

# requests of the polish window held on the card against the CPU, a
# cut of the engine's 512: on an H100 host's CPU 64 took ~13 s at 10⁵
# objects
HOLD_POLISH = 32
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
    card) and the same warm batches; launches counted over the run (the
    ``engine`` phase's background refresh runs this warm start on a
    worker thread). Then the warm start of that refresh's window held
    against the same call on a CPU ``DeviceInstance``, over the first
    HOLD_POLISH polish requests."""
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
               launches=counts, hold=hold)
    log("warmstart", **res)
    checks = [counts["fused_lookup"] > 0, warm["hit_rate"] > 0,
              warm["mean_cost"] < ecfg.h_model, timings["warm_swaps"] >= 0,
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


# mirror-descent iterations of the tandem's card-against-CPU hold, a cut
# of the solve's 3,000: the CPU's descent at 10⁶ regions took ~56 s of
# an H100 host's time at 3,000
WARM_HOLD_ITERS = 1000


def phase_warm_1e6(torch):
    """The warm start at 10⁶ objects, where no discrete solver runs: the
    reference suite's chain, tandem and tree (grid L = 1000, σ = L/4,
    k = 64) and the §4.4 tandem with arrivals at both nodes, unpolished.
    Each allocation is valid and banded, and the card's streamed C(A)
    beats the empty allocation's; the tandem's descent on the card is
    held against the CPU's on the same inputs over its first
    ``WARM_HOLD_ITERS`` iterations."""
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
    sols, hold = {}, dict(md_iters=WARM_HOLD_ITERS)
    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        sols[dev] = warmstart.solve_continuous(
            tandem, red, md_iters=WARM_HOLD_ITERS, device=dev)
        hold[f"{dev}_s"] = time.perf_counter() - t
    a, b = sols["cuda"], sols["cpu"]
    # the bound: the step of the solve's own last iteration (lr / √(1 +
    # t / 100) at its 3,000th), tighter than the held window's last step
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


def hold_kernel_e(torch, q, k, v, clock_hz: float,
                  causal: bool = True) -> dict:
    """Kernel E in bf16 on (q, k, v) (B, S, H, Dh) / (B, S, KH, Dh),
    causal or not, on the tensor cores, held against its plain versions
    and timed beside them and SDPA.

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
    B·H·S·(S+1)/2 exponentials, B·H·S² without the mask, at 16 per clock
    per SM on 132 SMs, at the card's maximum SM clock) and SDPA's time.
    Raises if a hold fails."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_blocked,
                                                     flash_cuda, flash_ref)
    from repro_torch.kernels.flash_attention.ref import P_REL
    B, S, H, Dh = q.shape
    KH = k.shape[2]

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True).transpose(1, 2)

    got = flash_cuda(q, k, v, causal=causal)
    ref = flash_ref(q, k, v, causal=causal)
    abs_v = flash_ref(q.float(), k.float(), v.float().abs(), causal=causal)
    blk, slack = flash_blocked(q, k, v, causal=causal,
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
    ms = cuda_ms(torch, lambda: flash_cuda(q, k, v, causal=causal), 20)
    plain = cuda_ms(torch, lambda: flash_ref(q, k, v, causal=causal), 3)
    lib_ms = cuda_ms(torch, sdpa, 20)
    n_exp = B * H * S * ((S + 1) / 2 if causal else S)   # the scores kept
    flops = 4 * Dh * n_exp                        # QK^T and PV
    n_bytes = 2 * (2 * B * S * H * Dh + 2 * B * S * KH * Dh)
    bms, by = bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)
    res = dict(name="flash_attention", B=B, S=S, H=H, KH=KH, Dh=Dh,
               dtype="bfloat16", causal=causal,
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
    return res


def phase_kernel_e(torch, clock_hz: float):
    """Kernel E in bf16 at granite-3-2b's attention shape (H 32, KH 8,
    Dh 64), causal, at each (B, S) of ``FLASH_SHAPES``, on the tensor
    cores, held and timed by :func:`hold_kernel_e`."""
    dev = torch.device("cuda")
    H, KH, Dh = 32, 8, 64
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for B, S in FLASH_SHAPES:
        q = torch.randn(B, S, H, Dh, generator=g, device=dev).bfloat16()
        k = torch.randn(B, S, KH, Dh, generator=g, device=dev).bfloat16()
        v = torch.randn(B, S, KH, Dh, generator=g, device=dev).bfloat16()
        rows.append(hold_kernel_e(torch, q, k, v, clock_hz))
        del q, k, v
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


# requests of the duel scan: the plain scan on the card takes ~7 ms a
# request
DUEL_T, DUEL_WINDOW, DUEL_ARM = 2048, 256, 0.25


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


class RearmHold:
    """Inside ``with``: every re-arm the kernel path makes (through
    ``netduel.duel_rearm_cuda``) is also run by its plain version,
    ``duel_rearm_ref`` (torch ops), on the same inputs and held bitwise;
    each call's promoted slots and dirty rows are kept, and the first
    call's inputs (for timing). Used outside the counted runs only."""

    def __init__(self, torch, nd):
        self.torch, self.nd = torch, nd
        self.calls, self.equal = 0, True
        self.promoted, self.dirty, self.first = [], [], None

    def __enter__(self):
        torch = self.torch
        from repro_torch.kernels.duel import duel_rearm_ref
        kernel = self._kernel = self.nd.duel_rearm_cuda

        def bits(t):
            return t.view(torch.int32) if t.dtype == torch.float32 else t

        def held(*args):
            if self.first is None:
                self.first = tuple(
                    tuple(t.clone() for t in a) if isinstance(a, tuple)
                    else a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args)
            got = kernel(*args)
            want = duel_rearm_ref(*args)
            self.calls += 1
            self.equal &= all(torch.equal(bits(g), bits(w))
                              for g, w in zip(got, want))
            pre, promote = args[0], args[2]
            ys = torch.nonzero(promote).reshape(-1)
            self.promoted.append(int(ys.numel()))
            hit = torch.isin(pre[1], ys) | torch.isin(pre[3], ys)
            self.dirty.append(int(hit.any(dim=0).sum()))
            return got
        self.nd.duel_rearm_cuda = held
        return self

    def __exit__(self, *exc):
        self.nd.duel_rearm_cuda = self._kernel

    def summary(self) -> dict:
        return dict(calls=self.calls, bitwise=self.equal,
                    promoted_mean=float(np.mean(self.promoted or [0])),
                    promoted_max=max(self.promoted or [0]),
                    dirty_rows_mean=float(np.mean(self.dirty or [0])),
                    dirty_rows_max=max(self.dirty or [0]))


class duel_recorder:
    """Context manager: every duel plane a ``SimCacheEngine`` arms inside
    it (``_arm_duel``, patched on the class) is recorded with its initial
    slots and every batch it observes (objects, the lookup's b1 at the
    bucket shape, n_valid), for :func:`hold_duel_planes`; restores the
    class on exit."""

    def __enter__(self):
        from repro_torch.serve.engine import SimCacheEngine
        self.cls, self.planes = SimCacheEngine, []
        arm = self.arm = SimCacheEngine._arm_duel
        planes = self.planes

        def recording_arm(eng, inst, slots):
            arm(eng, inst, slots)
            rec = dict(plane=eng.duel, slots0=np.asarray(slots).copy(),
                       batches=[])
            observe = eng.duel.observe

            def recording_observe(objs, ings=None, b1_ext=None,
                                  n_valid=None):
                rec["batches"].append((np.asarray(objs).copy(),
                                       b1_ext.detach().clone(), n_valid))
                return observe(objs, ings, b1_ext, n_valid)
            eng.duel.observe = recording_observe
            planes.append(rec)
        SimCacheEngine._arm_duel = recording_arm
        return self

    def __exit__(self, *exc):
        self.cls._arm_duel = self.arm


def hold_duel_planes(torch, planes, ecfg) -> list:
    """Each recorded plane (:class:`duel_recorder`) replayed outside the
    counted run through a second ``DuelPlane`` on the plain scan (torch
    re-arms), whose carry, served cost and step must equal the engine
    plane's bitwise, and through a third on kernel F with every re-arm
    held bitwise against the torch re-arm on the same inputs
    (``RearmHold``); F's scan launches in that replay are the counted
    run's. One dict of fields a plane."""
    import importlib
    nd = importlib.import_module("repro_torch.core.placement.netduel")
    from repro_torch.core.placement import DuelPlane
    from repro_torch.kernels.duel.duel import duel_scan_cuda
    held = []
    for rec in planes:
        p = rec["plane"]
        kw = dict(window=ecfg.duel_window, delta=ecfg.duel_delta,
                  arm_prob=ecfg.duel_arm_prob, seed=ecfg.duel_seed)
        twin = DuelPlane(p.dinst, rec["slots0"], plain=True, **kw)
        again = DuelPlane(p.dinst, rec["slots0"], **kw)
        n0 = duel_scan_cuda.launches
        with RearmHold(torch, nd) as hold:
            for objs, b1, n_valid in rec["batches"]:
                twin.observe(objs, b1_ext=b1, n_valid=n_valid)
                again.observe(objs, b1_ext=b1, n_valid=n_valid)
        held.append(dict(
            batches=len(rec["batches"]),
            scan_launches=duel_scan_cuda.launches - n0,
            promotions=p.n_promotions,
            carry_bitwise=all(torch.equal(a, b)
                              for a, b in zip(p.carry, twin.carry)),
            served_equal=p.served_cost == twin.served_cost,
            t_equal=p.t == twin.t,
            rearms_held=hold.summary(),
            kernel_replay_bitwise=all(torch.equal(a, b) for a, b in
                                      zip(p.carry, again.carry))))
    return held


def duel_held_ok(held) -> bool:
    """Every replayed plane of :func:`hold_duel_planes` equal bitwise."""
    return all(h["carry_bitwise"] and h["served_equal"] and h["t_equal"]
               and h["kernel_replay_bitwise"]
               and h["rearms_held"]["bitwise"] for h in held)


def _rearm_bound(args, n_promoted: int, n_dirty: int):
    """The re-arm's bound from one call's inputs: bytes, the four
    pre-fold tables read (24 B an entry) and the seven tables written
    (40 B), the object rows read once (streamed) or each C_a entry the
    call needs (materialized); operations, a chain of 3·D for each new
    column of a clean row and each slot of a dirty row."""
    pre, coords, ca = args[0], args[6], args[7]
    I, O = pre[0].shape
    K, D = args[1].shape[0], coords.shape[1]
    pairs = (O - n_dirty) * n_promoted + n_dirty * K
    n_bytes = I * O * 64 + (4 * pairs if ca is not None else 4 * O * D)
    return bound_ms(n_bytes, 0 if ca is not None else pairs * 3 * D)


def phase_duel(torch, cat, dem, clock_hz: float):
    """Kernel F at the engine's scale: the 10⁵-object catalog, its
    Zipf(0.8) demand, its three levels (64 / 128 / 256 slots, K = 448,
    h = 0 / 15 / 150, h_repo 1000), C_a streamed (``materialize_ca=False``,
    the engine's duel plane), from ``random_slots`` so that duels
    promote. The scan runs over 2,048 requests with window 256 once
    through F (counted: its steps and its re-arm entry) and once through
    ``_duel_scan_ref``, the plain scan (its re-arms torch ops), both on
    the card; every output must be bitwise equal (events, slots, virt,
    deadlines, both savings, the pre-fold and serving tables, the
    per-step served cost), with at least one promotion. The public
    entry, ``device_netduel``, must give the same. Outside the counted
    run the window runs through F again with every re-arm held bitwise
    against the torch re-arm on the same inputs (``RearmHold``). Times:
    each scan over the window (host included, re-arms included), per
    request; the re-arms alone; F's device time (torch.profiler) and its
    share of the chain floor; the re-arm's device time a call, its
    CUDA-event time and its plain version's on the window's first
    re-arm, beside its bound. The chain floor: a step's streamed pricing
    is one chain of D dependent rounded adds (4 clocks each at the
    card's maximum SM clock), and the steps run in order. F's device
    time on the same window with arming off (no duel priced, one launch)
    is what every step pays besides the chains. Returns F's entry and the
    re-arm's."""
    import importlib

    from repro_torch.core.objective import DeviceInstance, Instance
    from repro_torch.core.placement import device_netduel
    from repro_torch.core.placement.localswap import emulated_stream
    from repro_torch.core.topology import tpu_hierarchy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.duel import duel_rearm_ref
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
    counts = launch_counts()                     # read just after
    launches, rearm_launches = counts["duel_scan"], counts["duel_rearm"]
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
    # every re-arm of the window against the torch re-arm (not counted)
    with RearmHold(torch, nd) as hold:
        hc, _, _ = scan(True)
    held_carry = all(torch.equal(a, b) for a, b in zip(hc, kc))
    dev_t = device_ms(torch, lambda: scan(True), 1, "duel_scan_kernel")
    dev_r = device_ms(torch, lambda: scan(True), 1, "rearm_")
    dev_rows = device_ms(torch, lambda: scan(True), 1, "rearm_rows")
    # the same window with arming off: no duel to price, no promotion,
    # one launch; what every step pays besides the chains
    xs_idle = xs._replace(armf=torch.zeros_like(xs.armf))
    dev_idle = device_ms(torch, lambda: nd._duel_scan(
        dinst, h_slots, on_path, carry0, xs_idle, one_delta, DUEL_WINDOW,
        False, False, 0, kernel=True), 1, "duel_scan_kernel")
    K, D, I = h_slots.shape[1], cat.dim, h_slots.shape[0]
    bms, by, priced = _duel_bound(torch, objs, arm_flags, K, D, I)
    chain_floor = DUEL_T * D * 4 / clock_hz * 1e3
    res = dict(name="duel_scan", catalog=cat.n, dim=D, K=K, T=DUEL_T,
               window=DUEL_WINDOW, arm_prob=DUEL_ARM, setup_s=setup_s,
               promotions=n_prom, promoting_steps=promoting_steps,
               launches=launches, rearm_launches=rearm_launches,
               carry_bitwise=carry_equal,
               b1_bitwise=b1_equal, events_bitwise=events_equal,
               entry_point_equal=entry_equal,
               rearms_held=hold.summary(), held_run_carry_equal=held_carry,
               max_abs_err=max(diffs), ms=k_s * 1e3, plain_ms=p_s * 1e3,
               ms_per_request=k_s * 1e3 / DUEL_T,
               plain_ms_per_request=p_s * 1e3 / DUEL_T,
               rearm_ms=timings.get("rearm_s", 0.0) * 1e3,
               rearms=timings.get("rearms", 0),
               kernel_device_ms=dev_t["device_ms"],
               kernel_device_ms_per_request=dev_t["device_ms"] / DUEL_T,
               kernel_device_ms_arming_off=dev_idle["device_ms"],
               rearm_device_ms_window=dev_r["device_ms"],
               rearm_rows_pass_device_ms_window=dev_rows["device_ms"],
               priced_duels=priced, bound_ms=bms, bound_by=by,
               chain_floor_ms=chain_floor,
               chain_floor_share=chain_floor / dev_t["device_ms"],
               library_ms=None)
    log("duel", **res)
    ok = (all(carry_equal.values()) and b1_equal and events_equal
          and entry_equal and n_prom > 0 and max(diffs) == 0.0
          and launches == promoting_steps + (
              0 if ko.events and ko.events[-1][0] == DUEL_T - 1 else 1)
          and rearm_launches == promoting_steps
          and hold.calls == promoting_steps and hold.equal and held_carry)
    if not ok:
        raise RuntimeError(f"kernel F disagrees with the plain scan: {res}")

    # the re-arm: device time a call over the window's re-arms, beside
    # the mean of their bounds; CUDA-event time and the plain version's
    # on the window's first re-arm's inputs
    args = hold.first
    kernel = nd.duel_rearm_cuda
    r_ms = cuda_ms(torch, lambda: kernel(*args), 20)
    r_plain = cuda_ms(torch, lambda: duel_rearm_ref(*args), 3)
    bounds = [_rearm_bound(args, p_, d_)
              for p_, d_ in zip(hold.promoted, hold.dirty)]
    r_bms = float(np.mean([b[0] for b in bounds]))
    r_by = max({b[1] for b in bounds}, key=[b[1] for b in bounds].count)
    r_dev = dev_r["device_ms"] / max(rearm_launches, 1)
    rearm = dict(name="duel_rearm", O=cat.n, D=D, K=K, I=I,
                 launches=rearm_launches, rearms_held=hold.summary(),
                 max_abs_err=0.0 if hold.equal else None,
                 ms=r_ms, plain_ms=r_plain,
                 first_promoted=hold.promoted[0],
                 first_dirty_rows=hold.dirty[0],
                 first_bound_ms=bounds[0][0], device_ms=r_dev,
                 kernels_per_call=dev_r["launches_per_call"] / max(
                     rearm_launches, 1),
                 bound_ms=r_bms, bound_by=r_by, bound_share=r_bms / r_dev,
                 library_ms=None)
    log("duel_rearm", **rearm)
    return res, rearm


# warm requests of the duel_engine run: its replay on the
# plain scan takes as long as the run
DUEL_ENGINE_WARM = 2048


def phase_duel_engine(torch, params):
    """The online plane on the serving path, at full width: the ``stream``
    phase's engine (granite-3-2b, 40 layers, flash attention, the
    20,000-object catalog, 4 Zipf(1.0) streams) with ``netduel`` and
    ``refresh_on_promotion``: 1,024 cold requests, ``refresh_placement()``
    (which arms the duel plane), 2,048 warm requests behind
    ``StreamDriver``, ``drain_refresh()``. The launch counts are zeroed
    just before and read just after. Every batch each duel plane observed
    (objects, the lookup's b1 at the bucket shape, n_valid) is recorded;
    outside the counted run each plane's batches are replayed through a
    second ``DuelPlane`` on the plain scan (torch re-arms), whose carry
    must equal the engine plane's bitwise, and through a third on kernel
    F with every re-arm held bitwise against the torch re-arm on the
    same inputs (``RearmHold``): :func:`hold_duel_planes`. Its solves are
    GREEDY alone (the ``stream`` phase runs the cascade on the same
    catalog)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import catalog as catalog_api
    from repro_torch.core import demand as demand_api
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import (EngineConfig, SimCacheEngine,
                                   StreamDriver, StreamSpec)

    cfg = dataclasses.replace(get_config("granite-3-2b"),
                              use_flash_attention=True)
    cat = catalog_api.embedding_catalog(n=20_000, dim=100, seed=1)
    ecfg = EngineConfig(h_ici=15.0, h_dcn=150.0, h_model=1000.0,
                        netduel=True, refresh_on_promotion=True,
                        algo="greedy")
    eng = SimCacheEngine(cfg, params, ecfg, cat.coords)
    streams = [StreamSpec(demand=demand_api.zipf(cat, alpha=1.0, seed=s + 1),
                          rate=1.0 + s, seed=s + 1, name=f"stream{s}")
               for s in range(4)]
    drv = StreamDriver(eng, streams, max_batch=256, batch_window=2.0,
                       prompt_len=128, refresh_every=0)
    with duel_recorder() as recorder:
        reset_launch_counts()                    # the main path's run
        t0 = time.perf_counter()
        cold = drv.run(1024)
        cold_stats, eng.stats = eng.stats, type(eng.stats)()
        pred = eng.refresh_placement()
        warm = drv.run(DUEL_ENGINE_WARM)
        t = time.perf_counter()
        drained = drv.drain_refresh()
        drain_s = time.perf_counter() - t
        counts = launch_counts()                  # read just after
    phase_s = time.perf_counter() - t0
    w = eng.stats

    planes = recorder.planes
    t = time.perf_counter()
    held = hold_duel_planes(torch, planes, ecfg)
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
              duel_held_ok(held),
              counts["duel_rearm"] == sum(h["rearms_held"]["calls"]
                                          for h in held) > 0]
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


GEN_B, GEN_PROMPT, GEN_STEPS = 4, 512, 16       # the ``generate`` phase
# the ``generate_wide`` phase: (arch, depth kept or None for all, steps)
GEN_WIDE = (("phi3-medium-14b", None, 16), ("deepseek-coder-33b", 8, 8),
            ("deepseek-67b", 8, 8))
GEN_WIDE_B, GEN_WIDE_PROMPT = 2, 1024
NEAR_TIE = 1e-3            # a top-2 logit gap below this may flip argmax


class kept_flash_inputs:
    """Inside the block, kernel E's entry (``flash_ops.flash_attention``)
    is wrapped so that the first (q, k, v) it gets with each ``causal``
    setting is kept (a copy) in the dict the block yields; the entry
    itself runs unchanged."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as flash_ops
        self.ops, self.flash, kept = flash_ops, flash_ops.flash_attention, {}

        def keep_first(q, k, v, causal=True):
            if causal not in kept:
                kept[causal] = (q.clone(), k.clone(), v.clone())
            return self.flash(q, k, v, causal=causal)
        flash_ops.flash_attention = keep_first
        return kept

    def __exit__(self, *exc):
        self.ops.flash_attention = self.flash


def counted_generate(torch, cfg, params, prompt, n_steps: int):
    """One ``greedy_generate`` call, the main path's run: the launch
    counts zeroed just before and read just after, kernel E's first input
    (layer 0's prefill Q, K, V) kept (:class:`kept_flash_inputs`).
    Returns the tokens, E's launches and that (q, k, v), or None with
    flash off (or no attention layer)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import greedy_generate
    with kept_flash_inputs() as kept:
        reset_launch_counts()
        toks = greedy_generate(cfg, params, prompt, n_steps)
        torch.cuda.synchronize()
        launches = launch_counts()["flash_attention"]
    return toks, launches, kept.get(True)


E_FIELDS = ("ms", "bound_ms", "bound_by", "library_ms", "plain_ms",
            "worst_err_over_tol", "vs_blocked_worst_err_over_tol",
            "tflop_per_s")


def decode_run(torch, cfg, params, prompt, n_steps: int, feed=None,
               perturb=None, extra=None, keep_prefill: bool = False
               ) -> dict:
    """``greedy_generate``'s loop through the same entry points
    (``make_prefill`` → ``_pad_caches`` → ``make_serve_step``); it must
    follow ``greedy_generate`` step for step (its callers check that the
    tokens are the counted call's), so a change there is made here too.
    It keeps
    every step's logits (the prefill's last position, then each serve
    step's) and timing the prefill and each step with CUDA events. With
    ``feed`` (B, n_steps) the steps are fed those tokens (another run's)
    in place of their own argmax, so two runs' logits are of one
    sequence. ``perturb(caches, positions)``, where given, edits the
    padded cache after the prefill (the prompt's positions) and after
    each step (the step's position). ``extra`` adds entries to the
    prefill's batch (an encoder-decoder's ``audio_embeds``: its serve
    steps then read the encoder output from the cache, where
    ``greedy_generate`` refuses it); ``keep_prefill`` keeps the
    prefill's logits at every position (``prefill_logits``, f32)."""
    from repro_torch.models.model import (_pad_caches, make_prefill,
                                          make_serve_step)
    B, S = prompt.shape
    step = make_serve_step(cfg)
    batch = {"tokens": prompt, **(extra or {})}
    if cfg.mrope:
        batch["mrope_positions"] = torch.arange(
            S, device=prompt.device)[None, None, :].expand(3, B, S)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * n_steps)]
    ev[0].record()
    logits, caches = make_prefill(cfg)(params, batch)
    ev[1].record()
    with torch.inference_mode():
        caches = _pad_caches(cfg, caches, S + n_steps)
        if perturb:
            perturb(caches, slice(0, S))
    tok = logits[:, -1:].argmax(dim=-1)
    out, toks = [logits[:, -1].float()], [tok]
    prefill_logits = logits.float() if keep_prefill else None
    del logits
    for t in range(n_steps - 1):
        if feed is not None:
            tok = feed[:, t:t + 1]
        ev[2 + 2 * t].record()
        lg, caches = step(params, tok, caches, S + t)
        ev[3 + 2 * t].record()
        if perturb:
            with torch.inference_mode():
                perturb(caches, slice(S + t, S + t + 1))
        tok = lg[:, -1:].argmax(dim=-1)
        out.append(lg[:, -1].float())
        toks.append(tok)
    torch.cuda.synchronize()
    step_ms = [ev[2 + 2 * t].elapsed_time(ev[3 + 2 * t])
               for t in range(n_steps - 1)]
    return dict(tokens=torch.cat(toks, 1), logits=torch.stack(out, 1),
                prefill_ms=ev[0].elapsed_time(ev[1]), step_ms=step_ms,
                caches=caches, prefill_logits=prefill_logits)


def step_profile(torch, cfg, params, run, pos: int) -> dict:
    """One serve step at ``pos`` on ``run``'s cache, profiled: its device
    time (every device event, torch.profiler), its share of the step's
    CUDA-event p50 (the rest is the device idle, waiting on the host),
    and the host's top ops by self time (:func:`host_ops`)."""
    from repro_torch.models.model import make_serve_step
    step = make_serve_step(cfg)
    tok = run["tokens"][:, -1:]

    def fn():
        return step(params, tok, run["caches"], pos)
    dev = device_ms(torch, fn, 1, "")     # ~3,600 device events a step
    p50 = float(np.percentile(run["step_ms"], 50))
    return dict(device_ms=dev["device_ms"],
                device_events=dev["launches_per_call"],
                idle_share=1.0 - dev["device_ms"] / p50,
                host=host_ops(torch, fn, 1))


def teacher_logits(torch, cfg, params, prompt, tokens,
                   whole: bool = False):
    """The full teacher-forced forward (mode "train") over the prompt and
    the generated tokens but the last: (B, n, V) f32 logits at the
    positions that produced each generated token. With ``whole`` the
    forward runs over every generated token and its last position is
    dropped (a causal no-op, for a chunked scan whose chunk count must
    divide the length: S 512 + 8 = 520 where 519 would not)."""
    seq = torch.cat([prompt, tokens if whole else tokens[:, :-1]], dim=1)
    with torch.inference_mode():
        logits, _ = params(seq, cfg=cfg, mode="train")
    n = tokens.shape[1]
    return logits[:, prompt.shape[1] - 1:][:, :n].float()


def hold_f32_decode(run, full, skip=None) -> dict:
    """An f32 decode against the f32 full forward: every step's logits to
    1e-3 (two f32 computations of the same function, summed in other
    orders; ``phase_prefill``'s f32 rule), and the greedy tokens equal
    to the full forward's argmax except where its top-2 gap is under
    ``NEAR_TIE`` (counted and logged). ``skip`` (B, n), where given,
    names positions left out of both (router near-ties, where a whole
    expert may swap); they are listed."""
    keep = None if skip is None else ~skip
    d = (run["logits"] - full).abs().amax(-1)
    diff = float(d.max() if keep is None else d[keep].max())
    top2 = full.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < NEAR_TIE
    mismatch = run["tokens"] != full.argmax(dim=-1)
    if keep is not None:
        near, mismatch = near & keep, mismatch & keep
    out = dict(max_abs_logit_diff=diff, tol=1e-3,
               near_ties=int(near.sum()),
               token_mismatches=int(mismatch.sum()),
               mismatches_off_near_ties=int((mismatch & ~near).sum()),
               ok=diff <= 1e-3 and not bool((mismatch & ~near).any()))
    if skip is not None:
        out["skipped"] = [tuple(map(int, p)) for p in skip.nonzero()]
    return out


def step_fields(run, B: int) -> dict:
    ms = np.asarray(run["step_ms"])
    return dict(prefill_ms=run["prefill_ms"],
                step_ms_p50=float(np.percentile(ms, 50)),
                step_ms_p95=float(np.percentile(ms, 95)),
                tokens_per_s=B * 1e3 / float(np.percentile(ms, 50)))


def cache_bytes(caches) -> int:
    return sum(x.numel() * x.element_size() for c in caches
               for x in c.values())


def decode_bound(cfg, compute_dtype: str, B: int, max_len: int,
                 kv_bytes_per_token: int) -> dict:
    """The least time of one decode step, bound by bytes: the f32
    weights it uses read once and, in bf16 compute, their bf16 casts
    written (the reference casts every weight at every call), plus the
    cache read over ``max_len`` positions. An untied embedding table is
    only gathered, B rows (cast after the gather); a tied one is the head
    and is read whole. The operations (2 a matmul parameter a token) are
    far below the bytes at B ≤ 4."""
    from repro_torch.models.schema import param_count
    n = param_count(cfg, padded=True)
    table = cfg.padded_vocab * cfg.d_model
    used = n if cfg.tie_embeddings else n - table + B * cfg.d_model
    matmul = n if cfg.tie_embeddings else n - table
    read = 4 * used + B * max_len * kv_bytes_per_token
    written = 2 * used if compute_dtype == "bfloat16" else 0
    bms, by = bound_ms(read + written, 2 * matmul * B, PEAK_BF16_FLOPS
                       if compute_dtype == "bfloat16" else PEAK_FP32_FLOPS)
    return dict(gb_read=read / 1e9, gb_written=written / 1e9,
                bound_ms=bms, bound_by=by)


def int8_perturbation(torch, seed: int):
    """``perturb`` for :func:`decode_run`: every cached K/V element at the
    given positions moves by the most the int8 cache can move it — half
    a quantization step (scale / 2, scale = max|x| / 127 over its
    (token, head)) plus the two bf16 roundings of the dequantization
    (2^-8·|x|) — in a random sign."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def perturb(caches, sl):
        for c in caches:
            for key in ("k", "v"):
                x = c[key][:, sl].float()
                scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
                sign = torch.randint(0, 2, x.shape, generator=g,
                                     device=x.device) * 2.0 - 1.0
                c[key][:, sl] = (x + sign * (scale / 2 + 2.0 ** -8
                                             * x.abs())).to(c[key].dtype)
    return perturb


def phase_generate(torch, params, clock_hz: float) -> dict:
    """``greedy_generate`` on granite-3-2b at full width and depth (the
    ``prefill`` phase's weights), B 4, a 512-token prompt, 16 new tokens,
    in three settings: f32 compute with flash off; bf16 with flash on
    (kernel E in every prefill); bf16 with flash on and
    ``kv_cache_dtype="int8"``. Each is one counted ``greedy_generate``
    call (launch counts zeroed just before, read just after), then the
    same loop kept step by step (:func:`decode_run`), whose tokens must
    be the call's, for the holds and the times:

    - f32: every step's logits against the teacher-forced full forward
      (:func:`hold_f32_decode`);
    - bf16: every step's logits against the bf16 full forward (flash
      on), within what bf16 moves the f32 full forward's logits on the
      same tokens (``phase_prefill``'s rule);
    - int8: every step's logits, fed the bf16 run's tokens, against the
      bf16-cache decode, within the bound of :func:`int8_perturbation`:
      the bf16-cache decode, fed the same tokens, run again with each
      cached element moved by the most the int8 cache moves it, in
      random sign; its largest logit move is the bound (the current
      token's own K/V is unmoved in that run).

    Kernel E is held against its plain versions and timed beside SDPA
    (:func:`hold_kernel_e`) on the Q/K/V of layer 0 that the counted bf16
    call gave it (:func:`counted_generate`).

    Logs prefill ms, decode step ms (p50, p95), tokens/s, E's launches,
    the cache bytes against 81,920 B a token a sequence in bf16, the
    decode step's bound (:func:`decode_bound`) and, for one bf16 serve
    step, its device time (all device events), idle share and the
    host's top ops."""
    from repro_torch.configs.registry import get_config

    t0 = time.perf_counter()
    base = get_config("granite-3-2b")
    B, S, n = GEN_B, GEN_PROMPT, GEN_STEPS
    prompt = torch.as_tensor(np.random.default_rng(5).integers(
        0, base.vocab, (B, S)), device="cuda")
    f32 = dataclasses.replace(base, compute_dtype="float32")
    bf16 = dataclasses.replace(base, use_flash_attention=True)
    int8 = dataclasses.replace(bf16, kv_cache_dtype="int8")
    runs, launches, res = {}, {}, {}
    for name, cfg in (("f32", f32), ("bf16", bf16), ("int8", int8)):
        toks, launches[name], qkv = counted_generate(torch, cfg, params,
                                                     prompt, n)
        e = (hold_kernel_e(torch, *qkv, clock_hz) if name == "bf16"
             else None)
        del qkv
        runs[name] = decode_run(torch, cfg, params, prompt, n)
        if not torch.equal(runs[name]["tokens"], toks):
            raise RuntimeError(f"generate: the step-by-step {name} run "
                               f"gave other tokens than greedy_generate")
        kv_bytes = cache_bytes(runs[name]["caches"]) // (B * (S + n))
        res[name] = dict(**step_fields(runs[name], B),
                         flash_launches=launches[name],
                         cache_bytes_per_token=kv_bytes,
                         **decode_bound(base, cfg.compute_dtype, B,
                                        S + n, kv_bytes))
        if name == "bf16":
            res[name]["flash"] = dict((k, e[k]) for k in E_FIELDS)
            res[name]["step_profile"] = step_profile(
                torch, cfg, params, runs[name], S + n - 1)
        del runs[name]["caches"]
    full32 = teacher_logits(torch, f32, params, prompt,
                            runs["f32"]["tokens"])
    res["f32"]["hold"] = hold_f32_decode(runs["f32"], full32)
    del full32
    toks_bf = runs["bf16"]["tokens"]
    full_bf = teacher_logits(torch, bf16, params, prompt, toks_bf)
    noise = float((full_bf - teacher_logits(torch, f32, params, prompt,
                                            toks_bf)).abs().max())
    d_bf = float((runs["bf16"]["logits"] - full_bf).abs().max())
    res["bf16"]["hold"] = dict(max_abs_logit_diff=d_bf, tol=noise,
                               ratio=d_bf / noise,
                               tokens_equal_full_argmax=bool(torch.equal(
                                   toks_bf, full_bf.argmax(-1))),
                               ok=d_bf <= noise)
    del full_bf
    fed = decode_run(torch, int8, params, prompt, n, feed=toks_bf)
    moved = decode_run(torch, bf16, params, prompt, n, feed=toks_bf,
                       perturb=int8_perturbation(torch, 0))
    del fed["caches"], moved["caches"]
    bound = float((moved["logits"] - runs["bf16"]["logits"]).abs().max())
    d8 = float((fed["logits"] - runs["bf16"]["logits"]).abs().max())
    res["int8"]["hold"] = dict(
        max_abs_logit_diff_vs_bf16_cache=d8, bound=bound,
        ratio=d8 / bound, ok=d8 <= bound,
        own_tokens_equal_bf16=float((runs["int8"]["tokens"] == toks_bf)
                                    .float().mean()))
    out = dict(model=base.name, n_layers=base.n_layers, B=B, prompt=S,
               new_tokens=n, **res,
               bf16_cache_reckoning=base.n_layers * 2 * base.n_kv_heads
               * base.head_dim * 2,
               phase_s=time.perf_counter() - t0)
    log("generate", **out)
    checks = [res["f32"]["hold"]["ok"], res["bf16"]["hold"]["ok"],
              res["int8"]["hold"]["ok"],
              launches["f32"] == 0,
              launches["bf16"] == launches["int8"] == base.n_layers,
              res["bf16"]["cache_bytes_per_token"]
              == out["bf16_cache_reckoning"] == 81_920,
              res["int8"]["cache_bytes_per_token"]
              < res["bf16"]["cache_bytes_per_token"]]
    if not all(checks):
        raise RuntimeError(f"generate phase failed its checks: {checks}")
    return dict(flash_attention=sum(launches.values()))


def phase_generate_wide(torch, clock_hz: float) -> dict:
    """phi3-medium-14b at full width and depth, deepseek-coder-33b and
    deepseek-67b at full width cut to 8 layers (their f32 weights at full
    depth, 133 and 270 GB, do not fit one card), random weights from a
    seed, B 2, a 1,024-token prompt. For each: one counted
    ``greedy_generate`` in bf16 with flash on (kernel E in the prefill),
    whose first layer's Q/K/V are kept (:func:`counted_generate`);
    kernel E held on them against its
    plain versions and timed beside SDPA (:func:`hold_kernel_e`); the
    same run step by step for the prefill and decode step times; and an
    f32 decode (flash off) held against the f32 full forward
    (:func:`hold_f32_decode`). Logs peak memory."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import init_params

    t0 = time.perf_counter()
    B, S = GEN_WIDE_B, GEN_WIDE_PROMPT
    total, rows = 0, []
    start_gib = torch.cuda.memory_allocated() / 2 ** 30
    for arch, depth, n in GEN_WIDE:
        t = time.perf_counter()
        full = get_config(arch)
        cfg = full if depth is None else dataclasses.replace(
            full, n_layers=depth)
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, seed=0)
        prompt = torch.as_tensor(np.random.default_rng(6).integers(
            0, cfg.vocab, (B, S)), device="cuda")
        bf16 = dataclasses.replace(cfg, use_flash_attention=True)
        toks, e_launches, qkv = counted_generate(torch, bf16, params,
                                                 prompt, n)
        total += e_launches
        e = hold_kernel_e(torch, *qkv, clock_hz)
        del qkv
        run = decode_run(torch, bf16, params, prompt, n)
        same = bool(torch.equal(run["tokens"], toks))
        kv_bytes = cache_bytes(run["caches"]) // (B * (S + n))
        del run["caches"]
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        run32 = decode_run(torch, f32, params, prompt, n)
        del run32["caches"]
        hold = hold_f32_decode(run32, teacher_logits(
            torch, f32, params, prompt, run32["tokens"]))
        row = dict(model=arch, n_layers=cfg.n_layers,
                   reduced=({} if depth is None else
                            {"n_layers": [full.n_layers, depth]}),
                   d_model=cfg.d_model, H=cfg.n_heads, KH=cfg.n_kv_heads,
                   Dh=cfg.head_dim, B=B, prompt=S, new_tokens=n,
                   flash_launches=e_launches,
                   flash=dict((k, e[k]) for k in E_FIELDS),
                   bf16=dict(**step_fields(run, B), tokens_equal=same,
                             cache_bytes_per_token=kv_bytes,
                             **decode_bound(cfg, "bfloat16", B,
                                            S + n, kv_bytes)),
                   f32=dict(**step_fields(run32, B), hold=hold,
                            **decode_bound(cfg, "float32", B, S + n,
                                           2 * kv_bytes)),
                   max_memory_allocated_gib=torch.cuda
                   .max_memory_allocated() / 2 ** 30,
                   seconds=time.perf_counter() - t)
        log("generate_wide", **row)
        rows.append(row)
        del params, run, run32, toks, prompt
        gc.collect()
        torch.cuda.empty_cache()
        if not (same and hold["ok"] and e_launches == cfg.n_layers):
            raise RuntimeError(f"generate_wide failed its checks on {arch}: "
                               f"tokens {same}, f32 hold {hold}, "
                               f"E launches {e_launches}")
    log("generate_wide", start_allocated_gib=start_gib,
        phase_s=time.perf_counter() - t0)
    return dict(flash_attention=total)


# the ``families`` phase: (arch, the fields cut to fit one card, or {})
FAMILIES = (("granite-moe-3b-a800m", {}),
            ("dbrx-132b", {"n_layers": 2}),
            ("jamba-1.5-large-398b", {"n_layers": 8, "moe_experts": 4}),
            ("xlstm-350m", {}),
            ("qwen2-vl-7b", {}),
            ("whisper-small", {}))
FAM_B, FAM_PROMPT, FAM_STEPS = 2, 512, 8
WHISPER_PROMPT = 64        # decoder tokens before the 8 held serve steps
VLM_GRID = 16              # image patches on a 16 × 16 grid before 256 tokens
ROUTER_NEAR_TIE = 1e-6     # a router gap below this may swap a whole expert


class moe_watch:
    """Inside the block, the port's MoE layer (``moe.moe_mlp``) is wrapped:
    for each call its capacity factor, the token-slots its capacity
    dropped, its slots (tokens × k) and its router gaps ((B, S): the
    k-th minus the (k+1)-th router probability) go into the list the
    block yields, as tensors (no host sync); the layer runs unchanged."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.fn, calls = moe, moe.moe_mlp, []

        def watched(x, router, we_gate, we_up, we_down, topk,
                    capacity_factor=1.25, group_size=512,
                    dispatch="einsum", **kw):
            B, S, D = x.shape
            E = router.shape[1]
            G, Tg = moe._groups(B * S, group_size)
            _, idx, _ = moe._route(x.reshape(-1, D), router, topk)
            _, keep = moe._positions_in_expert(
                idx.reshape(G, Tg, topk), E,
                moe._capacity(Tg, topk, E, capacity_factor))
            calls.append(dict(cf=capacity_factor, dropped=(~keep).sum(),
                              slots=B * S * topk,
                              gaps=moe.router_gaps(x, router, topk)))
            return self.fn(x, router, we_gate, we_up, we_down, topk,
                           capacity_factor, group_size, dispatch, **kw)
        moe.moe_mlp = watched
        return calls

    def __exit__(self, *exc):
        self.moe.moe_mlp = self.fn


def vlm_image_prefill(torch, cfg, params) -> dict:
    """qwen2-vl's stub vision path: 256 image embeddings (B, 256, 1280)
    projected by ``vision_proj`` and put before 256 tokens, with Qwen2-VL's
    (3, B, 512) M-RoPE ids (the patches on a 16 × 16 grid: temporal 0,
    height i // 16, width i % 16; the text's three ids equal, past the
    grid). One counted f32 prefill with flash on (E's f32 path, one
    launch a layer), held against the f32 train-mode forward with flash
    off to 1e-3 (the f32 rule of :func:`hold_f32_decode`)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import make_prefill
    B, n_img = FAM_B, VLM_GRID * VLM_GRID
    g = torch.Generator(device="cuda").manual_seed(8)
    img = torch.randn(B, n_img, 1280, generator=g, device="cuda")
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab, (B, 256)), device="cuda")
    i = torch.arange(n_img, device="cuda")
    ids = torch.cat([torch.stack([0 * i, i // VLM_GRID, i % VLM_GRID]),
                     (VLM_GRID + torch.arange(256, device="cuda"))
                     .expand(3, 256)], dim=1)[:, None].expand(3, B, -1)
    f32 = dataclasses.replace(cfg, compute_dtype="float32",
                              use_flash_attention=True)
    reset_launch_counts()
    logits, caches = make_prefill(f32)(params, dict(
        tokens=toks, image_embeds=img, mrope_positions=ids))
    torch.cuda.synchronize()
    launches = launch_counts()["flash_attention"]
    with torch.inference_mode():
        ref, _ = params(toks, cfg=dataclasses.replace(
            f32, use_flash_attention=False), mode="train",
            image_embeds=img, mrope_positions=ids)
    diff = float((logits - ref).abs().max())
    shape_ok = (tuple(logits.shape) == (B, n_img + 256, cfg.padded_vocab)
                and tuple(caches[0]["k"].shape)
                == (B, n_img + 256, cfg.n_kv_heads, cfg.head_dim))
    return dict(image_patches=n_img, tokens=256, flash_launches=launches,
                max_abs_logit_diff=diff, tol=1e-3, shape_ok=shape_ok,
                ok=diff <= 1e-3 and shape_ok and bool(
                    torch.isfinite(logits).all()))


def family_decoder(torch, arch: str, cuts: dict, clock_hz: float) -> dict:
    """One decoder-only family at full width (``cuts`` applied): random
    weights from a seed, B 2, a 512-token prompt, 8 new tokens. A counted
    bf16 ``greedy_generate`` with flash on (E in the prefill's attention
    layers, its first input kept: :func:`counted_generate`); E held on it
    (:func:`hold_kernel_e`); the same run step by step (its times, its
    tokens the counted call's); for MoE, one more bf16 prefill at the
    config's capacity (1.25) whose dropped token-slots are counted
    (:class:`moe_watch`); an f32 decode (flash off) held against the f32
    teacher-forced forward (:func:`hold_f32_decode`). MoE runs both at
    no drop (capacity −1: a prefill at 1.25 may drop and the forward
    would not) and skips, naming them, the held positions whose router
    gap is below ``ROUTER_NEAR_TIE`` in some layer of the forward."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import init_params, make_prefill
    from repro_torch.models.schema import block_pattern, layer_kinds
    t = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, **cuts)
    B, S, n = FAM_B, FAM_PROMPT, FAM_STEPS
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0)
    prompt = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (B, S)), device="cuda")
    bf16 = dataclasses.replace(cfg, use_flash_attention=True)
    toks, e_launches, qkv = counted_generate(torch, bf16, params, prompt, n)
    n_attn = sum(kind.startswith("attn") for _, kind in layer_kinds(cfg))
    e = hold_kernel_e(torch, *qkv, clock_hz) if qkv is not None else None
    del qkv
    run = decode_run(torch, bf16, params, prompt, n)
    same = bool(torch.equal(run["tokens"], toks))
    kv_bytes = cache_bytes(run["caches"]) // (B * (S + n))
    del run["caches"]
    row = dict(model=arch, reduced={k: [getattr(full, k), v]
                                    for k, v in cuts.items()},
               pattern=block_pattern(cfg), n_layers=cfg.n_layers,
               d_model=cfg.d_model, H=cfg.n_heads, KH=cfg.n_kv_heads,
               Dh=cfg.head_dim, B=B, prompt=S, new_tokens=n,
               flash_launches=e_launches, attention_layers=n_attn,
               flash=e and dict((k, e[k]) for k in E_FIELDS),
               bf16=dict(**step_fields(run, B), tokens_equal=same,
                         cache_bytes_per_token=kv_bytes,
                         **decode_bound(cfg, "bfloat16", B, S + n,
                                        kv_bytes)))
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    skip = None
    if cfg.moe_experts:
        with moe_watch() as calls:
            make_prefill(bf16)(params, {"tokens": prompt})
        dropped = int(sum(c["dropped"] for c in calls))
        f32 = dataclasses.replace(f32, capacity_factor=-1.0)
    run32 = decode_run(torch, f32, params, prompt, n)
    del run32["caches"]
    with moe_watch() as tcalls:
        full32 = teacher_logits(torch, f32, params, prompt,
                                run32["tokens"], whole=True)
    if cfg.moe_experts:
        gaps = torch.stack([c["gaps"] for c in tcalls]).amin(0)  # (B, S+n)
        held = gaps[:, S - 1:S - 1 + n]
        skip = held < ROUTER_NEAR_TIE
        row["moe"] = dict(capacity_factor=cfg.capacity_factor,
                          prefill_dropped_slots=dropped,
                          prefill_slots=sum(c["slots"] for c in calls),
                          min_router_gap_held=float(held.min()),
                          near_ties_held=int(skip.sum()),
                          near_ties_prompt=int((gaps[:, :S - 1]
                                                < ROUTER_NEAR_TIE).sum()))
    hold = hold_f32_decode(run32, full32, skip)
    del full32
    row["f32"] = dict(**step_fields(run32, B), hold=hold)
    checks = [same, hold["ok"], e_launches == n_attn,
              (e is not None) == (n_attn > 0)]
    if cfg.mrope:
        row["vlm_image"] = vlm_image_prefill(torch, cfg, params)
        checks += [row["vlm_image"]["ok"],
                   row["vlm_image"]["flash_launches"] == n_attn]
        e_launches += row["vlm_image"]["flash_launches"]
    row.update(max_memory_allocated_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30, seconds=time.perf_counter() - t)
    log("families", **row)
    del params, run, run32, toks, prompt
    gc.collect()
    torch.cuda.empty_cache()
    if not all(checks):
        raise RuntimeError(f"families failed its checks on {arch}: {checks}")
    return dict(flash_attention=e_launches)


def family_whisper(torch, clock_hz: float) -> dict:
    """whisper-small whole (12 encoder and 12 decoder layers): 1,500 audio
    frames (``cross_len``, the stub's features from a seed), a 64-token
    decoder prompt. One counted bf16 run with flash on — the prefill
    (the encoder's 12 non-causal attentions and the decoder's 12 causal
    ones through E) and 7 serve steps, greedy, through
    :func:`decode_run` (``greedy_generate`` refuses an encoder-decoder,
    as the reference) — whose first non-causal (encoder layer 0, S
    1,500) and first causal (decoder layer 0, S 64) inputs of E are kept
    and held (:func:`hold_kernel_e`). Then the reference's
    ``test_whisper_parity`` at full size, f32, flash off: the prefill
    and 8 serve steps fed the next tokens, against ``encdec_forward`` in
    train mode over all 72 tokens, the prefill's every position and each
    step's logits to 1e-3 (:func:`hold_f32_decode`)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import encdec
    from repro_torch.models.model import init_params
    from repro_torch.models.schema import block_pattern
    t = time.perf_counter()
    cfg = get_config("whisper-small")
    B, S, n = FAM_B, WHISPER_PROMPT, FAM_STEPS
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0)
    g = torch.Generator(device="cuda").manual_seed(10)
    audio = {"audio_embeds": torch.randn(B, cfg.cross_len, 128, generator=g,
                                         device="cuda")}
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        0, cfg.vocab, (B, S + n)), device="cuda")
    bf16 = dataclasses.replace(cfg, use_flash_attention=True)
    with kept_flash_inputs() as kept:
        reset_launch_counts()
        run = decode_run(torch, bf16, params, toks[:, :S], n, extra=audio)
        torch.cuda.synchronize()
        e_launches = launch_counts()["flash_attention"]
    e_enc = hold_kernel_e(torch, *kept.pop(False), clock_hz, causal=False)
    e_dec = hold_kernel_e(torch, *kept.pop(True), clock_hz)
    kv_bytes = cache_bytes(run["caches"]) // (B * (S + n))
    del run["caches"]
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    run32 = decode_run(torch, f32, params, toks[:, :S], n + 1,
                       feed=toks[:, S:], extra=audio, keep_prefill=True)
    del run32["caches"]
    with torch.inference_mode():
        full, _, _ = encdec.encdec_forward(
            f32, params, {"tokens": toks, **audio}, mode="train")
    pre_diff = float((run32["prefill_logits"] - full[:, :S].float())
                     .abs().max())
    hold = hold_f32_decode(run32, full[:, S - 1:].float())
    del full
    n_attn = cfg.n_layers + cfg.n_enc_layers
    row = dict(model="whisper-small", reduced={}, pattern=block_pattern(cfg),
               n_layers=cfg.n_layers, n_enc_layers=cfg.n_enc_layers,
               d_model=cfg.d_model, H=cfg.n_heads, KH=cfg.n_kv_heads,
               Dh=cfg.head_dim, B=B, frames=cfg.cross_len, prompt=S,
               new_tokens=n, flash_launches=e_launches,
               attention_layers=n_attn,
               flash=dict((k, e_dec[k]) for k in E_FIELDS),
               flash_encoder=dict(S=e_enc["S"], causal=False,
                                  **{k: e_enc[k] for k in E_FIELDS}),
               bf16=dict(**step_fields(run, B),
                         cache_bytes_per_token=kv_bytes),
               f32=dict(prefill_max_abs_logit_diff=pre_diff, hold=hold),
               max_memory_allocated_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30, seconds=time.perf_counter() - t)
    log("families", **row)
    del params, run, run32, toks, audio
    gc.collect()
    torch.cuda.empty_cache()
    checks = [hold["ok"], pre_diff <= 1e-3, e_launches == n_attn]
    if not all(checks):
        raise RuntimeError(f"families failed its checks on whisper-small: "
                           f"{checks}")
    return dict(flash_attention=e_launches)


def phase_families(torch, clock_hz: float) -> dict:
    """The other model families at full width on the card (item 14b):
    granite-moe-3b-a800m and qwen2-vl-7b whole, dbrx-132b cut to 2 of 40
    layers and jamba-1.5-large-398b to one super-block (8 of 72 layers)
    with 4 of its 16 experts (top-2 kept) — their f32 weights whole,
    527 and 1,592 GB, do not fit one card — and xlstm-350m whole
    (:func:`family_decoder`); whisper-small whole
    (:func:`family_whisper`). Each model is freed before the next.
    Returns E's launches over the counted runs (one a flash attention
    layer of each: ``launches_families``)."""
    t0 = time.perf_counter()
    start_gib = torch.cuda.memory_allocated() / 2 ** 30
    total = 0
    for arch, cuts in FAMILIES:
        res = (family_whisper(torch, clock_hz) if arch == "whisper-small"
               else family_decoder(torch, arch, cuts, clock_hz))
        total += res["flash_attention"]
    log("families", start_allocated_gib=start_gib, flash_launches=total,
        phase_s=time.perf_counter() - t0)
    return dict(flash_attention=total)


TRAIN_ARCH = "granite-3-2b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 6
GRAD_B, GRAD_S = 2, 128                # the card-against-CPU gradient holds
GRAD_TOL = 1e-4     # f32 gradient error / the leaf's max |g| (CPU suite's)
SGD_LR = 0.3        # tests/test_arch_smoke.py's one-step SGD drop
TRAIN_PEAK_GIB = 75.0


def train_batch(cfg, rng, B: int, S: int) -> dict:
    """numpy inputs of a train step of ``cfg``'s family: tokens and labels
    (B, S), and where the family takes them 64 audio frames or 8 image
    patches with M-RoPE ids (the CPU suite's ``family_cases.make_batch``,
    which imports JAX and so is not imported here)."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
             "labels": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.is_encdec:
        batch["audio_embeds"] = rng.standard_normal(
            (B, 64, 128)).astype(np.float32)
    if cfg.mrope:
        batch["image_embeds"] = rng.standard_normal(
            (B, 8, 1280)).astype(np.float32)
        batch["mrope_positions"] = np.broadcast_to(
            np.arange(S + 8)[None, None], (3, B, S + 8)).copy()
    return batch


def on_device(torch, batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device).long()
            if np.issubdtype(v.dtype, np.integer)
            else torch.as_tensor(v).to(device) for k, v in batch.items()}


def hold_grads(torch, cfg, model_cpu, batch: dict, name: str) -> dict:
    """The gradient of every parameter on the card against the port's CPU
    gradient of the same weights and batch, each leaf's error over its
    largest |g| (``GRAD_TOL``). A MoE family's loss is masked, row by
    row, from the first position whose router gap is below
    ``ROUTER_NEAR_TIE`` on (an expert the CPU and the card may choose
    apart, which moves every later position); the masked count is
    logged, and at least half the positions must stay scored."""
    import copy
    from repro_torch.models.model import loss_and_grads, loss_fn
    masked = 0
    if cfg.moe_experts:
        with torch.no_grad(), moe_watch() as calls:
            loss_fn(cfg, model_cpu, on_device(torch, batch, "cpu"))
        gaps = torch.stack([c["gaps"] for c in calls]).amin(0)
        gaps = gaps[:, -batch["labels"].shape[1]:].numpy()
        mask = np.ones(gaps.shape, np.float32)
        for r, row in enumerate(gaps < ROUTER_NEAR_TIE):
            if row.any():
                mask[r, int(np.argmax(row)):] = 0.0
        masked = int((mask == 0).sum())
        batch = dict(batch, loss_mask=mask)
    t = time.perf_counter()
    loss_c, _, g_cpu = loss_and_grads(cfg, model_cpu,
                                      on_device(torch, batch, "cpu"))
    cpu_s = time.perf_counter() - t
    model = copy.deepcopy(model_cpu).to("cuda")
    loss_g, _, g_gpu = loss_and_grads(cfg, model,
                                      on_device(torch, batch, "cuda"))
    worst, worst_leaf, finite = 0.0, None, True
    for leaf, gc_ in g_cpu.items():
        gg = g_gpu[leaf].cpu()
        finite &= bool(torch.isfinite(gg).all())
        scale = float(gc_.abs().max())
        err = float((gg - gc_).abs().max()) / scale if scale > 0 else \
            float((gg - gc_).abs().max())
        if err > worst:
            worst, worst_leaf = err, leaf
    del model, g_gpu
    loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    return dict(model=name, leaves=len(g_cpu), max_err_over_leaf_max=worst,
                worst_leaf=worst_leaf, tolerance=GRAD_TOL,
                loss_rel_err=loss_err, masked_positions=masked,
                cpu_s=cpu_s,
                ok=finite and worst <= GRAD_TOL and loss_err <= GRAD_TOL
                and masked <= batch["labels"].size // 2)


def sgd_drop(torch, cfg, data) -> dict:
    """The first step's batch, its gradient on fresh weights (seed 0, as
    the trainer's), and one SGD step of ``SGD_LR`` on it: the loss of
    that batch must fall (tests/test_arch_smoke.py's form)."""
    from repro_torch.models.model import init_params, loss_and_grads, loss_fn
    model = init_params(cfg, seed=0)
    batch = on_device(torch, data.batch_at(0), "cuda")
    loss0, _, grads = loss_and_grads(cfg, model, batch)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.sub_(SGD_LR * grads[name])
        del grads
        loss1, _ = loss_fn(cfg, model, batch)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(lr=SGD_LR, loss0=float(loss0), loss1=float(loss1),
                ok=float(loss1) < float(loss0))


def train_bound(n_params: int, n_rows: int, tokens: int,
                moment_dtype: str) -> dict:
    """The step's least time: the forward and backward with remat, 8·N·T
    operations at the dense bf16 peak (the attention scores, ~3 % at S
    512, left out), then the update, which follows them, its bytes at
    the memory rate: per parameter p, g, m and v read and p, m and v
    written (f32 moments 28 B; int8 ones 1 B each, 16 B, and per row of
    the last axis, ``n_rows`` in all, the f32 scales of m and v read and
    written, 16 B). The two add: the update starts after the backward
    ends."""
    mom = {"float32": 4, "bfloat16": 2, "int8": 1}[moment_dtype]
    n_bytes = n_params * (4 + 4 + 2 * mom + 4 + 2 * mom)
    if moment_dtype == "int8":
        n_bytes += n_rows * 2 * (4 + 4)
    flops = 8.0 * n_params * tokens
    f_ms = flops / PEAK_BF16_FLOPS * 1e3
    b_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    return dict(step_flops=flops, update_bytes=n_bytes,
                flops_ms=f_ms, update_bytes_ms=b_ms, bound_ms=f_ms + b_ms)


def step_profile_train(torch, cfg, model, tcfg, data) -> dict:
    """Two more steps of the trained model (fresh moments): one split by
    CUDA events into its forward and backward and its AdamW update, one
    through the trainer's own step function under torch.profiler (its
    device time, its device events, which the host launches one by one,
    and the 8 kernels with the most device time); the idle share is read
    against the run's step p50."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.model import loss_and_grads
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.train import make_step
    state = adamw_init(dict(model.named_parameters()), tcfg.opt)
    batch = on_device(torch, data.batch_at(0), "cuda")
    params = dict(model.named_parameters())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(2):                       # a warm-up, then the timed one
        ev[0].record()
        _, _, grads = loss_and_grads(cfg, model, batch)
        ev[1].record()
        adamw_update(grads, state, params, tcfg.opt, lr_scale=1.0)
        ev[2].record()
        del grads
    torch.cuda.synchronize()
    split = dict(forward_backward_ms=ev[0].elapsed_time(ev[1]),
                 update_ms=ev[1].elapsed_time(ev[2]))
    step = make_step(cfg, tcfg.opt, tcfg.warmup, tcfg.steps)
    for _ in range(3):        # a window now and then lacks its device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(model, state, batch)
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            break
    del state
    by_name: dict = {}
    for e in dev:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + (e.time_range.end - e.time_range.start) / 1e3,
                           n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(split, device_ms=sum(t for t, _ in by_name.values()),
                device_events=len(dev),
                top_kernels=[dict(name=k[:80], ms=t, count=n)
                             for k, (t, n) in top])


def train_full(torch, cfg, data, moment_dtype: str) -> dict:
    """``train()`` at full width and depth: ``TRAIN_STEPS`` steps from
    seed 0, no checkpoint; step times from the trainer's CUDA events."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, train
    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(steps=TRAIN_STEPS, ckpt_every=0, log_every=1000,
                       opt=AdamWConfig(lr=1e-3, weight_decay=0.01,
                                       moment_dtype=moment_dtype))
    t = time.perf_counter()
    out = train(cfg, tcfg, data, resume=False, log=lambda *a: None)
    seconds = time.perf_counter() - t
    model = out.pop("params")
    n_params = sum(p.numel() for p in model.parameters())
    n_rows = sum(p.numel() // p.shape[-1] for p in model.parameters())
    prof = step_profile_train(torch, cfg, model, tcfg, data)
    del model
    ms = np.array(out["step_ms"])
    steady = ms[1:]
    p50 = float(np.percentile(steady, 50))
    row = dict(moment_dtype=moment_dtype, losses=out["losses"],
               step_ms=ms.tolist(), first_step_ms=float(ms[0]),
               p50_ms=p50, p95_ms=float(np.percentile(steady, 95)),
               tokens_per_s=TRAIN_B * TRAIN_S / (p50 / 1e3),
               max_memory_allocated_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30, n_params=n_params, seconds=seconds,
               **train_bound(n_params, n_rows, TRAIN_B * TRAIN_S,
                             moment_dtype))
    row["bound_share"] = row["bound_ms"] / p50
    row["profile"] = dict(prof, idle_share=1 - prof["device_ms"] / p50)
    gc.collect()
    torch.cuda.empty_cache()
    return row


def kill_and_resume(torch, cfg) -> dict:
    """At the 2-layer cut: 6 steps straight, then 4 steps checkpointed
    (the "crash") and a resumed run from step 4; its 2 losses against the
    straight run's last 2, to the reference test's 2e-4 (and whether they
    are bitwise)."""
    import shutil
    import tempfile
    from repro_torch.data import SyntheticLMData
    from repro_torch.train import TrainConfig, train
    data = SyntheticLMData(vocab=cfg.vocab, batch=GRAD_B, seq=GRAD_S)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        quiet = dict(log=lambda *a: None)
        full = train(cfg, TrainConfig(steps=6, ckpt_every=0, warmup=2),
                     data, resume=False, **quiet)
        tcfg = TrainConfig(steps=6, ckpt_dir=ckpt, ckpt_every=4, warmup=2)
        train(cfg, tcfg, data, resume=False, stop_after=4, **quiet)
        logs = []
        t = time.perf_counter()
        resumed = train(cfg, tcfg, data, log=logs.append)
        resume_s = time.perf_counter() - t
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    a, b = np.array(resumed["losses"]), np.array(full["losses"][4:])
    ok = (logs[:1] == ["[train] resumed from step 4"] and a.shape == (2,)
          and bool(np.allclose(a, b, rtol=2e-4, atol=2e-4)))
    del full, resumed
    gc.collect()
    torch.cuda.empty_cache()
    return dict(straight=b.tolist(), resumed=a.tolist(),
                bitwise=bool(np.array_equal(a, b)),
                max_abs_diff=float(np.abs(a - b).max()),
                resumed_run_s=resume_s, ok=ok)


def train_launcher() -> dict:
    """``python -m repro_torch.launch.train --arch granite-3-2b --steps
    6`` in a subprocess (its checkpoints in a fresh directory): exit 0
    and a finite final loss on its last line."""
    import os
    import shutil
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_launch_train_")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_ARCH, "--steps", "6", "--ckpt", ckpt]
    t = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=600)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    m = re.search(r"final loss (\S+)$", last)
    loss = float(m.group(1)) if m else float("nan")
    return dict(rc=p.returncode, line=last, final_loss=loss,
                seconds=time.perf_counter() - t,
                stderr_tail=p.stderr[-2000:] if p.returncode else "",
                ok=p.returncode == 0 and bool(np.isfinite(loss)))


def phase_train(torch) -> None:
    """Training (item 14c) on the card. No kernel runs on this path: the
    reference trains with ``use_flash_attention=False`` and kernel E has
    no backward (``flash_attention`` refuses a gradient).

    * granite-3-2b at full width and depth (40 layers, d 2048, f32
      parameters, bf16 compute, remat on) through ``train()`` on
      ``SyntheticLMData(vocab=49155, batch=4, seq=512)``: 6 steps with
      f32 moments, then 6 with int8 moments, each from seed 0: finite
      losses, peak memory under 75 GiB, step p50 / p95 (the first step
      apart), tokens/s, the step's bound; before them the first step's
      batch and gradient with one SGD step (the loss must fall);
    * gradient holds: granite cut to 2 layers at full width (f32
      compute, B 2, S 128) and every other arch at its smoke config,
      every parameter's gradient on the card against the port's CPU
      gradient of the same weights;
    * kill and resume at the 2-layer cut.

    The launcher, ``python -m repro_torch.launch.train``, runs beside
    the serve launcher's runs in the ``launch`` phase."""
    from repro_torch.configs.registry import (get_config, get_smoke_config,
                                              list_archs)
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    data = SyntheticLMData(vocab=cfg.vocab, batch=TRAIN_B, seq=TRAIN_S)
    sgd = sgd_drop(torch, cfg, data)
    runs = [train_full(torch, cfg, data, md) for md in ("float32", "int8")]
    for r in runs:
        log("train", arch=TRAIN_ARCH, B=TRAIN_B, S=TRAIN_S,
            remat=cfg.remat, compute_dtype=cfg.compute_dtype, **r)

    cut = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    holds = [hold_grads(torch, cut, init_params(cut, 0, device="cpu"),
                        train_batch(cut, np.random.default_rng(0), GRAD_B,
                                    GRAD_S), f"{TRAIN_ARCH} (2 layers)")]
    for arch in list_archs():
        if arch == TRAIN_ARCH:
            continue
        small = dataclasses.replace(get_smoke_config(arch),
                                    compute_dtype="float32")
        holds.append(hold_grads(
            torch, small, init_params(small, 0, device="cpu"),
            train_batch(small, np.random.default_rng(0), 2, 24), arch))
    resume = kill_and_resume(torch, dataclasses.replace(cfg, n_layers=2))
    log("train", sgd_first_step=sgd, grad_holds=holds,
        kill_and_resume=resume, phase_s=time.perf_counter() - t0)
    checks = dict(
        finite=all(np.isfinite(r["losses"]).all() for r in runs),
        memory=all(r["max_memory_allocated_gib"] < TRAIN_PEAK_GIB
                   for r in runs),
        sgd=sgd["ok"], grads=all(h["ok"] for h in holds),
        resume=resume["ok"])
    if not all(checks.values()):
        raise RuntimeError(f"train failed its checks: {checks}")


def stream_run(torch, params, mesh=None) -> dict:
    """One run of the ``stream`` configuration: granite-3-2b at full
    width with ``use_flash_attention=True`` behind ``StreamDriver`` (4
    Zipf(1.0) streams over the 20,000-object catalog, batches of up to
    256, prompts of 128 tokens): 2,048 cold requests,
    ``refresh_placement()``, 4,096 warm requests with a background
    refresh every 32 batches, ``drain_refresh()``. The launch counts are
    zeroed just before and read just after. With ``mesh`` the engine is
    sharded (``EngineConfig.sharded``) over it. Returns the engine, its
    config, the driver's cold and warm stats, the solve's prediction and
    times, the allocation installed by the refresh, the fused-lookup
    signatures, the launch counts and the phase's seconds."""
    from repro_torch import tracecount
    from repro_torch.configs.registry import get_config
    from repro_torch.core import catalog as catalog_api
    from repro_torch.core import demand as demand_api
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import (EngineConfig, SimCacheEngine,
                                   StreamDriver, StreamSpec)

    cfg = dataclasses.replace(get_config("granite-3-2b"),
                              use_flash_attention=True)
    cat = catalog_api.embedding_catalog(n=20_000, dim=100, seed=1)
    ecfg = EngineConfig(h_ici=15.0, h_dcn=150.0, h_model=1000.0,
                        sharded=mesh is not None)
    eng = SimCacheEngine(cfg, params, ecfg, cat.coords, mesh=mesh)
    streams = [StreamSpec(demand=demand_api.zipf(cat, alpha=1.0, seed=s + 1),
                          rate=1.0 + s, seed=s + 1, name=f"stream{s}")
               for s in range(4)]
    drv = StreamDriver(eng, streams, max_batch=256, batch_window=2.0,
                       prompt_len=128, refresh_every=0)
    overlap = []             # per served batch: a background solve running
    serve = eng.serve

    def serve_marked(*a, **kw):
        overlap.append(eng.refresh_in_flight)
        return serve(*a, **kw)
    eng.serve = serve_marked
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                        # the main path's run
    t0 = time.perf_counter()
    with tracecount.snapshot() as snap:
        cold = drv.run(2048)
        cold_stats, eng.stats = eng.stats, type(eng.stats)()
        t = time.perf_counter()
        pred = eng.refresh_placement()
        refresh_s = time.perf_counter() - t
        refreshed = np.asarray(eng.placement.slots).copy()
        drv.refresh_every = 32
        warm = drv.run(4096)
        t = time.perf_counter()
        drained = drv.drain_refresh()
        drain_s = time.perf_counter() - t
        signatures = snap.delta("fused_lookup")
    counts = launch_counts()                      # read just after
    return dict(eng=eng, drv=drv, cfg=cfg, cat=cat, ecfg=ecfg,
                streams=streams, overlap=overlap[-warm.n_batches:],
                cold=cold, cold_stats=cold_stats, pred=pred,
                refresh_s=refresh_s, refreshed=refreshed, warm=warm,
                drained=drained, drain_s=drain_s, signatures=signatures,
                counts=counts, phase_s=time.perf_counter() - t0)


def phase_stream(torch, params):
    """The engine with ``use_flash_attention=True`` behind the streaming
    driver, on the ``prefill`` phase's full-width weights
    (:func:`stream_run`). Returns its launch counts and the run."""
    from repro_torch.serve import bucket_size
    run = stream_run(torch, params)
    eng, cfg, cat, ecfg = run["eng"], run["cfg"], run["cat"], run["ecfg"]
    cold, cold_stats, warm = run["cold"], run["cold_stats"], run["warm"]
    counts, signatures = run["counts"], run["signatures"]
    refresh_every = 32
    w = eng.stats
    buckets = sorted({bucket_size(n, ecfg.min_bucket)
                      for n in warm.batch_sizes})
    res = dict(model=cfg.name, n_layers=cfg.n_layers, catalog=cat.n,
               dim=cat.dim, streams=len(run["streams"]), max_batch=256,
               batch_window=2.0, prompt_len=128,
               cold=dict(requests=cold.n_requests, batches=cold.n_batches,
                         req_per_s=cold.requests_per_s, p50_ms=cold.p50_ms,
                         p95_ms=cold.p95_ms, p99_ms=cold.p99_ms,
                         hit_rate=cold_stats.hit_rate,
                         mean_cost=cold_stats.mean_cost,
                         model_calls=cold_stats.model_calls),
               refresh_s=run["refresh_s"], predicted_cost=run["pred"],
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
               drain=dict(swapped=run["drained"], seconds=run["drain_s"]),
               swaps=eng.swap_count, fused_lookup_signatures=signatures,
               launches=counts, phase_s=run["phase_s"],
               max_memory_allocated_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30)
    log("stream", **res)
    checks = [counts["flash_attention"] > 0, counts["fused_lookup"] > 0,
              eng.swap_count >= 1, w.hit_rate > 0,
              w.mean_cost < ecfg.h_model, signatures <= len(buckets),
              warm.refreshes_started >= 1, not eng.refresh_in_flight]
    if not all(checks):
        raise RuntimeError(f"stream phase failed its checks: {checks}")
    return counts, run


SCENARIO_CATALOG = dict(n=20_000, dim=100, seed=1)   # the stream's
SCENARIO_BUDGET = 448                                # the engine's K
# requests a strategy, in batches of 256
SCENARIO_REQUESTS, SCENARIO_BATCH, SCENARIO_SEQ = 2048, 256, 128


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
    inputs, outside the counted run), then 2,048 requests in batches of
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


def phase_gain_quant(torch) -> dict:
    """The quantized GREEDY seeds (item 10) on the stream's catalog
    (20,000 objects, D 100) under its first stream's Zipf(1.0) demand and
    the engine's three-level hierarchy (64 / 128 / 256 slots, h 15 / 150
    / 1000): ``placement_gains(quantize=True)`` (``_lb_gains_tiles``, no
    kernel C) against kernel C's exact gains — never below them, less
    their C_a tolerance (``gain_tolerance``) and 1e-4 relative for the
    f32 sums — and ``device_greedy(quantize=True)`` bitwise the
    exact-seeded allocation; both timed, kernel C's launches counted.
    Returns the kernels line's entry and the exact GREEDY's slots and
    seconds."""
    from repro_torch.core import catalog as catalog_api
    from repro_torch.core import demand as demand_api
    from repro_torch.core import topology
    from repro_torch.core.objective import DeviceInstance, Instance
    from repro_torch.core.placement import device_greedy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    cat = catalog_api.embedding_catalog(n=20_000, dim=100, seed=1)
    dem = demand_api.zipf(cat, alpha=1.0, seed=1)
    net = topology.tpu_hierarchy(64, 128, 256, 15.0, 150.0, 1000.0)
    dinst = DeviceInstance.from_instance(Instance(net=net, cat=cat,
                                                  dem=dem),
                                         materialize_ca=False)
    cur = dinst.initial_costs()
    exact = dinst.gains(cur)
    quant = dinst.gains(cur, quantize=True)
    tol = gain_tolerance(torch, dinst.coords, dinst.lam).T \
        + 1e-4 * exact.abs()
    slack = quant - (exact - tol)
    admissible = bool((slack >= 0).all())
    times = dict(exact_ms=cuda_ms(torch, lambda: dinst.gains(cur), 3),
                 quantized_ms=cuda_ms(
                     torch, lambda: dinst.gains(cur, quantize=True), 3))
    greedy = {}
    for name, kw in (("exact", {}), ("quantized", dict(quantize=True))):
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        slots = device_greedy(dinst, **kw)
        greedy[name] = dict(slots=slots, seconds=time.perf_counter() - t,
                            launches=launch_counts()["placement_gains"])
    equal = bool(np.array_equal(greedy["exact"]["slots"],
                                greedy["quantized"]["slots"]))
    res = dict(catalog=cat.n, dim=cat.dim, demand="zipf1.0", caches=3,
               slots=int(net.total_slots), gains_admissible=admissible,
               least_slack=float(slack.min()),
               upper_bound_share=float((quant > exact + tol).float()
                                       .mean()),
               **times, greedy_equal=equal,
               greedy={k: dict(seconds=v["seconds"],
                               kernel_c_launches=v["launches"],
                               picks=int((v["slots"] >= 0).sum()))
                       for k, v in greedy.items()})
    log("gain_quant", **res)
    checks = [admissible, equal, greedy["quantized"]["launches"] == 0,
              greedy["exact"]["launches"] > 0]
    if not all(checks):
        raise RuntimeError(f"gain_quant phase failed its checks: {checks}")
    lb_gains = dict(name="_lb_gains_tiles",
                replaces="src/repro/kernels/knn/gains.py:170",
                shape=dict(R=cat.n, O=cat.n, D=cat.dim, I=1, J=3),
                ms=times["quantized_ms"],
                exact_path="placement_gains (C), R = O = 20,000",
                exact_ms=times["exact_ms"])
    # the exact GREEDY is the unsharded one of ``sharded_control``
    return lb_gains, greedy["exact"]


# the sharded phase: shard counts of the data plane on bigcache's network
SHARD_COUNTS = (2, 3, 8)
SHARD_COMPRESS, SHARD_GAINS, SHARD_SCENARIO, SHARD_ENGINE = 8, 4, 3, 4


def _same_result(torch, a, b) -> bool:
    """Two (cost, C_a, level, slot, payload) tuples equal, floats bit for
    bit."""
    bits = lambda t: (t.view(torch.int32)            # noqa: E731
                      if t.dtype == torch.float32 else t)
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def host_ops(torch, fn, iters: int, top: int = 8) -> dict:
    """Where the host's time of ``fn`` goes: torch.profiler's CPU ops
    over ``iters`` calls after one warm-up, the ``top`` by self time,
    each with its calls and self milliseconds per call of ``fn``, and
    the host's wall time per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        wall = (time.perf_counter() - t) / iters * 1e3
        torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return dict(wall_ms=wall, ops=[
        dict(name=e.key, calls=e.count / iters,
             self_ms=e.self_cpu_time_total / 1e3 / iters)
        for e in ops[:top]])


def phase_sharded_lookup(torch, big, plane) -> dict:
    """Item 11's data plane on one card: the key axis in n contiguous
    balanced shards, kernel A's shard-local entry (``fold_repo=False``)
    launched once per shard in turn, the minima reduced on the card.
    On ``bigcache``'s network (65,536 keys, 16 batches of 256) at n = 2,
    3 and 8, each run counted alone (launch counts zeroed just before,
    read just after): every batch bitwise the fused result, n launches
    of A a lookup; the sharded and the fused lookup of one batch timed
    side by side (CUDA events and the profiler's device time), and the
    host's ops of the n = 8 lookup by self time. Outside
    the counted runs, A on every chunk of the first batch at n = 8
    against its plain version with ``fold_repo=False`` (the first card
    runs of that entry), and two edge networks: 5 keys over 8 shards
    (3 chunks of padding, each returning (+INF, 0, −1, 0, −1)) and no
    keys (the repository, no launch). Then ``compress``'s 10⁶-key
    network (D 64, 64 queries) at n = 8: the exact sharded lookup and
    the four verified flag sets, each bitwise the exact fused result,
    with A's launches a lookup (n a scan plus n a re-scan), the
    re-scanned share and the per-shard table builds (host seconds)."""
    from repro_torch.core.simcache import CacheLevel, SimCacheNetwork
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.knn import KMeansPolicy
    from repro_torch.kernels.knn.knn import fused_lookup_cuda
    from repro_torch.kernels.knn.ops import _shard_chunks
    from repro_torch.launch.mesh import make_lookup_mesh
    net, queries, fused = big
    h_repo = net.h_repo
    t0 = time.perf_counter()
    runs, launches = {}, 0
    q0 = queries[0]
    for n in SHARD_COUNTS:
        snet = dataclasses.replace(net, sharded=True,
                                   mesh=make_lookup_mesh(n))
        snet.lookup(q0)                           # layout and warm-up
        torch.cuda.synchronize()
        reset_launch_counts()                     # this shard count's run
        got = [snet.lookup(q) for q in queries]
        torch.cuda.synchronize()
        counts = launch_counts()
        launches += counts["fused_lookup"]
        runs[n] = dict(
            bitwise_equal_fused=all(bitwise_equal(torch, a, b)
                                    for a, b in zip(got, fused)),
            fused_lookup_launches=counts["fused_lookup"],
            launches_expected=n * len(queries),
            chunk_keys=snet.sharded_layout(n)[0].shape[0] // n,
            ms=cuda_ms(torch, lambda: snet.lookup(q0), 20),
            device_ms=device_ms(torch, lambda: snet.lookup(q0), 20, "",
                                tries=5)["device_ms"],
            plan=_plan_fields(torch, q0.shape[0],
                              snet.sharded_layout(n)[0].shape[0] // n,
                              q0.shape[1]))
    fused_ms = cuda_ms(torch, lambda: net.lookup(q0), 20)
    fused_dev = device_ms(torch, lambda: net.lookup(q0), 20, "",
                          tries=5)["device_ms"]
    host = host_ops(torch, lambda: snet.lookup(q0), 20)   # n = 8

    # kernel A's shard-local entry on every chunk at n = 8
    held = []
    for k, h, m in _shard_chunks(*net.fused_layout(), 8):
        out = fused_lookup_cuda(q0, k, h, m, metric="l2", gamma=1.0,
                                h_repo=h_repo, repo_level=-1,
                                fold_repo=False)
        held.append(dict(hold_fused(torch, q0, k, h, m, h_repo, out,
                                    fold_repo=False), K=k.shape[0]))
    hold_ok = all(x["ok"] for x in held)

    # edge networks: chunks of padding only, and no keys at all
    small = SimCacheNetwork(levels=[CacheLevel(
        keys=net.levels[0].keys[:5].clone(),
        values=torch.arange(5, dtype=torch.int32, device="cuda"), h=0.0)],
        h_repo=h_repo)
    ssmall = dataclasses.replace(small, sharded=True,
                                 mesh=make_lookup_mesh(8))
    reset_launch_counts()
    edge = ssmall.lookup(q0)
    torch.cuda.synchronize()
    edge_launches = launch_counts()["fused_lookup"]
    pad_ok = True
    for k, h, m in _shard_chunks(*ssmall.sharded_layout(8), 8)[5:]:
        c, ca, lvl, slot, pay = fused_lookup_cuda(
            q0, k, h, m, h_repo=h_repo, repo_level=-1, fold_repo=False)
        pad_ok &= bool((c == 3.0e38).all() and (ca == 0).all()
                       and (lvl == -1).all() and (slot == 0).all()
                       and (pay == -1).all())
    empty = SimCacheNetwork(levels=[], h_repo=h_repo, sharded=True,
                            mesh=make_lookup_mesh(8))
    reset_launch_counts()
    repo = empty.lookup(q0)
    torch.cuda.synchronize()
    repo_launches = launch_counts()["fused_lookup"]
    edges = dict(
        five_keys_bitwise_fused=bitwise_equal(torch, edge,
                                              small.lookup(q0)),
        five_keys_launches=edge_launches, padding_chunks_ok=pad_ok,
        no_keys_repository=bool((repo.cost == h_repo).all()
                                and (repo.level == -1).all()),
        no_keys_launches=repo_launches)

    # compress's 10⁶ keys at n = 8
    cnet, cq, cexact = plane
    n = SHARD_COMPRESS
    snet = dataclasses.replace(cnet, sharded=True, mesh=make_lookup_mesh(n))
    snet.sharded_layout(n)
    builds = {}
    for name, fn in (("lsh_s", lambda: snet._tables_for(
                          cnet.candidate_policy, n)),
                     ("kmeans_s", lambda: snet._tables_for(KMeansPolicy(),
                                                           n)),
                     ("quant_rows_s", lambda: snet._quant_rows(n))):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        builds[name] = time.perf_counter() - t
    compress = {}
    for name, flags in (("exact", {}),) + COMPRESS_RUNS:
        c0, r0 = snet.rescan_calls, snet.rescan_queries
        reset_launch_counts()
        got = snet.lookup(cq, **flags)
        torch.cuda.synchronize()
        counts = launch_counts()
        launches += counts["fused_lookup"]
        rescans = snet.rescan_calls - c0
        compress[name] = dict(
            bitwise_equal_exact=bitwise_equal(torch, got, cexact),
            fused_lookup_launches=counts["fused_lookup"],
            launches_expected=n * (1 + rescans), rescan_calls=rescans,
            rescanned_share=(snet.rescan_queries - r0) / cq.shape[0],
            ms=cuda_ms(torch, lambda: snet.lookup(cq, **flags), 3))
    del snet
    res = dict(keys=sum(BIGCACHE_SLOTS), batches=len(queries),
               batch=q0.shape[0], runs=runs, fused_ms=fused_ms,
               fused_device_ms=fused_dev, host_ops_n8=host,
               shard_local_hold=dict(
                   n=8, ok=hold_ok, max_abs_err=max(
                       x["max_abs_err"] for x in held),
                   tol_max=max(x["tol_max"] for x in held),
                   index_near_tie=sum(x["index_near_tie"] for x in held)),
               edges=edges,
               compress=dict(keys=COMPRESS_KEYS, dim=COMPRESS_DIM,
                             queries=cq.shape[0], n_shards=n,
                             table_builds=builds, runs=compress),
               phase_s=time.perf_counter() - t0)
    log("sharded_lookup", **res)
    every = list(runs.values()) + list(compress.values())
    checks = [all(r["bitwise_equal_fused"] for r in runs.values()),
              all(r["bitwise_equal_exact"] for r in compress.values()),
              all(r["fused_lookup_launches"] == r["launches_expected"]
                  for r in every),
              hold_ok, edges["five_keys_bitwise_fused"],
              edges["five_keys_launches"] == 8, pad_ok,
              edges["no_keys_repository"], edges["no_keys_launches"] == 0]
    if not all(checks):
        raise RuntimeError(f"sharded_lookup phase failed its checks: "
                           f"{checks}")
    return dict(launches=launches, hold=res["shard_local_hold"])


def phase_sharded_control(torch, cat, dem, greedy_exact) -> dict:
    """Item 11's control plane on one card, each call's launches counted
    alone: the candidate-sharded gain oracle (kernel C once per shard and
    group of 8 caches) at the stream's catalog (R = O = 20,000, D 100,
    the engine's hierarchy, J 3) at n = 4, and on the ``scenario`` net (I
    4, J 37, 5 groups) at n = 3, each bitwise the unsharded columns; GREEDY
    on a 4-shard streaming ``DeviceInstance`` bitwise the unsharded
    allocation; the best-two tables at 10⁵ objects and K 448 at n = 4,
    and a ``best_two_delta`` forced into its (sharded) full rebuild,
    bitwise; the sharded and unsharded calls timed side by side. The
    unsharded GREEDY is ``gain_quant``'s exact run on the same instance
    (``greedy_exact``: its slots and seconds)."""
    from repro_torch.core import catalog as catalog_api
    from repro_torch.core import demand as demand_api
    from repro_torch.core import scenarios, topology
    from repro_torch.core.catalog import Catalog
    from repro_torch.core.objective import DeviceInstance, Instance
    from repro_torch.core.placement import device_greedy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_lookup_mesh
    t0 = time.perf_counter()
    hier = topology.tpu_hierarchy(64, 128, 256, 15.0, 150.0, 1000.0)
    scat = catalog_api.embedding_catalog(n=20_000, dim=100, seed=1)
    sinst = Instance(net=hier, cat=scat,
                     dem=demand_api.zipf(scat, alpha=1.0, seed=1))
    sc = scenarios.scenario("isp", cache_budget=SCENARIO_BUDGET,
                            placement="degree", n_ingress=4, seed=0)
    coords, _, cat0 = rescaled_catalog(sc.net, **SCENARIO_CATALOG)
    scen = Instance(net=sc.net, cat=Catalog(coords=coords, metric="l2",
                                            gamma=1.0),
                    dem=demand_api.zipf(cat0, alpha=1.0,
                                        n_ingress=sc.net.n_ingress, seed=1))
    launches, gains = 0, {}
    for name, inst, n in (("stream", sinst, SHARD_GAINS),
                          ("scenario", scen, SHARD_SCENARIO)):
        d = DeviceInstance.from_instance(inst, materialize_ca=False)
        ds = DeviceInstance.from_instance(inst, mesh=make_lookup_mesh(n),
                                          axes=("data",),
                                          materialize_ca=False)
        cur = d.initial_costs()
        want = d.gains(cur)
        torch.cuda.synchronize()
        reset_launch_counts()                     # the sharded call
        got = ds.gains(cur)
        torch.cuda.synchronize()
        c = launch_counts()["placement_gains"]
        launches += c
        J = inst.net.n_caches
        gains[name] = dict(
            R=inst.cat.n, D=inst.cat.dim, I=inst.net.n_ingress, J=J,
            n_shards=n, launches=c, launches_expected=n * -(-J // 8),
            bitwise_equal=bool(torch.equal(got.view(torch.int32),
                                           want.view(torch.int32))),
            ms=cuda_ms(torch, lambda: ds.gains(cur), 3),
            unsharded_ms=cuda_ms(torch, lambda: d.gains(cur), 3))
        if name == "stream":
            reset_launch_counts()                 # GREEDY, sharded
            t = time.perf_counter()
            slots_s = device_greedy(ds)
            greedy_s = time.perf_counter() - t
            greedy_c = launch_counts()["placement_gains"]
            launches += greedy_c
            slots_u = greedy_exact["slots"]
            greedy_u = greedy_exact["seconds"]
            greedy = dict(bitwise_equal=bool(np.array_equal(slots_s,
                                                            slots_u)),
                          seconds=greedy_s, unsharded_seconds=greedy_u,
                          kernel_c_launches=greedy_c)
        del d, ds, cur, want, got

    # the best-two tables at 10⁵ objects, K 448
    inst = Instance(net=hier, cat=cat, dem=dem)
    kw = dict(materialize_ca=False)
    d = DeviceInstance.from_instance(inst, **kw)
    ds = DeviceInstance.from_instance(inst, mesh=make_lookup_mesh(
        SHARD_GAINS), axes=("data",), **kw)
    rng = np.random.default_rng(11)
    slots = rng.choice(cat.n, hier.total_slots, replace=False)
    want = d.best_two_tables(slots)
    got = ds.best_two_tables(slots)
    tables_equal = _same_result(torch, got, want)
    new = slots.copy()
    ys = np.sort(rng.choice(hier.total_slots, 64, replace=False))
    new[ys] = rng.choice(cat.n, 64)
    rebuilt = ds.best_two_delta(*got, new, ys, cap=1)
    delta_equal = _same_result(torch, rebuilt, d.best_two_tables(new))
    tables = dict(objects=cat.n, slots=hier.total_slots,
                  n_shards=SHARD_GAINS, bitwise_equal=tables_equal,
                  delta_rebuild_bitwise_equal=delta_equal,
                  ms=cuda_ms(torch, lambda: ds.best_two_tables(slots), 5),
                  unsharded_ms=cuda_ms(
                      torch, lambda: d.best_two_tables(slots), 5))
    res = dict(gains=gains, greedy=greedy, tables=tables,
               phase_s=time.perf_counter() - t0)
    log("sharded_control", **res)
    checks = [all(g["bitwise_equal"] and g["launches"]
                  == g["launches_expected"] for g in gains.values()),
              greedy["bitwise_equal"],
              greedy["kernel_c_launches"] == SHARD_GAINS,
              tables_equal, delta_equal]
    if not all(checks):
        raise RuntimeError(f"sharded_control phase failed its checks: "
                           f"{checks}")
    return dict(launches=launches)


def tail_split(run) -> dict:
    """The warm run's batch latencies split by whether the background
    solve was running when the batch was served, with the ten slowest
    overlapped batches; then a quiet rerun of 4,096 requests on the same
    engine with no refresh started (after every stat of the phase was
    read). It says what the warm tail overlaps."""
    lat = np.asarray(run["warm"].batch_latencies_ms)
    over = np.asarray(run["overlap"], bool)

    def pct(x):
        return dict(batches=int(x.size),
                    p50_ms=float(np.percentile(x, 50)) if x.size else None,
                    p95_ms=float(np.percentile(x, 95)) if x.size else None)
    drv = run["drv"]
    drv.refresh_every = 0
    quiet = drv.run(4096)
    return dict(overlapped=pct(lat[over]), alone=pct(lat[~over]),
                slowest_overlapped_ms=sorted(lat[over].tolist())[-10:],
                quiet=dict(batches=quiet.n_batches, p50_ms=quiet.p50_ms,
                           p95_ms=quiet.p95_ms, p99_ms=quiet.p99_ms,
                           refreshes_started=quiet.refreshes_started))


def phase_sharded_engine(torch, params, stream) -> dict:
    """The ``stream`` configuration (:func:`stream_run`) with
    ``EngineConfig.sharded`` on a 4-shard lookup mesh, on the same
    weights: the allocation the refresh installs and the one left after
    the drain bitwise the ``stream`` phase's, warm hit rate and mean cost
    equal to it, kernel A launched n times a served lookup and kernel C n
    times a synchronous GREEDY seed (the background refresh solves
    unsharded, as the reference's does: once a seed); batch percentiles
    beside the ``stream`` phase's, the cost of the shard loop on one
    card."""
    from repro_torch.launch.mesh import make_lookup_mesh
    n = SHARD_ENGINE
    run = stream_run(torch, params, mesh=make_lookup_mesh(n))
    eng, warm, counts = run["eng"], run["warm"], run["counts"]
    ref, w, w0 = stream["eng"], eng.stats, stream["eng"].stats
    lookups = warm.n_batches                      # one a warm batch
    res = dict(
        n_shards=n, sharded=eng.simcache.sharded,
        refreshed_slots_equal=bool(np.array_equal(run["refreshed"],
                                                  stream["refreshed"])),
        final_slots_equal=bool(np.array_equal(eng.placement.slots,
                                              ref.placement.slots)),
        predicted_cost=run["pred"], stream_predicted_cost=stream["pred"],
        warm=dict(hit_rate=w.hit_rate, mean_cost=w.mean_cost,
                  p50_ms=warm.p50_ms, p95_ms=warm.p95_ms,
                  req_per_s=warm.requests_per_s, batches=warm.n_batches,
                  refreshes_started=warm.refreshes_started,
                  swaps_in_run=warm.swaps),
        stream_warm=dict(hit_rate=w0.hit_rate, mean_cost=w0.mean_cost,
                         p50_ms=stream["warm"].p50_ms,
                         p95_ms=stream["warm"].p95_ms,
                         batches=stream["warm"].n_batches),
        cold_p50_ms=run["cold"].p50_ms,
        stream_cold_p50_ms=stream["cold"].p50_ms,
        refresh_s=run["refresh_s"], drain_s=run["drain_s"],
        launches=counts, fused_lookup_expected=n * lookups,
        placement_gains_expected=n + warm.refreshes_started,
        phase_s=run["phase_s"])
    checks = [res["sharded"], res["refreshed_slots_equal"],
              res["final_slots_equal"], w.hit_rate == w0.hit_rate,
              w.mean_cost == w0.mean_cost,
              counts["fused_lookup"] == n * lookups,
              counts["placement_gains"] == n + warm.refreshes_started,
              counts["flash_attention"] > 0, not eng.refresh_in_flight]
    res["tail"] = {name: tail_split(r) for name, r in
                   (("sharded", run), ("stream", stream))}
    log("sharded_engine", **res)
    if not all(checks):
        raise RuntimeError(f"sharded_engine phase failed its checks: "
                           f"{checks}")
    return counts


HITRATE_REQUESTS = 40_000
SURROGATE_OBJECTS = (100_000, 1_000_000)
# timed surrogate calls a size: one takes ~3 s at 10⁶ objects on an
# H100, and two show the cost repeats bitwise
SURROGATE_CALLS = 2


def surrogate_breakdown(torch, net, lam) -> dict:
    """Where one ``surrogate_cost`` call spends its time: a call under
    torch.profiler (the device's kernel and copy time, launches, and the
    idle share of the call's wall time), then a call with the solve and
    the pass each timed to the end of their device work (the rest is
    the host's f64 composition). The caller's timed calls warmed it
    up."""
    import collections
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.analysis import hitrate, surrogate_cost
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
    catalog rescaled as the reference bench rescales it, exact balls for
    SIM-LRU and RND-LRU, the fixed point of each against a
    ``StrategyPlane``
    replay of 40,000 Zipf(0.9) requests measured as the bench measures
    it (the warm half); then the engine surrogate's time a call on the
    engine's three-level hierarchy at 10⁵ and 10⁶ objects with exact-hit
    balls. The balls are also held against the CPU's on a 2,000-object
    slice of the catalog. Then the reference bench's 10⁶-object path
    (:func:`hitrate_full_scale`)."""
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
    full, cand_ca = hitrate_full_scale(torch, net)
    res = dict(net=net.name, caches=net.n_caches, slots=net.total_slots,
               ingress=net.n_ingress, catalog=len(coords),
               dim=coords.shape[1], cut_from=1_000_000, theta=theta,
               demand="zipf0.9", requests=HITRATE_REQUESTS,
               strategies=rows, balls_hold=balls_hold, surrogate=surrogate,
               full_1e6_lsh=full)
    log("hitrate", **res)
    checks = [all(r["finite"] and 0.0 < r["predicted_hit_rate"] < 1.0
                  for r in rows.values()),
              all(r["mean_ball"] > 1.0 for r in rows.values()),
              balls_hold["idx_equal"], balls_hold["q_equal"],
              balls_hold["dist_max_rel"] <= 2.0 ** -23,
              all(s["repeats_bitwise"] for s in surrogate.values()),
              full["check"], full["lsh_within_exact"]["ok"],
              full["lsh_card_vs_cpu"]["ok"]]
    if not all(checks):
        raise RuntimeError(f"hitrate phase failed its checks: {checks}")
    return cand_ca


NEAR_THETA = 1e-5     # a pair within this of θ (relative) may flip


def _ca64(coords, o, members):
    diff = coords[members].astype(np.float64) - coords[o].astype(np.float64)
    return np.sqrt((diff ** 2).sum(-1))


def lsh_balls_hold(b, ref, coords) -> dict:
    """LSH balls ``b`` against ``ref`` (the same enumeration elsewhere):
    every row's members equal, except on rows holding a pair within
    ``NEAR_THETA``·θ of θ, where the member sets may differ by such
    pairs alone; distances to 1e-5 relative on the equal rows."""
    n, theta = b.n_objects, b.theta
    near, bad = [], []
    for o in np.nonzero((b.idx != ref.idx).any(axis=1))[0]:
        mi, mj = b.idx[o][b.idx[o] < n], ref.idx[o][ref.idx[o] < n]
        diff = np.setxor1d(mi, mj)
        band = np.abs(_ca64(coords, o, diff) - theta) <= NEAR_THETA * theta
        (near if diff.size and band.all() else bad).append(int(o))
    rows = np.setdiff1d(np.arange(n), near + bad)
    rel = float(np.max(np.abs(b.dist[rows] - ref.dist[rows])
                       / np.maximum(ref.dist[rows], 1e-30), initial=0.0))
    return dict(objects=n, near_theta_rows=near, bad_rows=bad[:10],
                dist_max_rel=rel, ok=not bad and rel <= 1e-5)


def hitrate_full_scale(torch, net) -> tuple[dict, dict]:
    """The reference bench's 10⁶-object path (``bench_full_scale``):
    ``embedding_catalog(n=10⁶, dim=8, seed=0)`` rescaled by its rule,
    Zipf(0.9), ``similarity_balls(mode="lsh", seed=0, max_ball=64)`` —
    its time split into the table build (host), the candidates, exact
    filter and packing on the card, and the host's share, and the balls'
    sizes before the cut to ``max_ball`` — then
    ``predict_hitrates(n_sweeps=8)``; the bench's check; LSH ⊆ exact on a
    20,000-object slice (every member within θ, self present); and the
    card's LSH balls against the CPU's on a 2,000-object slice."""
    from repro_torch.core import demand as demand_api
    from repro_torch.core.analysis import (hitrate, predict_hitrates,
                                           similarity_balls)
    from repro_torch.kernels.knn import lsh
    coords, theta, cat0 = rescaled_catalog(net, n=1_000_000, dim=8, seed=0)
    dem = demand_api.zipf(cat0, alpha=0.9, n_ingress=net.n_ingress, seed=7)
    parts = [("build_s", lsh.SimHashPolicy, "build"),
             ("card_s", lsh, "candidate_matrix"),
             ("card_s", hitrate, "_lsh_block"),
             ("cand_ca_s", hitrate, "_cand_ca")]   # inside _lsh_block

    def first_args(a, kw, out):            # one block's real inputs
        return None if cap.calls["cand_ca"] else a
    torch.cuda.synchronize()
    t = time.perf_counter()
    with timed_parts(torch, parts) as split, captured(
            [("sizes", hitrate, "_lsh_block", lambda a, kw, out: out[2]),
             ("cand_ca", hitrate, "_cand_ca", first_args)]) as cap:
        balls = similarity_balls(coords, theta, mode="lsh", seed=0,
                                 max_ball=64)
    balls_s = time.perf_counter() - t
    split = {k: v / 1e3 for k, v in split.ms.items()}
    split["host_s"] = balls_s - split["build_s"] - split["card_s"]
    n_blocks = -(-len(coords) // 1024)
    # each ball's size before the cut to max_ball
    sz = torch.cat(cap.calls["sizes"]).double()
    members = float(sz.sum())
    before_cap = dict(
        mean=members / sz.numel(), max=float(sz.max()),
        **{f"p{p}": float(torch.quantile(sz, p / 100))
           for p in (50, 90, 99)},
        share_of_objects_over_cap=float((sz > 64).double().mean()),
        members=members, truncated_share=int(balls.truncated) / members)
    t = time.perf_counter()
    pred = predict_hitrates(net, dem.lam, balls, n_sweeps=8)
    solve_s = time.perf_counter() - t
    row = dict(objects=len(coords), dim=coords.shape[1], theta=theta,
               mean_ball=balls.mean_size, truncated=int(balls.truncated),
               ball_sizes_before_cap=before_cap, balls_s=balls_s, balls_split=split, solve_s=solve_s,
               predicted_hit_rate=pred.hit_rate,
               predicted_mean_cost=pred.mean_cost, residual=pred.residual,
               check=bool(np.isfinite(pred.hit_rate)
                          and 0.0 <= pred.hit_rate <= 1.0
                          and balls.mean_size >= 1.0))
    del balls, pred
    # LSH within the exact balls on a 20,000-object slice
    part = coords[:20_000]
    lb = similarity_balls(part, theta, mode="lsh", seed=0)
    eb = similarity_balls(part, theta, mode="exact")
    n, bad, outside = part.shape[0], 0, 0
    for o in range(n):
        li = lb.idx[o][lb.idx[o] < n]
        extra = np.setdiff1d(li, eb.idx[o][eb.idx[o] < n])
        if extra.size and not np.all(np.abs(_ca64(part, o, extra) - theta)
                                     <= NEAR_THETA * theta):
            bad += 1
        outside += int(extra.size)
        bad += int(li[0] != o)
    row["lsh_within_exact"] = dict(
        objects=n, lsh_mean_ball=lb.mean_size, exact_mean_ball=eb.mean_size,
        members_past_theta_within_band=outside, bad_rows=bad,
        max_dist_over_theta=float(lb.dist.max() / theta), ok=bad == 0
        and float(lb.dist.max()) <= theta * (1 + NEAR_THETA))
    small = coords[:2000]
    row["lsh_card_vs_cpu"] = lsh_balls_hold(
        similarity_balls(small, theta, mode="lsh", seed=0),
        similarity_balls(small, theta, mode="lsh", seed=0, device="cpu"),
        small)
    # _cand_ca on the 10⁶ enumeration's first block, beside the exact
    # enumeration's f64 block over the whole catalog
    qs, cs, metric, gamma = cap.calls["cand_ca"][0]
    cand_ms = cuda_ms(torch, lambda: hitrate._cand_ca(qs, cs, metric, gamma),
                      5)
    c64 = torch.as_tensor(coords, device="cuda").double()
    exact_ms = cuda_ms(torch, lambda: hitrate._block_ca(c64[:1024], c64,
                                                        "l2", 1.0), 3)
    del c64
    return row, dict(name="_cand_ca",
                     replaces="src/repro/core/analysis/hitrate.py:203",
                     shape=dict(B=cs.shape[0], P=cs.shape[1], D=cs.shape[2]),
                     ms=cand_ms,
                     host_ms_per_block=split["cand_ca_s"] * 1e3 / n_blocks,
                     exact_path="_block_ca (f64), 1,024 × 10⁶",
                     exact_ms=exact_ms)


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
    counted over the phase. Its solves are GREEDY alone: what the phase
    holds is the gate, and the ``stream`` phase runs the cascade on the
    same catalog."""
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
                        refresh_min_gain=GATE_MIN_GAIN, algo="greedy")
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


MESH_B, MESH_S = 2, 512            # (a): the train policy's loss
MESH_DECODE_STEPS = 8              # (c)
MESH_LOSS_RTOL = 1e-5   # (a): f32, the repeated heads' grouped products


def mesh_loss_hold(torch, cfg, params) -> dict:
    """(a) The train-mode loss under the production train policy (heads
    tensor parallelism, the KV heads repeated up to the model axis's 16)
    against NO_SHARD's, f32 compute, B 2, S 512: the same attention with
    the grouped products in other shapes, so within ``MESH_LOSS_RTOL``."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import MeshShardPolicy
    from repro_torch.models.model import loss_fn
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    policy = MeshShardPolicy.create(f32, make_production_mesh(), "train")
    rng = np.random.default_rng(5)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (MESH_B, MESH_S)),
                                device="cuda") for k in ("tokens", "labels")}
    with torch.no_grad():
        loss, _ = loss_fn(f32, params, batch, policy)
        plain, _ = loss_fn(f32, params, batch)
    rel = abs(float(loss) - float(plain)) / abs(float(plain))
    return dict(policy=policy.attn_strategy, kv_repeat=policy.kv_repeat,
                loss=float(loss), no_shard_loss=float(plain), rel_err=rel,
                tol=MESH_LOSS_RTOL, bitwise=bool(torch.equal(loss, plain)),
                ok=policy.kv_repeat == 2 and rel <= MESH_LOSS_RTOL)


def mesh_prefill(torch, cfg, params, clock_hz: float) -> dict:
    """(b) A flash prefill (bf16, B 2, S 2048) under the production
    prefill policy: kernel E sees H 32 / KH 16 (the KV heads repeated),
    one launch a layer, counted; E held against ``flash_ref`` and
    ``flash_blocked`` at that shape (layer 0's Q/K/V) and timed beside
    SDPA and its bound; the logits against NO_SHARD's flash prefill on
    the same tokens within what bf16 moves the plain prefill from f32
    (``prefill``'s rule)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import MeshShardPolicy
    from repro_torch.models.model import make_prefill
    flash = dataclasses.replace(cfg, use_flash_attention=True)
    policy = MeshShardPolicy.create(flash, make_production_mesh(), "prefill")
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 2048)), device="cuda")
    with kept_flash_inputs() as kept:
        reset_launch_counts()
        got, _ = make_prefill(flash, policy)(params, {"tokens": toks})
        torch.cuda.synchronize()
        launches = launch_counts()["flash_attention"]
    q, k, v = kept[True]
    hold = hold_kernel_e(torch, q, k, v, clock_hz)
    del q, k, v, kept
    base, _ = make_prefill(flash)(params, {"tokens": toks})
    plain, _ = make_prefill(cfg)(params, {"tokens": toks})
    f32, _ = make_prefill(dataclasses.replace(cfg, compute_dtype="float32"))(
        params, {"tokens": toks})
    diff, top1 = _logit_diff(torch, got, base)
    noise, _ = _logit_diff(torch, plain, f32)
    bitwise = bool(torch.equal(got, base))
    del base, plain, f32
    return dict(policy=policy.attn_strategy, kv_repeat=policy.kv_repeat,
                launches=launches, max_abs_logit_diff=diff,
                top1_agreement=top1, tol=noise, bitwise=bitwise,
                e_hold=hold,
                ok=(launches == cfg.n_layers and hold["KH"] == 16
                    and hold["H"] == 32 and diff <= noise
                    and bool(torch.isfinite(got.float()).all())))


def mesh_decode(torch, cfg, params) -> dict:
    """(c) ``MESH_DECODE_STEPS`` serve steps (bf16, B 2, a 256-token
    prompt) under the decode policy ("kv_seq": on one process every
    constraint is the identity) against NO_SHARD's on a copy of the same
    padded cache, fed the same tokens: every step's logits bitwise."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import MeshShardPolicy
    from repro_torch.models.model import (_pad_caches, make_prefill,
                                          make_serve_step)
    policy = MeshShardPolicy.create(cfg, make_production_mesh(), "decode")
    B, S, n = 2, 256, MESH_DECODE_STEPS
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (B, S + n)), device="cuda")
    _, caches = make_prefill(cfg)(params, {"tokens": toks[:, :S]})
    with torch.inference_mode():
        caches = _pad_caches(cfg, caches, S + n)
        other = [{k: t.clone() for k, t in c.items()} for c in caches]
    sharded, plain = make_serve_step(cfg, policy), make_serve_step(cfg)
    equal = []
    for t in range(n):
        tok = toks[:, S + t:S + t + 1]
        a, caches = sharded(params, tok, caches, S + t)
        b, other = plain(params, tok, other, S + t)
        equal.append(bool(torch.equal(a, b)))
    del caches, other
    return dict(policy=policy.attn_strategy, kv_repeat=policy.kv_repeat,
                steps=n, bitwise_steps=sum(equal), ok=all(equal))


def mesh_bytes(torch, cfg, params) -> dict:
    """(d) The dry run of the ``train`` phase's own cell (granite, B 4,
    S 512, f32 moments, a 1 × 1 mesh): its per-device argument bytes
    against the bytes of the state the trainer builds on the card (the
    engine's weights are ``init_params(cfg, 0)``'s, as the trainer's;
    ``adamw_init``'s moments and step; the first batch as the trainer
    puts it on the card), part for part; and the dry run's seconds by
    pass (memory, FLOPs on the meta device; on one device there is no
    collective to count)."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ShardMesh
    from repro_torch.launch.specs import ShapeCell
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.trainer import _device_batch
    opt = AdamWConfig(moment_dtype="float32")
    m = dryrun.measure_cell(cfg, ShapeCell("train_phase", TRAIN_S, TRAIN_B,
                                           "train"),
                            ShardMesh(("data", "model"), (1, 1)), opt,
                            collectives=False)

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()
    named = dict(params.named_parameters())
    state = adamw_init(named, opt)
    batch = _device_batch(SyntheticLMData(
        vocab=cfg.vocab, batch=TRAIN_B, seq=TRAIN_S).batch_at(0),
        torch.device("cuda"))
    card = dict(params=nbytes(named), opt_state=nbytes(state),
                batch=nbytes(batch))
    card["argument_size_in_bytes"] = sum(card.values())
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(dryrun=m["memory_analysis"], card=card,
                flops_counted=m["flops_counted"],
                dryrun_seconds=m["seconds"],
                ok=m["memory_analysis"] == card
                and m["flops_counted"] is not None)


def mesh_crosspod(torch, params) -> dict:
    """(e) ``compressed_crosspod_mean`` on a 1-rank NCCL group (a (1, 1)
    device mesh on ("pod", "data"), 60 s timeout) over three of the
    weights' leaves taken as gradients (the embedding, layer 0's wq and
    w_down): bitwise dequantize ∘ quantize of each (the mean over one rank
    and one pod is the identity)."""
    import datetime
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.ft import (compressed_crosspod_mean, dequantize_int8,
                                quantize_int8)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("pod", "data"))
        grads = {"embed": params.embed, "blocks": {
            "wq": params.blocks[0].wq, "w_down": params.blocks[0].w_down}}
        out = compressed_crosspod_mean(grads, mesh)
        want = {k: dequantize_int8(*quantize_int8(v)) for k, v in
                (("embed", grads["embed"]), ("wq", grads["blocks"]["wq"]),
                 ("w_down", grads["blocks"]["w_down"]))}
        got = {"embed": out["embed"], **out["blocks"]}
        torch.cuda.synchronize()
        equal = {k: bool(torch.equal(got[k], want[k])) for k in want}
    finally:
        dist.destroy_process_group()
    return dict(backend="nccl", world_size=1, leaves=equal,
                seconds=time.perf_counter() - t, ok=all(equal.values()))


def mesh_remesh(torch) -> dict:
    """(f) granite's smoke weights (seed 0) checkpointed, then restored
    onto the (4, 2), (2, 4) and (8, 1) meshes (``plan_mesh``,
    ``reshard_plan``), one ``restore_for_mesh`` a device: every leaf's
    blocks reassemble it bitwise, and the train-mode loss of the
    reassembled weights equals the saved model's bitwise."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import restore_for_mesh, save
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.ft import plan_mesh, reshard_plan
    from repro_torch.launch.sharding import shard_slices
    from repro_torch.models import convert
    from repro_torch.models.model import init_params, loss_fn
    cfg = get_smoke_config("granite-3-2b")
    model = init_params(cfg, 0)
    tree = convert.to_jax_params(cfg, model)
    rng = np.random.default_rng(8)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (8, 16)),
                                device="cuda") for k in ("tokens", "labels")}
    with torch.no_grad():
        want, _ = loss_fn(cfg, model, batch)

    def leaves(t, prefix=()):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_remesh_")
    rows = []
    try:
        save(ckpt, 1, {"params": tree})
        for shape in ((4, 2), (2, 4), (8, 1)):
            mesh = plan_mesh(shape[0] * shape[1], model_parallelism=shape[1])
            specs = reshard_plan(cfg, mesh)
            full = {p: torch.zeros(v.shape, dtype=getattr(
                torch, str(v.dtype)), device="cuda")
                for p, v in leaves(tree)}
            spec_of = dict(leaves(specs))
            for d in range(shape[0]):
                for m in range(shape[1]):
                    coords = {"data": d, "model": m}
                    _, state = restore_for_mesh(ckpt, {"params": specs},
                                                mesh, coords)
                    for p, block in leaves(state["params"]):
                        full[p][shard_slices(tuple(full[p].shape),
                                             spec_of[p], mesh,
                                             coords)] = block
            same = all(torch.equal(full[p], torch.as_tensor(v).cuda())
                       for p, v in leaves(tree))
            rebuilt = {}
            for p, v in full.items():
                node = rebuilt
                for key in p[:-1]:
                    node = node.setdefault(key, {})
                node[p[-1]] = v
            with torch.no_grad():
                loss, _ = loss_fn(cfg, convert.from_jax_params(
                    cfg, rebuilt, device="cuda"), batch)
            rows.append(dict(mesh=list(shape), leaves_bitwise=same,
                             loss=float(loss),
                             loss_bitwise=bool(torch.equal(loss, want))))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return dict(saved_loss=float(want), meshes=rows,
                ok=all(r["leaves_bitwise"] and r["loss_bitwise"]
                       for r in rows))


def phase_mesh(torch, params, clock_hz: float) -> dict:
    """The mesh layer (item 14d) on the engine's granite-3-2b weights (full
    width, no new model): (a) :func:`mesh_loss_hold`, (b)
    :func:`mesh_prefill` (kernel E at H 32 / KH 16), (c)
    :func:`mesh_decode`, (d) :func:`mesh_bytes`, (e)
    :func:`mesh_crosspod`, (f) :func:`mesh_remesh`. Returns E's launches
    and hold for the kernels line."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("granite-3-2b")
    t0 = time.perf_counter()
    parts = {}
    for name, fn in (("loss", lambda: mesh_loss_hold(torch, cfg, params)),
                     ("prefill", lambda: mesh_prefill(torch, cfg, params,
                                                      clock_hz)),
                     ("decode", lambda: mesh_decode(torch, cfg, params)),
                     ("bytes", lambda: mesh_bytes(torch, cfg, params)),
                     ("crosspod", lambda: mesh_crosspod(torch, params)),
                     ("remesh", lambda: mesh_remesh(torch))):
        t = time.perf_counter()
        parts[name] = fn()
        parts[name]["seconds"] = time.perf_counter() - t
    log("mesh", **parts, phase_s=time.perf_counter() - t0)
    checks = {k: v["ok"] for k, v in parts.items()}
    if not all(checks.values()):
        raise RuntimeError(f"mesh failed its checks: {checks}")
    return dict(flash_attention=parts["prefill"]["launches"],
                e_hold=parts["prefill"]["e_hold"])


# the kernels each example's path must launch (netduel_online's GREEDY
# yardstick folds its 900-object instance's materialized C_a in torch,
# as the reference does, so C is not on its path; train_lm launches
# none: E has no backward, so its model runs plain attention)
EXAMPLE_KERNELS = {
    "netduel_online": ("duel_scan", "duel_rearm"),
    "serve_simcache": ("fused_lookup", "placement_gains"),
    "streaming_serve": ("fused_lookup", "placement_gains", "duel_scan"),
    "train_lm": ()}


def load_example(name: str):
    """An example twin (``examples/<name>_torch.py``) loaded from its
    file."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(train_steps: int = 30) -> dict:
    """The examples' twins (item 17) in this process on the card, as a
    user runs them, each at its reference example's sizes: netduel_online
    (two 40,000-request ``device_netduel`` windows through F, the host
    NumPy replay asserted equal by the example itself), serve_simcache
    (the ~5M-parameter granite behind ``SimCacheEngine``: ``calibrate()``,
    8 cold and 8 warm batches of 16, the cascade through C, warm lookups
    through A), streaming_serve (4 streams, NETDUEL on F,
    ``refresh_on_promotion``, two 600-request phases and the drift) and
    train_lm at ``train_steps`` steps (the ~100M granite-family model, a
    crash at two thirds and a resume). Each run's launch counts are
    zeroed just before it and read just after; every kernel of
    ``EXAMPLE_KERNELS`` must have launched.

    Holds of the kernels, after each run and outside its counts: in
    serve_simcache and streaming_serve every call of A (its inputs and
    outputs captured, cloned) against its plain version
    (:func:`hold_captured_a`) and every exact call of C against its own
    (:func:`hold_captured_c`), as many calls held as launches counted;
    in streaming_serve every duel plane the engine armed replayed on the
    plain scan and on F, bitwise, each re-arm held against the torch
    re-arm (:func:`hold_duel_planes`), as many scans and re-arms replayed
    as launched; in netduel_online the host replay (the example raises
    otherwise). Holds of what the examples promise: the adaptation
    (C(A_new | λ2) below C(A_old | λ2)); the warm hit rate above 0 and
    the mean cost below ``h_model``, 128 requests a phase, 8 cold model
    calls; 600 / 15 requests and batches in each streaming phase (the
    reference example's counts), a background swap, no refresh in flight,
    hits after the drift; finite losses, and a resume from the step of
    the crash's checkpoint to the last step. Each example's printout is
    kept in the phase's line."""
    import contextlib
    import io
    import tempfile

    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    t0 = time.perf_counter()
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
    keep_a = lambda a, kw, out: (cloned(torch, a), dict(kw),  # noqa: E731
                                 cloned(torch, out))
    runs, checks = {}, {}
    for name, call in (
            ("netduel_online", lambda m: m.run()),
            ("serve_simcache", lambda m: m.run()),
            ("streaming_serve", lambda m: m.run()),
            ("train_lm", lambda m: m.run(steps=train_steps, ckpt=ckpt))):
        mod = load_example(name)
        text = io.StringIO()
        with contextlib.ExitStack() as stack:
            cap = recorder = None
            if name in ("serve_simcache", "streaming_serve"):
                cap = stack.enter_context(
                    captured(a_targets(keep_a) + c_targets(torch)))
            if name == "streaming_serve":
                recorder = stack.enter_context(duel_recorder())
            stack.enter_context(contextlib.redirect_stdout(text))
            reset_launch_counts()
            t = time.perf_counter()
            out = call(mod)
            torch.cuda.synchronize()
            counts = launch_counts()
            seconds = time.perf_counter() - t
        launched = {k: counts[k] for k in ("fused_lookup", "placement_gains",
                                           "duel_scan", "duel_rearm")}
        held, kernels_held = [], {}
        if cap is not None:
            a_held = hold_captured_a(torch, cap.calls)
            c_held = hold_captured_c(torch, cap.calls)
            kernels_held.update(
                A=dict(calls=len(a_held),
                       shapes=sorted({(h["Q"], h["K"], h["D"])
                                      for h in a_held}),
                       max_abs_err=max((h["max_abs_err"] for h in a_held),
                                       default=None),
                       index_near_tie=sum(h["index_near_tie"]
                                          for h in a_held),
                       ok=all(h["ok"] for h in a_held)),
                C=[dict(h) for h in c_held])
            held += [len(a_held) == launched["fused_lookup"],
                     all(h["ok"] for h in a_held),
                     sum(h["launches"] for h in c_held)
                     == launched["placement_gains"],
                     all(h["ok"] for h in c_held)]
        if recorder is not None:
            f_held = hold_duel_planes(torch, recorder.planes,
                                      out["engine"].ecfg)
            n_batches = sum(h["batches"] for h in f_held)
            n_scans = sum(h["scan_launches"] for h in f_held)
            n_rearms = sum(h["rearms_held"]["calls"] for h in f_held)
            kernels_held["F"] = dict(planes=f_held, batches=n_batches,
                                     scans=n_scans, rearms=n_rearms)
            held += [n_batches > 0, duel_held_ok(f_held),
                     n_scans == launched["duel_scan"],
                     n_rearms == launched["duel_rearm"]]
        if name == "netduel_online":
            held += [out["c2"] < out["c_old"]]
            res = {k: out[k] for k in ("c1", "ref1", "c_old", "c2", "ref2",
                                       "n_promotions1", "n_promotions2")}
        elif name == "serve_simcache":
            cold, warm = out["cold"], out["warm"]
            held += [warm.hit_rate > 0, warm.mean_cost < out["h_model"],
                     cold.n_requests == warm.n_requests == 128,
                     cold.model_calls == 8]
            res = dict(h_model=out["h_model"], predicted=out["predicted"],
                       **{f"{tag}_{k}": getattr(st, k)
                          for tag, st in (("cold", cold), ("warm", warm))
                          for k in ("hit_rate", "mean_cost",
                                    "model_calls")})
        elif name == "streaming_serve":
            eng = out["engine"]
            st = [out["phase1"], out["phase2"]]
            held += [[(s.n_requests, s.n_batches) for s in st]
                     == [(600, 15), (600, 15)],
                     eng.swap_count >= 1, not eng.refresh_in_flight,
                     eng.stats.n_hits > 0]
            res = dict(predicted=out["predicted"],
                       hit_rate_after_drift=eng.stats.hit_rate,
                       swaps=eng.swap_count, refreshes=eng.refresh_count,
                       phases=[dict(requests=s.n_requests,
                                    batches=s.n_batches,
                                    sizes=s.distinct_batch_sizes,
                                    req_per_s=s.requests_per_s,
                                    p50_ms=s.p50_ms, p99_ms=s.p99_ms,
                                    placement_events=s.placement_events)
                               for s in st])
        else:
            losses = out["losses"]
            held += [bool(np.isfinite(losses).all()),
                     len(losses) == train_steps,
                     out["first"]["step"] == out["crash_at"],
                     f"resumed from step {out['crash_at']}"
                     in text.getvalue(),
                     out["resumed"]["step"] == train_steps]
            res = dict(steps=train_steps, crash_at=out["crash_at"],
                       first_loss=losses[0], last_loss=losses[-1],
                       step_ms_p50=float(np.median(
                           out["first"]["step_ms"]
                           + out["resumed"]["step_ms"])))
        held += [launched[k] > 0 for k in EXAMPLE_KERNELS[name]]
        runs[name] = dict(res, launches=launched, seconds=seconds,
                          held_against_plain=kernels_held, holds=held,
                          printed=text.getvalue().splitlines()[-12:])
        checks[name] = all(held)
    log("examples", **runs, phase_s=time.perf_counter() - t0)
    if not all(checks.values()):
        raise RuntimeError(f"examples failed their checks: {checks}")
    total: dict = {}
    for r in runs.values():
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def phase_launch():
    """The command-line entry point, as a user runs it, in a subprocess
    of its own (its kernel launches are its own, counted nowhere): the
    batch loop, streaming, streaming with ``--netduel``, whose printout
    must carry the duel churn, the batch loop with ``--warm-start``,
    ``--scenario scale_free --strategy lce`` in both loops, whose
    printout must name the scenario, and the batch loop with
    ``--arch jamba-1.5-large-398b`` (its smoke config: the engine's
    repository runs attention, Mamba and MoE layers); beside them the
    train launcher (:func:`train_launcher`). The eight runs are started
    together and share the card (each serve run's ``seconds`` is its
    time from the common start to its exit); each has its own 600 s
    limit, and every one is waited for before a failure raises."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    extras = (["--requests", "256"],
              ["--streaming", "--streams", "4", "--requests", "1024"],
              ["--streaming", "--streams", "4", "--requests", "1024",
               "--netduel"],
              ["--requests", "256", "--warm-start"],
              ["--scenario", "scale_free", "--strategy", "lce",
               "--requests", "256"],
              ["--scenario", "scale_free", "--strategy", "lce",
               "--streaming", "--requests", "1024"],
              ["--arch", "jamba-1.5-large-398b", "--requests", "256"])
    t0 = time.perf_counter()

    def run(extra):
        arch = [] if "--arch" in extra else ["--arch", "granite-3-2b"]
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", *arch,
               *extra]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               env=env, cwd=ROOT, timeout=600)
            rc, stdout, stderr = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired:          # killed by ``run``
            rc, stdout, stderr = "timeout", "", "killed after 600 s"
        return rc, stdout, stderr, time.perf_counter() - t0

    with ThreadPoolExecutor(len(extras) + 1) as pool:
        trained = pool.submit(train_launcher)
        results = list(pool.map(run, extras))
        train = trained.result()
    runs, failed = [], None
    for extra, (rc, stdout, stderr, seconds) in zip(extras, results):
        lines = [ln for ln in stdout.splitlines() if ln.startswith("[serve]")]
        final = next((ln for ln in reversed(lines) if "hit-rate" in ln), None)
        runs.append(dict(args=extra, rc=rc, seconds=seconds,
                         serve_lines=lines))
        if final:
            print(final, flush=True)
        churn = "--netduel" not in extra or any(
            "duel churn" in ln for ln in lines)
        named = "--scenario" not in extra or any(
            "[serve] scenario scale_free" in ln for ln in lines)
        if failed is None and (rc != 0 or final is None or not churn
                               or not named):
            failed = (extra, stderr[-3000:])
    if failed is None and not train["ok"]:
        failed = (["repro_torch.launch.train"], train["stderr_tail"])
    if failed:
        log("launch", runs=runs, train_launcher=train,
            stderr_tail=failed[1])
        raise RuntimeError(f"the launcher failed: {' '.join(failed[0])}")
    log("launch", runs=runs, train_launcher=train,
        phase_s=time.perf_counter() - t0)


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
    big = phase_bigcache(torch, cat, dem)
    compress = phase_compress(torch, big)
    sharded_lookup = phase_sharded_lookup(torch, big,
                                          compress.pop("plane"))
    del big
    f, f_rearm = phase_duel(torch, cat, dem, clock_hz)
    counts, params, cascade = phase_engine(torch, cat, dem)
    warm_counts = phase_warmstart(torch, cat, dem, params, cascade)
    del params
    gc.collect()                                  # the engine's model
    torch.cuda.empty_cache()
    phase_warm_1e6(torch)
    params = phase_prefill(torch)
    gen_counts = phase_generate(torch, params, clock_hz)
    stream_counts, stream = phase_stream(torch, params)
    sharded_engine = phase_sharded_engine(torch, params, stream)
    del stream
    duel_counts = phase_duel_engine(torch, params)
    scenario_counts = phase_scenario(torch, params)
    lb_gains, greedy_exact = phase_gain_quant(torch)
    sharded_control = phase_sharded_control(torch, cat, dem, greedy_exact)
    del greedy_exact
    cand_ca = phase_hitrate(torch)
    gate_counts = phase_gate(torch, params)
    mesh = phase_mesh(torch, params, clock_hz)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    wide_counts = phase_generate_wide(torch, clock_hz)
    family_counts = phase_families(torch, clock_hz)
    phase_train(torch)
    phase_launch()
    example_counts = phase_examples()
    counts["greedy_gain"] = d["launches"]         # its entry point's run
    counts["flash_attention"] = stream_counts["flash_attention"]
    counts["duel_scan"] = duel_counts["duel_scan"]  # the online plane's run
    counts["duel_rearm"] = duel_counts["duel_rearm"]

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
                             "src/repro/core/placement/netduel.py:215"),
               "duel_rearm": ("src/repro_torch/kernels/csrc/duel.cu",
                              "src/repro/core/placement/netduel.py:254")}
    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    shapes = {"fused_lookup": (a, a_big), "knn": (b, b_big),
              "placement_gains": (c, c_stream)}
    kernels = []
    for r in (a, b, c, d, e, f, f_rearm):
        src, repl = sources[r["name"]]
        kernels.append(dict(
            name=r["name"], route="cuda", source=src, replaces=repl,
            launches=counts[r["name"]], **{k: r[k] for k in timed}))
        if "device_ms" in r:
            kernels[-1]["device_ms"] = r["device_ms"]
        if r["name"] == "fused_lookup":  # the warm start's, item 10's
            kernels[-1]["launches_warmstart"] = warm_counts["fused_lookup"]
            kernels[-1]["launches_compress"] = compress["launches"]
        if r["name"] == "placement_gains":       # GREEDY on the scenario
            kernels[-1]["launches_scenario"] = scenario_counts["greedy"]
            kernels[-1]["launches_sharded"] = dict(
                control=sharded_control["launches"],
                engine=sharded_engine["placement_gains"])
        if r["name"] == "fused_lookup":          # item 11's shard loop
            kernels[-1]["launches_sharded"] = dict(
                lookup=sharded_lookup["launches"],
                engine=sharded_engine["fused_lookup"])
            kernels[-1]["shard_local_hold"] = sharded_lookup["hold"]
        if r["name"] == "flash_attention":       # the strategy engines
            kernels[-1]["launches_scenario"] = \
                scenario_counts["flash_attention"]
            kernels[-1]["launches_generate"] = (     # greedy_generate
                gen_counts["flash_attention"]
                + wide_counts["flash_attention"])
            # the other families' counted runs (item 14b)
            kernels[-1]["launches_families"] = \
                family_counts["flash_attention"]
            # the mesh phase's prefill under the production policy: its
            # launches and E held at H 32 / KH 16 (item 14d)
            kernels[-1]["launches_mesh"] = mesh["flash_attention"]
            kernels[-1]["mesh_hold"] = {
                k: mesh["e_hold"][k] for k in ("B", "S", "H", "KH", "Dh")
                + E_FIELDS + ("max_abs_err", "share_of_bound")}
        if r["name"] in example_counts:          # the examples' twins
            kernels[-1]["launches_examples"] = example_counts[r["name"]]
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
    kernels[5]["chain_floor_share"] = f["chain_floor_share"]
    for k, r in ((kernels[5], f), (kernels[6], f_rearm)):
        k["launches_duel"] = r["launches"]     # the `duel` phase's run
    # item 10's torch paths (XLA in the reference, no Pallas kernel), each
    # beside the exact path it sits in front of
    xla_paths = compress["xla"] + [lb_gains, cand_ca]
    print(json.dumps({"kernels": kernels, "xla_paths": xla_paths}),
          flush=True)
    log("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
