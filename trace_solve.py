#!/usr/bin/env python3
"""Where the cascade placement solve spends its time on one CUDA card.

    python3 trace_solve.py [--window 64]

Builds the instance that ``chip_smoke.py``'s engine phase solves after
its cold phase (the 10⁵-object ``embedding_catalog`` at dim 100, Zipf(0.8)
demand observed over 16 batches of 256 requests, the default 64/128/256
hierarchy at h = 15 / 150 / 1000) and runs the engine's default solve,
``device_greedy`` then ``device_localswap_polish(max_passes=8)``, on a
streaming ``DeviceInstance``. It prints one JSON line per phase:

* ``greedy`` / ``polish`` — wall seconds of the whole phase, with the
  number of stale-table refreshes (GREEDY) and of passes and swaps
  (polish), counted by wrapping the module's step functions;
* ``profile`` — for each step the solve repeats (one 64-candidate
  refresh, one pick, one polish request), torch.profiler's count of
  CUDA kernel launches, the device's busy time per step and the five
  kernels that take most of it, beside the step's wall time measured
  without the profiler; the idle share is 1 − busy / wall.

Exits non-zero without a card, or when the profiler records no device
activity.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def observed_instance(n_batches: int = 16, batch: int = 256):
    """The engine's observed window after ``chip_smoke.py``'s cold phase:
    per-object request counts, normalized in f64 with no floor."""
    from repro_torch.core import catalog as catalog_api
    from repro_torch.core import demand as demand_api
    from repro_torch.core.objective import Instance
    from repro_torch.core.topology import tpu_hierarchy
    cat = catalog_api.embedding_catalog(n=100_000, dim=100, seed=0)
    dem = demand_api.zipf(cat, alpha=0.8, seed=0)
    counts = np.zeros((1, cat.n), np.float64)
    r = np.random.default_rng(1)
    for _ in range(n_batches):
        ids, _ = dem.sample(batch, r)
        np.add.at(counts[0], ids, 1.0)
    cat = catalog_api.Catalog(coords=cat.coords, metric="l2", gamma=1.0)
    net = tpu_hierarchy(64, 128, 256, 15.0, 150.0, 1000.0)
    return Instance(net=net, cat=cat,
                    dem=demand_api.Demand(lam=counts / counts.sum()))


def counted(module, name: str) -> list:
    """Wrap ``module.name`` so each call adds one to the returned cell."""
    fn, n = getattr(module, name), [0]

    def wrapper(*a, **k):
        n[0] += 1
        return fn(*a, **k)
    setattr(module, name, wrapper)
    return n


def profile_steps(torch, step, n: int) -> dict:
    """Kernel launches and device busy time per call of ``step`` under
    torch.profiler, and its wall time per call without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy",
                                                        "Memset"))]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, end = 0.0, -np.inf
    for s, e in spans:                    # union of device intervals
        if e > end:
            busy_us += e - max(s, end)
            end = e
    busy_ms = busy_us / 1e3 / n
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(calls=n, wall_ms=wall_ms,
                kernels_per_call=len(kernels) / n,
                copies_per_call=(len(dev) - len(kernels)) / n,
                device_busy_ms=busy_ms,
                idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                top_device_ms_per_call=[[k[:90], v] for k, v in top])


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--window", type=int, default=64,
                    help="polish requests in the profiled window")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_solve: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core.objective import DeviceInstance
    from repro_torch.core.placement import device as dp

    log("device", kind=torch.cuda.get_device_name(0),
        torch=torch.__version__)
    inst = observed_instance()
    dinst = DeviceInstance.from_instance(inst, materialize_ca=False,
                                         device="cuda")
    ings, objs = np.nonzero(inst.lam > 0)
    log("instance", objects=dinst.n_objects, caches=dinst.n_caches,
        slots=int(inst.net.total_slots), requested=int(objs.size))

    n_refresh = counted(dp, "_refresh_topk")
    t = time.perf_counter()
    slots = dp.device_greedy(dinst)
    greedy_s = time.perf_counter() - t
    picks = int((slots >= 0).sum())
    log("greedy", seconds=greedy_s, picks=picks, refreshes=n_refresh[0],
        refreshes_per_pick=n_refresh[0] / max(picks, 1))

    slots = np.where(slots < 0, 0, slots)
    n_pass = counted(dp, "_run_localswap_window")
    t = time.perf_counter()
    st = dp.device_localswap_polish(dinst, slots, max_passes=8, tol=1e-3)
    st.slots_np
    polish_s = time.perf_counter() - t
    log("polish", seconds=polish_s, passes=n_pass[0], swaps=st.n_swaps,
        requests_per_pass=int(objs.size),
        ms_per_request=polish_s * 1e3 / (n_pass[0] * objs.size))

    # the steps the solve repeats, at the solve's shapes
    cur = dinst.apply_pick(dinst.initial_costs(), 0, 0)
    g = torch.Generator().manual_seed(0)
    cand = torch.randperm(dinst.n_objects, generator=g)[:dp.DEFAULT_TOPK]
    cand_o = cand.to("cuda")
    cand_j = (cand % dinst.n_caches).to("cuda")
    st0 = dp.DeviceSwapState.init(dinst, slots)
    win = slice(0, args.window)

    def polish_window():
        st = dataclasses.replace(st0)     # a swap replaces, never edits
        dp._run_localswap_window(dinst, st, objs[win], ings[win], 1e-3)

    steps = {
        "refresh_64": (lambda: dinst.gain_at(cur, cand_o, cand_j), 10),
        "pick": (lambda: dinst.apply_pick(cur, 17, 1), 10),
        f"polish_window_{args.window}": (polish_window, 1),
    }
    prof = {name: profile_steps(torch, fn, n)
            for name, (fn, n) in steps.items()}
    w = prof[f"polish_window_{args.window}"]
    w["per_request"] = {k: w[k] / args.window for k in (
        "wall_ms", "kernels_per_call", "device_busy_ms")}
    log("profile", **prof)
    return 0


if __name__ == "__main__":
    sys.exit(main())
