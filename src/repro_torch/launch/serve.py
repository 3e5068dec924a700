"""Serving launcher: a reduced model behind the similarity-cache network
(the paper's system end to end), on the CUDA card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --requests 256

Counterpart of ``repro.launch.serve``, with its flags and defaults.
``--streaming`` switches from the fixed-batch replay loop to the
multi-stream driver (serve/stream.py): N Poisson request streams
multiplexed into bucketed batches, placement refreshed through the
double buffer in the background on a cadence (``--refresh-every``, and
on NETDUEL promotion churn with ``--netduel``) and swapped in between
batches.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --streaming --streams 4 --requests 1024 --netduel

``--netduel`` runs the §5 online duels inside the engine (kernel F on
the card) and lets their churn start refreshes. ``--warm-start`` solves
every refresh by the §4 continuous-limit warm start (an analytic solve,
the Prop 4.2 band map and a LOCALSWAP polish of
``--warm-polish-iters`` requests) in place of the discrete solver. The
launcher runs on the card and exits non-zero without one. A flag of a
later slice is parsed as in the reference and raises
``NotImplementedError`` naming its ROADMAP item when given:
``--scenario`` (queue 1 item 13); ``--strategy``, ``--cache-budget``
and ``--ingress`` matter only with it.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.registry import get_smoke_config, list_archs
from repro_torch.core import catalog as catalog_api
from repro_torch.core import demand as demand_api
from repro_torch.models import model as model_api
from repro_torch.serve import (EngineConfig, SimCacheEngine, StreamDriver,
                               StreamSpec)

# the reference's choices (repro.core.scenarios.GENERATORS and
# repro.core.routing.STRATEGIES), copied: their modules are item 13
SCENARIOS = ("isp", "scale_free", "watts_strogatz")
STRATEGIES = ("lce", "lcd", "probcache", "sim-lru", "rnd-lru")

# flag → the ROADMAP queue 1 item that ports what it switches on
DEFERRED = (("scenario", "item 13"),)


def run_batch_loop(eng, cfg, dem, args) -> None:
    rng = np.random.default_rng(0)
    n_batches = args.requests // args.batch
    for i in range(n_batches):
        ids, ings = dem.sample(args.batch, rng)
        prompts = torch.as_tensor(rng.integers(
            0, cfg.vocab, (args.batch, 16)).astype(np.int32),
            device=eng.device)
        eng.serve(ids, prompts, ingress_ids=ings)
        if i == n_batches // 2:
            pred = eng.refresh_placement()
            print(f"[serve] placement refreshed; predicted C(A)={pred:.2f}")


def run_streaming(eng, cat, args) -> None:
    n_ing = eng.net.n_ingress
    streams = [
        StreamSpec(demand=demand_api.zipf(cat, alpha=1.0,
                                          n_ingress=n_ing, seed=s + 1),
                   rate=1.0 + s, seed=s + 1, name=f"stream{s}")
        for s in range(args.streams)]
    drv = StreamDriver(eng, streams, max_batch=args.batch * 4,
                       batch_window=2.0, prompt_len=16,
                       refresh_every=args.refresh_every)
    drv.run(max(args.requests // 8, args.batch))   # observe demand cold
    pred = eng.refresh_placement()
    print(f"[serve] initial placement; predicted C(A)={pred:.2f}")
    st = drv.run(args.requests)
    drv.drain_refresh()
    print(f"[serve] streaming: {st.n_requests} requests in "
          f"{st.n_batches} batches ({st.distinct_batch_sizes} distinct "
          f"sizes), {st.requests_per_s:.0f} req/s, latency p50/p95/p99 "
          f"{st.p50_ms:.0f}/{st.p95_ms:.0f}/{st.p99_ms:.0f} ms")
    print(f"[serve] refreshes {st.refreshes_started} swaps {st.swaps} "
          f"(max stall {st.max_swap_stall_s*1e3:.1f} ms) duel churn "
          f"{st.placement_events}; placement v{eng.placement.version}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--algo", default="cascade",
                    choices=["greedy", "localswap", "cascade"])
    ap.add_argument("--streaming", action="store_true",
                    help="async multi-stream driver + background refresh")
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--refresh-every", type=int, default=16,
                    help="background re-solve cadence, in batches")
    ap.add_argument("--netduel", action="store_true",
                    help="§5 online duels; churn triggers refreshes too")
    ap.add_argument("--warm-start", action="store_true",
                    help="§4 continuous-limit warm start on every "
                         "refresh (analytic solve + Prop 4.2 band map + "
                         "bounded polish instead of the O(O·J) solver)")
    ap.add_argument("--warm-polish-iters", type=int, default=512,
                    help="LOCALSWAP polish window after the warm start")
    ap.add_argument("--scenario", default=None, choices=SCENARIOS,
                    help="serve a generated general-graph network "
                         "(not ported: queue 1 item 13)")
    ap.add_argument("--strategy", default="lce", choices=STRATEGIES,
                    help="on-path routing strategy (with --scenario)")
    ap.add_argument("--cache-budget", type=int, default=64,
                    help="total cache slots split over the graph by "
                         "degree centrality (with --scenario)")
    ap.add_argument("--ingress", type=int, default=4,
                    help="number of ingress nodes (with --scenario)")
    return ap


def engine_config(args) -> EngineConfig:
    """The engine configuration the launcher's flags select."""
    return EngineConfig(algo=args.algo, netduel=args.netduel,
                        refresh_on_promotion=args.netduel,
                        warm_start=args.warm_start,
                        warm_polish_iters=args.warm_polish_iters)


def main(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    for flag, item in DEFERRED:
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet: ROADMAP "
                f"queue 1 {item}")
    try:
        device = resolve_device()
    except RuntimeError as e:
        raise SystemExit(f"[serve] {e}") from e

    cfg = get_smoke_config(args.arch)
    params = model_api.init_params(cfg, 0, device=device)
    cat = catalog_api.embedding_catalog(n=1000, dim=32, seed=0)
    dem = demand_api.zipf(cat, alpha=1.0, seed=1)
    eng = SimCacheEngine(cfg, params, engine_config(args), cat.coords,
                         device=device)
    eng.calibrate(torch.zeros((args.batch, 16), dtype=torch.int32,
                              device=device))

    if args.streaming:
        run_streaming(eng, cat, args)
    else:
        run_batch_loop(eng, cfg, dem, args)
    s = eng.stats
    print(f"[serve] {s.n_requests} requests, hit-rate {s.hit_rate:.1%}, "
          f"mean cost {s.mean_cost:.2f} ms, model batches {s.model_calls}")


if __name__ == "__main__":
    main()
