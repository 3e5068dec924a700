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
``--warm-polish-iters`` requests) in place of the discrete solver.

``--scenario`` swaps the built-in 3-level hierarchy for a generated
general-graph network (core/scenarios.py: isp / scale_free /
watts_strogatz, ``--cache-budget`` slots split by degree centrality,
``--ingress`` ingress nodes) and serves its multi-ingress traffic
through the on-path strategy plane that ``--strategy`` picks
(core/routing.py); it runs no placement refresh and no ``calibrate()``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --streaming --scenario scale_free --strategy lce --requests 512

The launcher runs on the card and exits non-zero without one.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.registry import get_smoke_config, list_archs
from repro_torch.core import catalog as catalog_api
from repro_torch.core import demand as demand_api
from repro_torch.core import scenarios as scenarios_api
from repro_torch.core.routing import STRATEGIES
from repro_torch.models import model as model_api
from repro_torch.serve import (EngineConfig, SimCacheEngine, StreamDriver,
                               StreamSpec)


def run_batch_loop(eng, cfg, dem, args) -> None:
    rng = np.random.default_rng(0)
    n_batches = args.requests // args.batch
    for i in range(n_batches):
        ids, ings = dem.sample(args.batch, rng)
        prompts = torch.as_tensor(rng.integers(
            0, cfg.vocab, (args.batch, 16)).astype(np.int32),
            device=eng.device)
        eng.serve(ids, prompts, ingress_ids=ings)
        if i == n_batches // 2 and eng.routing is None:
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
                       refresh_every=(0 if eng.routing is not None
                                      else args.refresh_every))
    drv.run(max(args.requests // 8, args.batch))   # observe demand cold
    if eng.routing is None:
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
    ap.add_argument("--scenario", default=None,
                    choices=sorted(scenarios_api.GENERATORS),
                    help="serve a generated general-graph network "
                         "through the on-path strategy plane instead "
                         "of the built-in 3-level hierarchy")
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
    if args.scenario:
        return EngineConfig(algo=args.algo, strategy=args.strategy)
    return EngineConfig(algo=args.algo, netduel=args.netduel,
                        refresh_on_promotion=args.netduel,
                        warm_start=args.warm_start,
                        warm_polish_iters=args.warm_polish_iters)


def build_engine(args, cfg, params, cat, device):
    """The engine and demand the flags select. With ``--scenario`` the
    engine serves the generated network through the strategy plane (the
    fused simcache is single-ingress) and is not calibrated; without,
    it serves the built-in hierarchy, calibrated."""
    if args.scenario:
        sc = scenarios_api.scenario(args.scenario,
                                    cache_budget=args.cache_budget,
                                    placement="degree",
                                    n_ingress=args.ingress, seed=0)
        dem = demand_api.zipf(cat, alpha=1.0,
                              n_ingress=sc.net.n_ingress, seed=1)
        eng = SimCacheEngine(cfg, params, engine_config(args), cat.coords,
                             net=sc.net, device=device)
        print(f"[serve] scenario {args.scenario}: "
              f"{sc.graph.n_nodes} nodes, {sc.net.n_caches} caches "
              f"({sc.net.total_slots} slots), "
              f"{sc.net.n_ingress} ingress, strategy {args.strategy}")
        return eng, dem
    dem = demand_api.zipf(cat, alpha=1.0, seed=1)
    eng = SimCacheEngine(cfg, params, engine_config(args), cat.coords,
                         device=device)
    eng.calibrate(torch.zeros((args.batch, 16), dtype=torch.int32,
                              device=device))
    return eng, dem


def main(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    try:
        device = resolve_device()
    except RuntimeError as e:
        raise SystemExit(f"[serve] {e}") from e

    cfg = get_smoke_config(args.arch)
    params = model_api.init_params(cfg, 0, device=device)
    cat = catalog_api.embedding_catalog(n=1000, dim=32, seed=0)
    eng, dem = build_engine(args, cfg, params, cat, device)

    if args.streaming:
        run_streaming(eng, cat, args)
    else:
        run_batch_loop(eng, cfg, dem, args)
    s = eng.stats
    print(f"[serve] {s.n_requests} requests, hit-rate {s.hit_rate:.1%}, "
          f"mean cost {s.mean_cost:.2f} ms, model batches {s.model_calls}")


if __name__ == "__main__":
    main()
