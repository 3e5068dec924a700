"""Streaming serving end to end on the PyTorch port (twin of
examples/streaming_serve.py): N concurrent request streams, bucketed
batches, and a placement that follows the demand without ever blocking
the request path.

    PYTHONPATH=src python examples/streaming_serve_torch.py [--device cpu]

The run has two demand phases. Phase 1 multiplexes four Poisson streams
(distinct Zipf permutations, distinct rates) through the StreamDriver:
arrivals coalesce into variable-size batches, every batch runs at its
power-of-two bucket shape (one lookup signature per bucket, however many
distinct sizes the arrival process produces), and the §5 NETDUEL plane
duels candidate placements on the device inside the serving loop (kernel
F on the card; each batch's lookup is kernel A, each solve's gains
kernel C). A settled promotion rebuilds the runtime cache *and* triggers
a background offline re-solve (EngineConfig.refresh_on_promotion): the
solve runs on a worker thread while the old placement keeps serving, and
the finished allocation is swapped in atomically between batches — the
only serving-thread cost is the swap itself.

Phase 2 replaces every stream's demand with a fresh permutation (the
population's interests drift all at once). Hit rate collapses, the duel
plane detects the drift through promotion churn, and the
refresh-on-promotion loop re-solves against the *new* observed window —
the engine recovers without a single synchronous refresh call.
"""
import argparse
import dataclasses

from repro_torch._device import resolve_device
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import catalog as catalog_api
from repro_torch.core import demand as demand_api
from repro_torch.models import model as model_api
from repro_torch.serve import (EngineConfig, SimCacheEngine, StreamDriver,
                               StreamSpec)


def report(tag, eng, st):
    print(f"[{tag}] {st.n_requests} requests / {st.n_batches} batches "
          f"({st.distinct_batch_sizes} distinct sizes) "
          f"{st.requests_per_s:.0f} req/s")
    print(f"[{tag}]   latency p50/p95/p99 = "
          f"{st.p50_ms:.0f}/{st.p95_ms:.0f}/{st.p99_ms:.0f} ms; "
          f"hit rate so far {eng.stats.hit_rate:.1%}")
    print(f"[{tag}]   duel churn {st.placement_events}, background "
          f"swaps {st.swaps} (max stall {st.max_swap_stall_s*1e3:.1f} ms)"
          f", placement v{eng.placement.version}")


def run(device=None) -> dict:
    """The example's body; returns its predicted C(A), both phases'
    driver stats and the engine."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"),
                              n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=2, head_dim=16, d_ff=128,
                              vocab=256)
    params = model_api.init_params(cfg, 0, device=dev)
    cat = catalog_api.embedding_catalog(n=400, dim=16, seed=1)
    ecfg = EngineConfig(k_device=16, k_pod=24, k_global=32,
                        h_ici=1.0, h_dcn=10.0, h_model=100.0,
                        metric="l2", algo="greedy",
                        netduel=True, duel_window=128, duel_arm_prob=0.5,
                        refresh_on_promotion=True)
    eng = SimCacheEngine(cfg, params, ecfg, cat.coords, device=dev)

    def make_streams(phase_seed):
        rates = [5.0, 9.0, 2.0, 4.0]
        return [StreamSpec(
            demand=demand_api.zipf(cat, alpha=1.1,
                                   seed=phase_seed * 100 + s),
            rate=rates[s], seed=s + 1, name=f"user{s}")
            for s in range(4)]

    drv = StreamDriver(eng, make_streams(1), max_batch=64,
                       batch_window=2.0)
    print("== cold start: observing demand, no placement yet ==")
    drv.run(128)
    pred = eng.refresh_placement()
    print(f"initial placement solved; predicted C(A) = {pred:.2f}\n")

    print("== phase 1: four streams, NETDUEL online, background "
          "refresh on promotion churn ==")
    st1 = drv.run(600)
    drv.drain_refresh()
    report("phase1", eng, st1)

    print("\n== phase 2: demand drifts (every stream re-permuted) ==")
    eng.stats = type(eng.stats)()             # fresh hit-rate window
    drv.set_streams(make_streams(2))
    st2 = drv.run(600)
    drv.drain_refresh()
    report("phase2", eng, st2)
    print(f"\nfinal: hit rate after drift {eng.stats.hit_rate:.1%}, "
          f"placement refreshed {eng.refresh_count}x "
          f"({eng.swap_count} async swaps, total stall "
          f"{eng.swap_stall_s*1e3:.1f} ms)")
    return {"predicted": pred, "phase1": st1, "phase2": st2, "engine": eng}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    run(device=ap.parse_args().device)


if __name__ == "__main__":
    main()
