"""End-to-end driver on the PyTorch port (twin of
examples/serve_simcache.py): serve a small LM with batched requests
through the similarity-cache network.

Flow: cold phase (every request runs the model) → the engine's control
plane solves the paper's placement problem on the observed demand (the
cascade: GREEDY and a LOCALSWAP polish through kernel C on the card) →
warm phase (most requests served by approximizers, each batch one
kernel-A lookup). Reports hit rate, mean serving cost (in calibrated ms
units), and model-call savings.

  PYTHONPATH=src python examples/serve_simcache_torch.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import catalog as catalog_api
from repro_torch.core import demand as demand_api
from repro_torch.models import model as model_api
from repro_torch.serve import EngineConfig, SimCacheEngine


def run(device=None) -> dict:
    """The example's body; returns what it prints, each phase's stats
    and the engine."""
    dev = resolve_device(device)
    # a ~5M-param decoder LM as the "repository"
    cfg = dataclasses.replace(
        get_smoke_config("granite-3-2b"), n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab=512)
    params = model_api.init_params(cfg, 0, device=dev)

    # request universe: 2000 embedded queries, Zipf popularity
    cat = catalog_api.embedding_catalog(n=2000, dim=32, seed=0)
    dem = demand_api.zipf(cat, alpha=1.1, seed=1)
    ecfg = EngineConfig(k_device=32, k_pod=64, k_global=96, metric="l2",
                        algo="cascade")
    eng = SimCacheEngine(cfg, params, ecfg, cat.coords, device=dev)

    ms = eng.calibrate(torch.zeros((16, 16), dtype=torch.int32))
    print(f"calibrated: model forward = {ms:.1f} ms  "
          f"(h_ici {eng.ecfg.h_ici:.2f}, h_dcn {eng.ecfg.h_dcn:.2f})\n")

    def run_phase(name, n_batches, seed):
        eng.stats = type(eng.stats)()
        r = np.random.default_rng(seed)
        for _ in range(n_batches):
            ids, _ = dem.sample(16, r)
            prompts = torch.as_tensor(
                r.integers(0, cfg.vocab, (16, 16)).astype(np.int32))
            eng.serve(ids, prompts)
        s = eng.stats
        print(f"{name:18s} hit-rate {s.hit_rate:5.1%}  "
              f"mean cost {s.mean_cost:8.2f}  model calls {s.model_calls}")
        return s

    cold = run_phase("cold (no cache)", 8, seed=1)
    pred = eng.refresh_placement()
    print(f"\nplacement solved (cascade): predicted C(A) = {pred:.2f}\n")
    warm = run_phase("warm (cached)", 8, seed=2)
    return {"h_model": ms, "cold": cold, "predicted": pred, "warm": warm,
            "engine": eng}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    run(device=ap.parse_args().device)


if __name__ == "__main__":
    main()
