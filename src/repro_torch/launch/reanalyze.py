"""Recompute the roofline of stored dry-run records (no step is run).

Counterpart of ``repro.launch.reanalyze``: used when the roofline
formulas or constants (launch/roofline.py, launch/mesh.py) change; the
counted terms of each record (FLOPs, argument bytes, priced collectives)
are kept as they are.

  PYTHONPATH=src python -m repro_torch.launch.reanalyze [DIR]
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import sys

from repro_torch.configs.registry import get_config
from repro_torch.launch import roofline as rf
from repro_torch.launch.dryrun import RESULTS_DIR
from repro_torch.launch.specs import SHAPES


def reanalyze_file(path: str) -> bool:
    """Rewrite one record's ``roofline`` and ``analytic_flops_global``;
    False (and the file untouched) for a record that is not ``ok``."""
    with open(path) as f:
        r = json.load(f)
    if r.get("status") != "ok":
        return False
    policy = r.get("policy", {})
    cfg = dataclasses.replace(
        get_config(r["arch"]),
        moe_dispatch=policy.get("moe_dispatch", "einsum"),
        kv_cache_dtype=policy.get("kv_cache_dtype", "compute"))
    cell = SHAPES[r["shape"]]
    n_dev = r["devices"]
    counted = r["extrapolated"]["flops"]
    analytic = rf.analytic_flops(cfg, cell)
    flops_dev = analytic / n_dev if counted is None \
        else max(counted, analytic / n_dev)
    bytes_dev = rf.analytic_bytes(
        cfg, cell, n_dev, policy.get("moment_dtype", "float32"),
        ffn_mode=policy.get("ffn_mode", "tp"))
    coll = r.get("collectives")
    r["roofline"] = rf.roofline(
        flops_dev, bytes_dev, None if coll is None
        else coll["bytes_per_device"], coll or {}, cfg, cell, n_dev)
    r["extrapolated"]["bytes"] = bytes_dev
    r["analytic_flops_global"] = analytic
    with open(path, "w") as f:
        json.dump(r, f, indent=1)
    return True


def main() -> None:
    root = sys.argv[1] if len(sys.argv) > 1 else RESULTS_DIR
    n = 0
    for path in sorted(glob.glob(os.path.join(root, "*.json"))):
        n += reanalyze_file(path)
    print(f"[reanalyze] updated {n} cells")


if __name__ == "__main__":
    main()
