"""The dry run's train cells at smoke size, counted under the torch this
process runs: each cell's collectives by kind and its bytes per device
(launch/dryrun.py, ``count_collectives``), and, for each DTensor-level
op of the step, the collectives issued while it ran. Two torch versions
choose different layouts for some ops; ``--diff`` names those whose
collective bytes differ most.

  PYTHONPATH=src python scripts/dryrun_train_cells.py --out a.json
  PYTHONPATH=src python scripts/dryrun_train_cells.py --diff a.json b.json

The cells are those of tests/test_torch_dryrun.py: granite-3-2b's smoke
config on 4 × 2 and 2 × 4 (B 8, S 16), xlstm-350m at two layers, and the
policy knobs dp, dp_batch, attn_batch and bf16_flows on 4 × 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import ShardMesh

COUNTER = dryrun._collective_counter
F42 = ShardMesh(("data", "model"), (4, 2))
T24 = ShardMesh(("data", "model"), (2, 4))


def cells() -> dict:
    g = get_smoke_config("granite-3-2b")
    x = dataclasses.replace(get_smoke_config("xlstm-350m"), n_layers=2,
                            slstm_every=2)
    return {"train-4x2": (g, F42, {}), "train-2x4": (g, T24, {}),
            "xlstm_train": (x, F42, {}),
            "dp": (g, F42, dict(ffn_mode="dp")),
            "dp_batch": (g, F42, dict(ffn_mode="dp_batch")),
            "attn_batch": (g, F42, dict(attn_override="batch")),
            "bf16_flows": (g, F42, dict(bf16_flows=True))}


def op_counter(log: list):
    """``dryrun._collective_counter`` that also appends, in order, each
    DTensor-level op (its name) and each collective record to ``log``."""
    from torch.distributed.tensor import DTensor
    base = type(COUNTER())

    class OpCounter(base):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            flat = [a for a in args if isinstance(a, DTensor)] + [
                b for a in args if isinstance(a, (list, tuple))
                for b in a if isinstance(b, DTensor)]
            if flat:
                log.append(("op", str(func)))
            n0 = len(self.records)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            log.extend(("coll", *r) for r in self.records[n0:])
            return out
    return OpCounter()


def per_op(log: list) -> list:
    """[op, [records it issued]] for each op that issued any."""
    out = []
    for e in log:
        if e[0] == "op":
            out.append([e[1], []])
        elif out:
            out[-1][1].append(list(e[1:]))
    return [o for o in out if o[1]]


def measure() -> dict:
    res = {}
    for name, (cfg, mesh, knob) in cells().items():
        log: list = []
        dryrun._collective_counter = lambda: op_counter(log)
        try:
            c = tspecs.build_cell(cfg, tspecs.ShapeCell("smoke", 16, 8,
                                                        "train"),
                                  mesh, dryrun.opt_for(cfg), **knob)
            coll = dryrun.count_collectives(c)
            res[name] = {"counts": coll["counts"],
                         "bytes_per_device": coll["bytes_per_device"],
                         "per_op": per_op(log)}
        except Exception as e:                  # the cause is the result
            res[name] = {"error": dryrun._cause(e)}
        finally:
            dryrun._collective_counter = COUNTER
        print(name, json.dumps({k: v for k, v in res[name].items()
                                if k != "per_op"}))
    return {"torch": torch.__version__, "cells": res}


def by_op(cell: dict) -> dict:
    """Each op's ring-priced collective bytes over the whole step."""
    out: dict = {}
    for name, recs in cell["per_op"]:
        out[name] = out.get(name, 0.0) + sum(
            roofline._ring_bytes(op, n_bytes, n) for op, n_bytes, n in recs)
    return out


def diff(a: dict, b: dict, top: int = 5) -> None:
    """Each cell's bytes per device under both versions, and the ``top``
    ops whose collective bytes over the step differ most (A's, B's)."""
    print(f"cell: bytes per device under torch {a['torch']} / "
          f"{b['torch']}; the ops that part most")
    for name, ca in a["cells"].items():
        cb = b["cells"][name]
        print(name, ca.get("bytes_per_device", ca.get("error")), "/",
              cb.get("bytes_per_device", cb.get("error")))
        if "per_op" not in ca or "per_op" not in cb:
            continue
        oa, ob = by_op(ca), by_op(cb)
        parted = sorted(oa.keys() | ob.keys(),
                        key=lambda k: -abs(oa.get(k, 0) - ob.get(k, 0)))
        for k in parted[:top]:
            if oa.get(k, 0) != ob.get(k, 0):
                print(f"  {k}: {oa.get(k, 0):.0f} / {ob.get(k, 0):.0f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write the measurement here as JSON")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"),
                    help="compare two measurements")
    args = ap.parse_args()
    if args.diff:
        a, b = (json.load(open(p)) for p in args.diff)
        diff(a, b)
        return
    res = measure()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
