#!/usr/bin/env python3
"""Hold this checkout's lookup kernels (A and B) against another
revision's, bit for bit, and time both on one card.

    mkdir -p build/other && git archive <rev> | tar -x -C build/other
    python3 compare_knn.py build/other

Each side runs in a process of its own with only its own ``src/`` on the
path, through its public wrappers ``knn_cuda`` and ``fused_lookup_cuda``
(whose signatures every revision keeps), and builds its kernels into its
own ``build/kernels/``. So any revision of the port can be compared,
whatever its C interface. The sides run in the order other, this, this,
other; each writes its outputs and device times to ``build/compare/``.

Cases: every shape ``chip_smoke.py`` runs A and B at (the ``kernel``
phase's, the stream's lookup buckets and the ``bigcache`` phase's level
sizes, on catalog rows), then the other metrics, γ = 0.5,
``fold_repo=False``, D = 19 (the 4-byte staging path) and D = 8192 (rows
too wide for a resident query tile). The inputs are made from seeds in
each process and their hash must agree across the runs. Every output of
this side must be bitwise equal to the other side's and to its own second
run; each side's device time per call is from torch.profiler
(``chip_smoke.device_ms``). One JSON line per case, then a summary line;
exits 1 on any difference, 2 without a card. A time the profiler returned
no events for is printed as null.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "compare"


def cases():
    """(kernel, Q, K, D, metric, gamma, fold_repo, label)."""
    rows = [("A", 256, 448, "kernel"), ("A", 256, 65_536, "kernel")]
    rows += [("A", qb, 448, "stream bucket") for qb in (8, 16, 32, 64)]
    rows += [("B", 256, 448, "kernel"), ("B", 256, 65_536, "kernel")]
    rows += [("B", 256, kb, "bigcache level") for kb in (4096, 16_384,
                                                          45_056)]
    out = [(kn, Q, K, 100, "l2", 1.0, True, lab) for kn, Q, K, lab in rows]
    for metric in ("l1", "l2sq"):
        out += [(kn, Q, K, 100, metric, 1.0, True, "metric")
                for kn in ("A", "B") for Q, K in ((256, 65_536), (64, 448))]
    out += [("A", 256, 448, 100, "l2", 0.5, True, "gamma"),
            ("B", 256, 20_000, 100, "l2", 0.5, True, "gamma"),
            ("A", 256, 65_536, 100, "l2", 1.0, False, "fold_repo=False"),
            ("A", 77, 20_000, 19, "l2", 1.0, True, "4-byte staging"),
            ("B", 77, 20_000, 19, "l1", 1.0, True, "4-byte staging"),
            ("A", 77, 3000, 8192, "l2", 1.0, True, "wide rows"),
            ("B", 77, 3000, 8192, "l2", 1.0, True, "wide rows")]
    return out


def run_side(src: pathlib.Path, out: pathlib.Path) -> None:
    """One side: every case through the wrappers of the ``repro_torch``
    under ``src``; outputs, input hashes and device times to ``out``."""
    import chip_smoke                      # puts this checkout's src first
    sys.path.insert(0, str(src))
    import torch

    import repro_torch
    from repro_torch.core import catalog as catalog_api
    from repro_torch.kernels.knn.knn import fused_lookup_cuda, knn_cuda
    assert pathlib.Path(repro_torch.__file__).resolve().is_relative_to(src)
    coords = catalog_api.embedding_catalog(n=100_000, dim=100,
                                           seed=0).coords
    results = []
    for i, (kn, Q, K, D, metric, gamma, fold, _) in enumerate(cases()):
        rng = np.random.default_rng(i)
        if D == coords.shape[1]:
            q, k, h, meta = chip_smoke._lookup_inputs(torch, coords, Q, K,
                                                      rng)
        else:
            q = torch.as_tensor(rng.standard_normal((Q, D)),
                                dtype=torch.float32, device="cuda")
            _, k, h, meta = chip_smoke._lookup_inputs(
                torch, rng.standard_normal((K, D)).astype(np.float32),
                1, K, rng)
        digest = hashlib.sha256()
        for t in (q, k, h, meta):
            digest.update(t.cpu().numpy().tobytes())
        if kn == "A":
            call = lambda: fused_lookup_cuda(  # noqa: E731
                q, k, h, meta, metric, gamma, 1000.0, -1, fold)
        else:
            call = lambda: knn_cuda(q, k, metric, gamma)  # noqa: E731
        outs = [t.cpu() for t in call()]
        try:
            times = chip_smoke.device_ms(torch, call, 20, "nn_kernel")
        except RuntimeError as e:          # the profiler lost its events
            print(f"case {i}: {e}", file=sys.stderr, flush=True)
            times = dict(device_ms=None, memset_ms=None,
                         launches_per_call=None)
        results.append(dict(outs=outs, inputs=digest.hexdigest(), **times))
    torch.save(results, out)


def bitwise_equal(torch, a, b) -> bool:
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def main() -> int:
    import torch
    if len(sys.argv) == 4 and sys.argv[1] == "--side":
        run_side(pathlib.Path(sys.argv[2]).resolve(),
                 pathlib.Path(sys.argv[3]))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_knn: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.knn.knn import _sm_count, _split_plan
    other = pathlib.Path(sys.argv[1]).resolve() / "src"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    runs = []
    for n, src in enumerate((other, ROOT / "src", ROOT / "src", other)):
        out = OUT_DIR / f"side{n}.pt"
        subprocess.run([sys.executable, __file__, "--side", str(src),
                        str(out)], check=True)
        runs.append(torch.load(out))
    n_sm = _sm_count(torch.device("cuda"))
    all_equal = True
    for i, (kn, Q, K, D, metric, gamma, fold, label) in enumerate(cases()):
        o0, t1, t2, o3 = (r[i] for r in runs)
        inputs_agree = len({r["inputs"] for r in (o0, t1, t2, o3)}) == 1
        equal = (inputs_agree and bitwise_equal(torch, t1["outs"], o0["outs"])
                 and bitwise_equal(torch, t1["outs"], t2["outs"]))
        plan = _split_plan(Q, K, D, n_sm)
        print(json.dumps(dict(
            kernel=kn, label=label, Q=Q, K=K, D=D, metric=metric,
            gamma=gamma, fold_repo=fold, q_tile=plan.q_tile,
            n_splits=plan.n_splits, q_stream=plan.q_stream,
            bitwise_equal=equal,
            other_device_ms=[o0["device_ms"], o3["device_ms"]],
            this_device_ms=[t1["device_ms"], t2["device_ms"]],
            this_memset_ms=t1["memset_ms"],
            this_launches_per_call=t1["launches_per_call"])), flush=True)
        all_equal &= equal
    print(json.dumps({"cases": len(cases()), "all_bitwise_equal": all_equal,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
