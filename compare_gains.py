#!/usr/bin/env python3
"""Hold this checkout's gain kernels (C and D) against another revision's,
bit for bit, and time both on one card.

    mkdir -p build/other && git archive <rev> | tar -x -C build/other
    python3 compare_gains.py build/other

Each side runs in a process of its own with only its own ``src/`` on the
path, through its public wrappers ``gains_cuda`` and ``gain_cuda``
(whose signatures every revision keeps), and builds its kernels into its
own ``build/kernels/``. So any revision of the port can be compared,
whatever its C interface. The sides run in the order other, this, this,
other; each writes its outputs and device times to ``build/compare/``.

Cases: the engine's first GREEDY seed (R = O = 10⁵ catalog rows, D 100,
Zipf(0.8) λ, cur = 1000, H = (0, 15, 150)), the stream phase's catalog
(R = O = 20,000), R = O = 16,385 (just past ``CA_MATERIALIZE_MAX``, where
an instance stops materializing C_a), a ragged R 333 × O 257 × D 13,
D 19 (the 4-byte staging path), I 2 and 3, J 1 and 8, l1, l2sq, γ 0.5,
H with ``H_SENTINEL`` entries, D 1000 (the streamed candidate tile),
kernel D's per-request H rows with off-path rows, and J 9, 17 and 32
(past the 8 caches a launch holds: the wrappers run groups of 8 caches;
a revision whose wrappers refuse more than 8 is run here on the same
groups of H's columns, one call each). The inputs are made
from seeds in each process and their hash must agree across the runs.
Every output of this side must be bitwise equal to the other side's and
to its own second run; each side's device time per call is from
torch.profiler (``chip_smoke.device_ms``). One JSON line per case, then a
summary line; exits 1 on any difference, 2 without a card. A time the
profiler returned no events for is printed as null.
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
SENTINEL = 1.0e30


def cases():
    """(kernel, R, O, D, I, J, metric, gamma, inputs, label); inputs is
    "engine" (catalog rows, x = y, the engine's λ, cur and H), "stream"
    (the stream phase's catalog), "random", "sentinel" (random, some H
    entries at the sentinel) or "offpath" (kernel D, whole H rows off
    the path)."""
    out = [(kn, 100_000, 100_000, 100, 1, 3, "l2", 1.0, "engine",
            "engine seed") for kn in ("C", "D")]
    out += [(kn, 20_000, 20_000, 100, 1, 3, "l2", 1.0, "stream",
             "stream catalog") for kn in ("C", "D")]
    out += [(kn, 16_385, 16_385, 100, 1, 3, "l2", 1.0, "engine",
             "past CA_MATERIALIZE_MAX") for kn in ("C", "D")]
    for kn in ("C", "D"):
        out += [(kn, 333, 257, 13, 1, 3, "l2", 1.0, "random", "ragged"),
                (kn, 777, 301, 19, 1, 3, "l2", 1.0, "random",
                 "4-byte staging"),
                (kn, 2000, 3000, 100, 1, 1, "l2", 1.0, "random", "J 1"),
                (kn, 2000, 3000, 100, 1, 8, "l2", 1.0, "random", "J 8"),
                (kn, 2000, 3000, 100, 1, 3, "l1", 1.0, "random", "metric"),
                (kn, 2000, 3000, 100, 1, 3, "l2sq", 1.0, "random",
                 "metric"),
                (kn, 2000, 3000, 100, 1, 3, "l2", 0.5, "random", "gamma"),
                (kn, 500, 700, 1000, 1, 3, "l2", 1.0, "random",
                 "streamed candidates")]
    out += [("C", 2000, 3000, 100, I, J, "l2", 1.0, "random", "ingresses")
            for I, J in ((2, 3), (3, 5), (3, 8))]
    out += [("C", 2000, 3000, 100, 3, 4, "l2", 1.0, "sentinel",
             "H_SENTINEL entries"),
            ("D", 2000, 3000, 100, 1, 4, "l2", 1.0, "offpath",
             "off-path rows")]
    out += [("C", 2000, 3000, 100, 2, J, "l2", 1.0, "sentinel",
             "past 8 caches") for J in (9, 17, 32)]
    out += [("D", 2000, 3000, 100, 1, 9, "l2", 1.0, "offpath",
             "past 8 caches")]
    return out


def j_groups(J):
    """Groups of at most 8 cache columns, in order."""
    return [(a, min(J, a + 8)) for a in range(0, J, 8)]


def _inputs(torch, case, i, engine, stream):
    """x, y, lam, cur, H of one case on the card (kernel C's shapes:
    lam, cur (I, R), H (I, J); kernel D's: (R,), (R,), (R, J))."""
    kn, R, O, D, I, J, _, _, kind, _ = case
    dev = torch.device("cuda")
    rng = np.random.default_rng(i)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa
    if kind in ("engine", "stream"):
        coords, lam_row = engine if kind == "engine" else stream
        x = f32(coords[:R])
        y = x if O == R else f32(coords[:O])
        lam = f32(lam_row[:R])[None]
        cur = torch.full_like(lam, 1000.0)
        H = f32([[0.0, 15.0, 150.0]])
    else:
        x = f32(rng.standard_normal((R, D)))
        y = f32(rng.standard_normal((O, D)))
        lam = f32(rng.random((I, R)))
        cur = f32(rng.random((I, R)) * 6)
        H = f32(rng.random((R if kn == "D" else I, J)))
        if kind == "sentinel":
            H[rng.random(H.shape) < 0.3] = SENTINEL
        if kind == "offpath":
            H[::5] = SENTINEL
        if kn == "D":
            return x, y, lam[0], cur[0], H
        return x, y, lam, cur, H
    if kn == "D":
        return x, y, lam[0], cur[0], H.expand(R, J).contiguous()
    return x, y, lam, cur, H


def run_side(src: pathlib.Path, out: pathlib.Path) -> None:
    """One side: every case through the wrappers of the ``repro_torch``
    under ``src``; outputs, input hashes and device times to ``out``."""
    import chip_smoke                      # puts this checkout's src first
    sys.path.insert(0, str(src))
    import torch

    import repro_torch
    from repro_torch.core import catalog as catalog_api
    from repro_torch.core import demand as demand_api
    from repro_torch.kernels.gain.gain import gain_cuda
    from repro_torch.kernels.knn.gains import gains_cuda
    assert pathlib.Path(repro_torch.__file__).resolve().is_relative_to(src)
    cat = catalog_api.embedding_catalog(n=100_000, dim=100, seed=0)
    engine = cat.coords, demand_api.zipf(cat, alpha=0.8, seed=0).lam[0]
    scat = catalog_api.embedding_catalog(n=20_000, dim=100, seed=1)
    stream = scat.coords, demand_api.zipf(scat, alpha=1.0, seed=1).lam[0]
    results = []
    for i, case in enumerate(cases()):
        kn, R, O = case[:3]
        metric, gamma = case[6], case[7]
        x, y, lam, cur, H = _inputs(torch, case, i, engine, stream)
        digest = hashlib.sha256()
        for t in (x, y, lam, cur, H):
            digest.update(t.cpu().numpy().tobytes())
        fn = gains_cuda if kn == "C" else gain_cuda
        call = lambda: fn(x, y, lam, cur, H, metric, gamma)  # noqa: E731
        try:
            first = call()
        except ValueError:              # a revision holding ≤ 8 caches
            groups = [H[:, a:b].contiguous() for a, b in j_groups(H.shape[1])]
            call = lambda: torch.cat([  # noqa: E731
                fn(x, y, lam, cur, h, metric, gamma) for h in groups])
            first = call()
        outs = [first.cpu()]
        iters = 3 if R * O >= 10 ** 9 else 20
        try:
            times = chip_smoke.device_ms(torch, call, iters, "gains_kernel")
        except RuntimeError as e:          # the profiler lost its events
            print(f"case {i}: {e}", file=sys.stderr, flush=True)
            times = dict(device_ms=None, launches_per_call=None)
        results.append(dict(outs=outs, inputs=digest.hexdigest(),
                            device_ms=times["device_ms"],
                            launches_per_call=times["launches_per_call"]))
        del x, y, lam, cur, H
        torch.cuda.empty_cache()
    torch.save(results, out)


def bitwise_equal(torch, a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


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
        print("compare_gains: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.knn.gains import J_GROUP, _gain_plan
    other = pathlib.Path(sys.argv[1]).resolve() / "src"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    runs = []
    for n, src in enumerate((other, ROOT / "src", ROOT / "src", other)):
        out = OUT_DIR / f"gains_side{n}.pt"
        subprocess.run([sys.executable, __file__, "--side", str(src),
                        str(out)], check=True)
        runs.append(torch.load(out))
    all_equal = True
    for i, case in enumerate(cases()):
        kn, R, O, D, I, J, metric, gamma, kind, label = case
        o0, t1, t2, o3 = (r[i] for r in runs)
        inputs_agree = len({r["inputs"] for r in (o0, t1, t2, o3)}) == 1
        equal = (inputs_agree and bitwise_equal(torch, t1["outs"], o0["outs"])
                 and bitwise_equal(torch, t1["outs"], t2["outs"]))
        plan = _gain_plan(O, D, I, min(J, J_GROUP), kn == "D")
        print(json.dumps(dict(
            kernel=kn, label=label, R=R, O=O, D=D, I=I, J=J, metric=metric,
            gamma=gamma, inputs=kind, y_stream=plan.y_stream,
            j_width=plan.j_width, j_groups=len(j_groups(J)),
            bitwise_equal=equal,
            other_device_ms=[o0["device_ms"], o3["device_ms"]],
            this_device_ms=[t1["device_ms"], t2["device_ms"]],
            this_launches_per_call=t1["launches_per_call"])), flush=True)
        all_equal &= equal
    print(json.dumps({"cases": len(cases()), "all_bitwise_equal": all_equal,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
