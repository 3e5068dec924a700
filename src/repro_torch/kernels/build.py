"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, loaded with ``ctypes``.
The libraries land in ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources and flags so an edited
source is rebuilt and an unchanged one is reused. Every source is compiled
by its own ``nvcc`` process, all started together.

Nothing here runs at import: ``LIBRARY.fn`` builds on first use, from the
launching wrapper, so a machine without ``nvcc`` can still import every
module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("knn.cu", "gains.cu", "flash.cu", "duel.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the launchers (every one returns its cudaError_t)
SIGNATURES = {
    "knn.cu": {
        "simcache_knn": [_P, _P, _I, _I, _I, _I, _F, _P, _P, _I, _I, _I,
                         _I, _P, _P],
        "simcache_fused_lookup": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                                  _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _P, _P],
    },
    "gains.cu": {
        "simcache_gains": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                           _P, _I, _I, _P],
        "simcache_greedy_gain": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                 _P, _I, _I, _P],
    },
    "flash.cu": {
        "simcache_flash_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               *[_L] * 12, _F, _I, _I, _P],
        "simcache_flash_tc_smem": [_I],
    },
    "duel.cu": {
        "simcache_duel_scan": [_P, _P, _I, _I, _I, _F, _P, _P, _P, _P, _I,
                               _I, *[_P] * 13, _I, _I, _F, _L, *[_P] * 7],
        "simcache_duel_rearm": [_P, _P, _I, _I, _I, _F, *[_P] * 9, _I, _I,
                                _I, *[_P] * 9],
    },
}


class KernelLibrary:
    """The loaded launchers, built on first use (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fns: dict[str, ctypes._CFuncPtr] | None = None
        self.build_seconds: float | None = None
        self.ptxas_log: str = ""           # ptxas -v, every source

    def _nvcc(self) -> str:
        nvcc = shutil.which("nvcc") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA kernels are built "
                               "from source on a machine with the CUDA "
                               "toolkit")
        return nvcc

    def path(self, src: str) -> pathlib.Path:
        """The library one source builds into (named by a hash of every
        source and the flags)."""
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in sorted(CSRC.iterdir()):
            h.update(f.name.encode())
            h.update(f.read_bytes())
        return BUILD_DIR / f"lib{src.split('.')[0]}-{h.hexdigest()[:16]}.so"

    def _build(self) -> dict:
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo, procs = {s: self.path(s) for s in SOURCES}, {}
        for src, out in todo.items():
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[src] = (subprocess.Popen(
                [self._nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out)
        logs = {src: p.communicate()[0] for src, (p, _, _) in procs.items()}
        for src, (p, tmp, out) in procs.items():
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{logs[src]}")
            out.with_suffix(".ptxas.log").write_text(logs[src])
            os.replace(tmp, out)               # atomic under parallel builds
        # each library's report, also where an earlier run built it
        reports = {src: out.with_suffix(".ptxas.log")
                   for src, out in todo.items()}
        self.ptxas_log = "\n".join(
            f"== {src}\n" + (r.read_text() if r.exists() else "(no report)")
            for src, r in reports.items())
        fns = {}
        for src, out in todo.items():
            lib = ctypes.CDLL(str(out))
            for name, argtypes in SIGNATURES[src].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
        self.build_seconds = time.perf_counter() - t0
        return fns

    def fn(self, name: str):
        with self._lock:
            if self._fns is None:
                self._fns = self._build()
        return self._fns[name]


LIBRARY = KernelLibrary()


def check(err: int, name: str) -> None:
    """Raise on a launcher's non-zero cudaError_t (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(t) -> int:
    """PyTorch's current stream on the tensor's device, as a pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
