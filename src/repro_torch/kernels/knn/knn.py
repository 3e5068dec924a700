"""Nearest-approximizer lookup kernels: wrappers of kernels A and B.

Kernel A (:func:`fused_lookup_cuda`) is the fused segmented 1-NN over
every cache level at once — per query, min over valid keys of
C_a(q, k)^γ + h(level(k)), with the repository folded in as a virtual
key on a strict ``<``. It replaces the Pallas TPU kernel
``repro/kernels/knn/knn.py::_fused_kernel`` and runs on every served
batch. Kernel B (:func:`knn_cuda`) is the plain blocked 1-NN (min C_a^γ
and its lowest argmin), replacing ``_knn_kernel``; it serves the looped
per-level lookup (``SimCacheNetwork.lookup`` with ``fused=False``).

The CUDA sources are ``kernels/csrc/knn.cu`` (design notes there: one
block per query tile walks every key tile in key order, keeps a running
(cost, index) per query with a strict ``<`` and reduces lanes
lexicographically, so ties break to the lowest index; ``meta`` is
gathered at the argmin). Bound on the card: the 2·Q·K·D-flop fp32
distance tile.

Each wrapper launches its kernel for CUDA tensors and raises on what it
cannot take; for CPU tensors it runs the plain PyTorch version
(kernels/knn/ref.py). ``launches`` on each wrapper counts kernel
launches, and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LIBRARY, check, stream_ptr
from repro_torch.kernels.knn.ref import fused_lookup_ref, knn_ref

METRIC_IDS = {"l1": 0, "l2": 1, "l2sq": 2}
_INF = 3.0e38


def _contig_f32(t: torch.Tensor, name: str, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    return t.to(torch.float32).contiguous()


def _metric_id(metric: str) -> int:
    if metric not in METRIC_IDS:
        raise ValueError(f"unknown metric {metric!r}")
    return METRIC_IDS[metric]


def knn_cuda(queries: torch.Tensor, keys: torch.Tensor, metric: str = "l2",
             gamma: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B: per query (min C_a^γ, lowest argmin) as (Q,) f32 and (Q,)
    i32. Plain version for CPU tensors: :func:`knn_ref`."""
    if not queries.is_cuda:
        return knn_ref(queries, keys, metric, gamma)
    dev = queries.device
    q = _contig_f32(queries, "queries", dev)
    k = _contig_f32(keys, "keys", dev)
    if q.dim() != 2 or k.dim() != 2 or q.shape[1] != k.shape[1]:
        raise ValueError(f"shapes {tuple(q.shape)} and {tuple(k.shape)}")
    Q, D = q.shape
    K = k.shape[0]
    if K == 0:
        raise ValueError("knn_cuda needs at least one key")
    cost = torch.empty((Q,), dtype=torch.float32, device=dev)
    idx = torch.empty((Q,), dtype=torch.int32, device=dev)
    if Q == 0:
        return cost, idx
    check(LIBRARY.fn("simcache_knn")(
        q.data_ptr(), k.data_ptr(), Q, K, D, _metric_id(metric),
        float(gamma), cost.data_ptr(), idx.data_ptr(), stream_ptr(q)),
        "simcache_knn")
    knn_cuda.launches += 1
    return cost, idx


knn_cuda.launches = 0


def fused_lookup_cuda(queries: torch.Tensor, keys: torch.Tensor,
                      h_key: torch.Tensor, meta: torch.Tensor,
                      metric: str = "l2", gamma: float = 1.0,
                      h_repo: float = 0.0, repo_level: int = -1,
                      fold_repo: bool = True) -> tuple[torch.Tensor, ...]:
    """Kernel A: the fused multi-level lookup. ``keys`` (K, D), ``h_key``
    (K,) f32, ``meta`` (4, K) i32 rows (level, slot, payload, valid).
    Returns per query (cost, approx_cost, level, slot, payload). Plain
    version for CPU tensors: :func:`fused_lookup_ref`."""
    if not queries.is_cuda:
        return fused_lookup_ref(queries, keys, h_key, meta, metric=metric,
                                gamma=gamma, h_repo=h_repo,
                                repo_level=repo_level, fold_repo=fold_repo)
    dev = queries.device
    q = _contig_f32(queries, "queries", dev)
    k = _contig_f32(keys, "keys", dev)
    hk = _contig_f32(h_key.reshape(-1), "h_key", dev)
    if meta.device != dev:
        raise ValueError(f"meta is on {meta.device}, expected {dev}")
    m = meta.to(torch.int32).contiguous()
    Q, D = q.shape
    K = k.shape[0]
    if K == 0 or k.shape[1] != D or hk.shape != (K,) or m.shape != (4, K):
        raise ValueError(f"bad lookup shapes: q {tuple(q.shape)}, keys "
                         f"{tuple(k.shape)}, h_key {tuple(hk.shape)}, "
                         f"meta {tuple(m.shape)}")
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    cost, ca = torch.empty((Q,), **f32), torch.empty((Q,), **f32)
    lvl, slot, pay = (torch.empty((Q,), **i32) for _ in range(3))
    if Q == 0:
        return cost, ca, lvl, slot, pay
    check(LIBRARY.fn("simcache_fused_lookup")(
        q.data_ptr(), k.data_ptr(), hk.data_ptr(), m.data_ptr(), Q, K, D,
        _metric_id(metric), float(gamma), float(h_repo), int(repo_level),
        int(bool(fold_repo)), cost.data_ptr(), ca.data_ptr(),
        lvl.data_ptr(), slot.data_ptr(), pay.data_ptr(), stream_ptr(q)),
        "simcache_fused_lookup")
    fused_lookup_cuda.launches += 1
    return cost, ca, lvl, slot, pay


fused_lookup_cuda.launches = 0
