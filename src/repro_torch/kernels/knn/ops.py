"""Public lookup entries: ``nearest_approximizer`` and ``fused_lookup``.

Counterpart of the exact parts of ``repro.kernels.knn.ops``. On CUDA
tensors each entry launches its kernel (kernels/knn/knn.py); on CPU
tensors it runs the plain PyTorch version. The CUDA kernels mask their
ragged edges themselves, so they take unpadded inputs and no kernel of
the port uses ``_pad_axis`` or ``pad_for_knn``. Those two are kept only
to mirror the reference's padding contract (queries pad with zeros, keys
with repeats of key 0 so a pad never beats the genuine entry, features
with zeros), which tests/test_torch_lookup.py holds against it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.knn.knn import _INF, fused_lookup_cuda, knn_cuda
from repro_torch.tracecount import Signatures

LANE = 128
_FUSED_SIGNATURES = Signatures("fused_lookup")


def _pad_axis(x: torch.Tensor, mult: int, axis: int,
              mode: str) -> torch.Tensor:
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    if mode == "zero":
        shape = list(x.shape)
        shape[axis] = pad
        return torch.cat([x, x.new_zeros(shape)], dim=axis)
    if mode == "repeat_first":
        first = x.narrow(axis, 0, 1)
        reps = [pad if a == axis else 1 for a in range(x.dim())]
        return torch.cat([x, first.repeat(*reps)], dim=axis)
    raise ValueError(mode)


def pad_for_knn(queries: torch.Tensor, keys: torch.Tensor, bq: int,
                bk: int) -> tuple[torch.Tensor, torch.Tensor]:
    queries = _pad_axis(_pad_axis(queries, LANE, 1, "zero"), bq, 0, "zero")
    keys = _pad_axis(_pad_axis(keys, LANE, 1, "zero"), bk, 0,
                     "repeat_first")
    return queries, keys


def nearest_approximizer(queries: torch.Tensor, keys: torch.Tensor,
                         metric: str = "l2", gamma: float = 1.0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """min_k C_a(q, key_k) and the argmin index, per query (kernel B)."""
    return knn_cuda(queries, keys, metric, gamma)


def fused_lookup(queries: torch.Tensor, keys: torch.Tensor,
                 h_key: torch.Tensor, meta: torch.Tensor,
                 metric: str = "l2", gamma: float = 1.0,
                 h_repo: float = 0.0, repo_level: int = -1,
                 fold_repo: bool = True) -> tuple[torch.Tensor, ...]:
    """Network-wide nearest-approximizer query, fused (kernel A).

    ``keys`` (K, d) concatenates every cache level's stored embeddings;
    ``h_key`` (K,) the per-key retrieval cost; ``meta`` (4, K) i32 rows
    (level, slot, payload, valid). Returns per query, over all keys and
    the repository, (cost, approx_cost, level, slot, payload) — eq. (1)
    as one kernel launch. ``fold_repo=False`` returns the segment-local
    minimum only; with no valid key (+INF, 0, repo_level, 0, −1).

    Each new signature (the shapes, dtypes and static arguments a
    ``jax.jit`` cache entry would key on) bumps
    ``tracecount["fused_lookup"]`` once, where the reference's trace
    does.
    """
    _FUSED_SIGNATURES.seen(
        (queries.device.type,)
        + tuple((tuple(t.shape), t.dtype) for t in (queries, keys, h_key,
                                                    meta))
        + (metric, float(gamma), float(h_repo), int(repo_level),
           bool(fold_repo)))
    nq, dev = queries.shape[0], queries.device
    if keys.shape[0] == 0:          # no cache keys at all → repository
        cost0 = h_repo if fold_repo else _INF
        return (torch.full((nq,), cost0, dtype=torch.float32, device=dev),
                torch.zeros((nq,), dtype=torch.float32, device=dev),
                torch.full((nq,), repo_level, dtype=torch.int32, device=dev),
                torch.zeros((nq,), dtype=torch.int32, device=dev),
                torch.full((nq,), -1, dtype=torch.int32, device=dev))
    return fused_lookup_cuda(queries, keys, h_key.reshape(-1), meta,
                             metric=metric, gamma=gamma, h_repo=h_repo,
                             repo_level=repo_level, fold_repo=fold_repo)
