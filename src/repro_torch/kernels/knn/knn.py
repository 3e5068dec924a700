"""Nearest-approximizer lookup kernels: wrappers of kernels A and B.

Kernel A (:func:`fused_lookup_cuda`) is the fused segmented 1-NN over
every cache level at once — per query, min over valid keys of
C_a(q, k)^γ + h(level(k)), with the repository folded in as a virtual
key on a strict ``<``. It replaces the Pallas TPU kernel
``repro/kernels/knn/knn.py::_fused_kernel`` and runs on every served
batch. Kernel B (:func:`knn_cuda`) is the plain blocked 1-NN (min C_a^γ
and its lowest argmin), replacing ``_knn_kernel``; it serves the looped
per-level lookup (``SimCacheNetwork.lookup`` with ``fused=False``).
Bound on the card: the 2·Q·K·D-operation fp32 distance tile.

Both are one CUDA template, ``nn_kernel`` in ``kernels/csrc/knn.cu``
(design notes there). In short: a block owns a tile of queries (64, or 8
for small batches) resident in shared memory and walks a contiguous range
of 128-key tiles, staged through a ring of ``cp.async`` copies (rows too
wide for a resident tile, D above about 5,500, stream the query tile
through the same ring chunk by chunk instead); each
thread keeps a 4 × 8 (or 1 × 4) register tile of pair accumulators, each
pair one ascending fp32 chain, so every output is bitwise independent of
the tiling; a running (cost, C_a, index) per query with a strict ``<``
and a lexicographic warp-shuffle reduction break ties to the lowest
index; ``meta`` is gathered at the winner.

**The split plan.** :func:`_split_plan` cuts the key axis into
``n_splits`` contiguous ranges of whole key tiles (split s covers tiles
[s·n_kt // S, (s+1)·n_kt // S), the formula the kernel uses), so that a
large K runs about two blocks per SM, and a small K (the engine's 448)
runs one split. The plan depends on (Q, K, D, SM count) alone and is
memoized, as is the SM count, so a served batch pays no search for it.
With several splits each block writes its split's
(cost, C_a, index) per query to a **workspace** (``torch.empty``,
3·S·Q + n_query_tiles int32: three (S, Q) planes, then one arrival
counter per query tile that the launcher zeroes on the call's stream;
each call has its own, so two streams never share one), and the last
block of a query tile to arrive merges the splits in split order — the
reference's ``reduce_shard_minima``, whose plain version is
``ref.sharded_fused_lookup_ref``. Still one launch per call.

**Staging paths.** Rows whose address is 16-byte aligned with D % 4 == 0
(the engine's D = 100) are staged by 16-byte copies; any other (D 3, 19,
37, or a key view 4 bytes off) by 4-byte copies inside the same kernel.
Nothing is copied on the host for it.

Each wrapper launches its kernel for CUDA tensors and raises on what it
cannot take; for CPU tensors it runs the plain PyTorch version
(kernels/knn/ref.py). ``launches`` on each wrapper counts kernel
launches, and nothing else.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.build import LIBRARY, check, stream_ptr
from repro_torch.kernels.knn.ref import fused_lookup_ref, knn_ref

METRIC_IDS = {"l1": 0, "l2": 1, "l2sq": 2}
_INF = 3.0e38

# the kernel's shape constants (kernels/csrc/knn.cu)
Q_TILES = (64, 8)         # query tiles of the resident instantiations
STREAM_Q_TILES = (8,)     # ... and of the streamed one (wide rows)
KEY_TILE = 128            # keys per tile
D_CHUNK = 32              # features per staged chunk
KEY_STRIDE = D_CHUNK + 4  # key row stride in shared memory (floats)
STAGES = 3                # key chunks in the cp.async ring
SMEM_LIMIT = 232_448      # dynamic shared memory a block may use (H100)
MIN_SPLIT_TILES = 4       # a split walks at least this many key tiles
BLOCKS_PER_SM = 2         # blocks of either tile one SM holds at once
# relative time of one block's 128-key tile at two blocks per SM, from
# compare_knn.py on an H100 80GB HBM3 at 700 W: 0.0203 ms for the 64-query
# tile (kernel A, Q 256, K 65,536: 0.1576 ms over 7.76 tiles a block),
# 0.0087 ms for the 8-query tile (kernel B, Q 256, K 4096: 0.0348 ms over
# 4 tiles a block)
TILE_COST = {64: 2.3, 8: 1.0}


def _smem_bytes(q_tile: int, D: int, q_stream: bool = False) -> int:
    """Dynamic shared memory of one block: the query tile (resident, D
    rounded up to whole chunks; or, streamed, one chunk per ring stage),
    the key ring, |q|² and |k|²."""
    qs = (STAGES * D_CHUNK if q_stream
          else max(1, -(-D // D_CHUNK)) * D_CHUNK)
    return 4 * (q_tile * qs + STAGES * KEY_TILE * KEY_STRIDE + q_tile
                + KEY_TILE)


class SplitPlan(NamedTuple):
    """How one call is cut: the query tile, the number of key splits,
    and whether the query tile streams through the key ring."""
    q_tile: int
    n_splits: int
    K: int
    q_stream: bool = False

    def ranges(self) -> list[tuple[int, int]]:
        """Each split's key range [start, end), in split order."""
        n_kt = -(-self.K // KEY_TILE)
        S = self.n_splits
        return [(s * n_kt // S * KEY_TILE,
                 min(self.K, (s + 1) * n_kt // S * KEY_TILE))
                for s in range(S)]


@functools.lru_cache(maxsize=None)
def _split_plan(Q: int, K: int, D: int, n_sm: int) -> SplitPlan:
    """The query tile and key splits for a (Q, K, D) call on a card with
    ``n_sm`` SMs. For each query tile whose resident tile fits in shared
    memory, the splits are as many as one wave of BLOCKS_PER_SM·n_sm
    blocks allows, each at least MIN_SPLIT_TILES key tiles long (so one
    split at the engine's K = 448); the tile taken is the one whose waves
    × key tiles per block × TILE_COST is least (the 64-query tile on a
    tie). Where no resident tile fits, the streamed 8-query tile, which
    fits at any D, is cut the same way."""
    n_kt = -(-K // KEY_TILE)
    slots = BLOCKS_PER_SM * n_sm
    for q_stream, tiles in ((False, Q_TILES), (True, STREAM_Q_TILES)):
        best = None
        for q_tile in tiles:
            if _smem_bytes(q_tile, D, q_stream) > SMEM_LIMIT:
                continue
            n_qt = -(-Q // q_tile)
            n_splits = max(1, min(slots // n_qt, n_kt // MIN_SPLIT_TILES))
            waves = -(-n_qt * n_splits // slots)
            cost = waves * -(-n_kt // n_splits) * TILE_COST[q_tile]
            if best is None or cost < best[0]:
                best = (cost, SplitPlan(q_tile, n_splits, K, q_stream))
        if best is not None:
            return best[1]
    raise AssertionError("a streamed query tile always fits")


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch_plan(q: torch.Tensor, k: torch.Tensor
                 ) -> tuple[SplitPlan, int, torch.Tensor | None]:
    """The plan, the staging path (1: 16-byte copies) and the workspace
    (None for one split) of a call on the card."""
    Q, D = q.shape
    plan = _split_plan(Q, k.shape[0], D, _sm_count(q.device))
    vec16 = int(D % 4 == 0 and q.data_ptr() % 16 == 0
                and k.data_ptr() % 16 == 0)
    ws = None
    if plan.n_splits > 1:
        n_qt = -(-Q // plan.q_tile)
        ws = torch.empty((3 * plan.n_splits * Q + n_qt,), dtype=torch.int32,
                         device=q.device)
    return plan, vec16, ws


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
    plan, vec16, ws = _launch_plan(q, k)
    check(LIBRARY.fn("simcache_knn")(
        q.data_ptr(), k.data_ptr(), Q, K, D, _metric_id(metric),
        float(gamma), cost.data_ptr(), idx.data_ptr(), plan.q_tile,
        plan.n_splits, int(plan.q_stream), vec16,
        0 if ws is None else ws.data_ptr(), stream_ptr(q)), "simcache_knn")
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
    plan, vec16, ws = _launch_plan(q, k)
    check(LIBRARY.fn("simcache_fused_lookup")(
        q.data_ptr(), k.data_ptr(), hk.data_ptr(), m.data_ptr(), Q, K, D,
        _metric_id(metric), float(gamma), float(h_repo), int(repo_level),
        int(bool(fold_repo)), cost.data_ptr(), ca.data_ptr(),
        lvl.data_ptr(), slot.data_ptr(), pay.data_ptr(), plan.q_tile,
        plan.n_splits, int(plan.q_stream), vec16,
        0 if ws is None else ws.data_ptr(), stream_ptr(q)), "simcache_fused_lookup")
    fused_lookup_cuda.launches += 1
    return cost, ca, lvl, slot, pay


fused_lookup_cuda.launches = 0
