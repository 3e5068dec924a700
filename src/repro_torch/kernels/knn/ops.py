"""Public lookup entries: ``nearest_approximizer``, ``fused_lookup`` and
the compressed and pruned variants in front of it.

Counterpart of ``repro.kernels.knn.ops``. On CUDA tensors each exact
entry launches its kernel (kernels/knn/knn.py); on CPU tensors it runs
the plain PyTorch version.
``quantized_fused_lookup`` and ``pruned_fused_lookup`` select candidate
rows in torch (the reference's are XLA, not Pallas) and rescore them
through ``fused_lookup``, i.e. kernel A on the card. The CUDA kernels
mask their ragged edges themselves, so they take unpadded inputs and no
kernel of the port uses ``_pad_axis`` or ``pad_for_knn``. Those two are
kept only to mirror the reference's padding contract (queries pad with
zeros, keys with repeats of key 0 so a pad never beats the genuine
entry, features with zeros), which tests/test_torch_lookup.py holds
against it.

The ``sharded_*`` entries are the data plane over a mesh
(launch/mesh.py): the key tensor, already padded to a multiple of the
shard count (``ref.pad_to_shards``), is cut into that many contiguous
balanced chunks, each chunk is scanned on its own with
``fold_repo=False`` (one launch of kernel A per shard on the card, in
turn on the tensors' device, with no host synchronization between
shards), and the per-shard minima, five scalars per query and shard, are
reduced by ``ref.reduce_shard_minima``, which folds the repository once.
Shards in concatenated order and first-minimum ties make the result
bitwise the unsharded lookup's at every shard count — what the
reference's ``shard_map`` does across devices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import quant
from repro_torch.kernels.knn.knn import _INF, fused_lookup_cuda, knn_cuda
from repro_torch.kernels.knn.lsh import (candidate_matrix, candidate_union,
                                         gather_candidate_rows,
                                         unscanned_h_bound)
from repro_torch.kernels.knn.ref import reduce_shard_minima
from repro_torch.kernels.quant import QuantizedRows
from repro_torch.tracecount import Signatures

LANE = 128
DEFAULT_TOP_T = 64        # quantized first pass: exact-rescore width
DEFAULT_QTILE = 8192      # quantized first pass: key-axis tile
_FUSED_SIGNATURES = Signatures("fused_lookup")
_QUANT_SIGNATURES = Signatures("quantized_fused_lookup")
_SHARDED_SIGNATURES = Signatures("sharded_fused_lookup")
_SHARDED_QUANT_SIGNATURES = Signatures("sharded_quantized_fused_lookup")
_SHARDED_PRUNED_SIGNATURES = Signatures("sharded_pruned_fused_lookup")
# scores one group of first-pass tiles holds at once (f32 elements)
_SELECT_GROUP_ELEMS = 1 << 24


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


def _signature(queries: torch.Tensor, tensors, *static) -> tuple:
    """The key a ``jax.jit`` cache entry would have: device, shapes,
    dtypes and static arguments."""
    return ((queries.device.type,)
            + tuple((tuple(t.shape), t.dtype) for t in tensors) + static)


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
    _FUSED_SIGNATURES.seen(_signature(
        queries, (queries, keys, h_key, meta), metric, float(gamma),
        float(h_repo), int(repo_level), bool(fold_repo)))
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


def mesh_axes_size(mesh, axes: tuple[str, ...]) -> int:
    """Product of the given mesh axis sizes — the shard count. The one
    definition shared by the sharded entries, SimCacheNetwork.n_shards,
    LookupShardPolicy.n_shards and DeviceInstance.n_shards, so the
    padding contract (key axis % shard count == 0) cannot drift between
    layout and dispatch."""
    n = 1
    for ax in axes:
        n *= mesh.shape[ax]
    return n


def shard_meta(meta: torch.Tensor, n_shards: int) -> torch.Tensor:
    """A shard-padded (4, K) meta regrouped into (n, 4, K/n), so that
    every shard's rows are contiguous, as kernel A reads them. The
    sharded entries take either form; a caller that looks up many
    batches keeps this one (SimCacheNetwork.sharded_meta)."""
    K = meta.shape[1]
    return meta.reshape(4, n_shards, K // n_shards).transpose(0, 1) \
        .contiguous()


def _shard_chunks(keys: torch.Tensor, h_key: torch.Tensor,
                  meta: torch.Tensor, n_shards: int) -> list[tuple]:
    """The ``n_shards`` contiguous balanced chunks (keys, h_key, meta) of
    a shard-padded layout. Key and h chunks are views; a (4, K) meta is
    regrouped by :func:`shard_meta`, an (n, 4, K/n) one is sliced."""
    K = keys.shape[0]
    if K % n_shards:
        raise ValueError(f"{K} keys do not divide into {n_shards} shards: "
                         "pad the layout first (ref.pad_to_shards)")
    S = K // n_shards
    if meta.dim() == 2:
        meta = shard_meta(meta, n_shards)
    h = h_key.reshape(-1)
    return [(keys[s * S:(s + 1) * S], h[s * S:(s + 1) * S], meta[s])
            for s in range(n_shards)]


def _reduce(parts: list[tuple], h_repo: float, repo_level: int) -> tuple:
    """Stack per-shard (cost, C_a, level, slot, payload) to (n, B) on the
    device and reduce them to the global winner."""
    stk = [torch.stack([p[i] for p in parts]) for i in range(5)]
    return reduce_shard_minima(*stk, h_repo=h_repo, repo_level=repo_level)


def sharded_fused_lookup(queries: torch.Tensor, keys: torch.Tensor,
                         h_key: torch.Tensor, meta: torch.Tensor, mesh,
                         axes: tuple[str, ...], metric: str = "l2",
                         gamma: float = 1.0, h_repo: float = 0.0,
                         repo_level: int = -1) -> tuple[torch.Tensor, ...]:
    """Sharded fused lookup: one :func:`fused_lookup` with
    ``fold_repo=False`` per contiguous key chunk (kernel A's shard-local
    entry on the card), then the lexicographic reduction. ``keys``,
    ``h_key`` and ``meta`` must already be padded so that the key axis
    divides the shard count, the product of the ``axes`` sizes of
    ``mesh`` (SimCacheNetwork.sharded_layout); ``meta`` is (4, K) or
    its :func:`shard_meta` regrouping. Returns (cost,
    approx_cost, level, slot, payload), bitwise the unsharded
    :func:`fused_lookup`'s.

    Each new signature bumps ``tracecount["sharded_fused_lookup"]`` once,
    as the reference's trace does."""
    axes = tuple(axes)
    _SHARDED_SIGNATURES.seen(_signature(
        queries, (queries, keys, h_key, meta), mesh, axes, metric,
        float(gamma), float(h_repo), int(repo_level)))
    chunks = _shard_chunks(keys, h_key, meta, mesh_axes_size(mesh, axes))
    parts = [fused_lookup(queries, k, h, m, metric=metric, gamma=gamma,
                          h_repo=h_repo, repo_level=repo_level,
                          fold_repo=False) for k, h, m in chunks]
    return _reduce(parts, h_repo, repo_level)


def _repo_only(queries: torch.Tensor, keys: torch.Tensor,
               h_key: torch.Tensor, meta: torch.Tensor, metric: str,
               gamma: float, h_repo: float, repo_level: int,
               fold_repo: bool) -> tuple[torch.Tensor, ...]:
    """The no-key lookup with a (B,) +INF bound: nothing is un-scanned."""
    out = fused_lookup(queries, keys, h_key, meta, metric=metric,
                       gamma=gamma, h_repo=h_repo, repo_level=repo_level,
                       fold_repo=fold_repo)
    return (*out, torch.full((queries.shape[0],), _INF, dtype=torch.float32,
                             device=queries.device))


def _quantized_select(queries: torch.Tensor, h_key: torch.Tensor,
                      valid: torch.Tensor, kq: QuantizedRows, top_t: int,
                      tile: int, metric: str, gamma: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compressed first pass: per-query top-T candidates and a sound
    bound.

    Scores every key with the certified lower bound lb_C_a + h
    (quant.lb_approx_cost_block over the int8 images; invalid keys +INF),
    tile by tile along the key axis, keeps each tile's T smallest, then
    the T smallest of those. Returns

        cand  (B, T) int64 — per query the T smallest scores' key rows
                             (−1 where the score is +INF), and
        vT    (B,)   f32   — the T-th smallest score per query.

    ``vT`` bounds every un-selected key's exact cost from below (a key
    cut in its tile scores ≥ that tile's T-th smallest, all T of which
    reach the merge; a key cut at the merge scores ≥ vT; every score is
    ≤ the exact cost), so ``cost < vT`` after the exact rescore proves
    the winner the full scan's. +INF when T covers every key.

    Both top-T steps are stable ascending sorts: equal scores keep the
    lower key first, as ``lax.top_k`` of the negated scores does. Tiles
    are scored in groups of up to ``_SELECT_GROUP_ELEMS`` scores (one
    matmul a group); a tile's scores and its top-T are the reference's
    tile's, since each tile is sorted on its own.
    """
    nq, dim = queries.shape
    dev = queries.device
    n_keys = kq.q.shape[0]
    T = min(top_t, n_keys)
    tile = max(T, min(tile, n_keys))
    qq, qs = quant.quantize_int8(queries.float())
    qd = quant.dequantize_int8(qq, qs)
    rq = quant.quant_row_radius(qs[:, 0], dim, metric)
    q_sq = (qd * qd).sum(dim=-1) if metric in ("l2", "l2sq") else None
    hv = h_key.float()
    nt = -(-n_keys // tile)
    group = max(1, _SELECT_GROUP_ELEMS // max(nq * tile, 1))
    vals, idxs = [], []
    for t0 in range(0, nt, group):
        a, b = t0 * tile, min(n_keys, (t0 + group) * tile)
        kd = quant.dequantize_int8(kq.q[a:b], kq.scale[a:b])
        lb = quant.lb_approx_cost_block(qd, kd, rq, kq.radius[a:b], metric,
                                        gamma, q_sq=q_sq,
                                        k_sq=kq.sq_norm[a:b])
        score = torch.where(valid[None, a:b], lb + hv[None, a:b],
                            torch.full_like(lb, _INF))
        g = -(-(b - a) // tile)
        pad = g * tile - (b - a)          # the last tile's zero padding
        if pad:
            score = torch.cat([score, torch.full((nq, pad), _INF,
                                                 device=dev)], dim=1)
        srt = torch.sort(score.reshape(nq, g, tile), dim=2, stable=True)
        vals.append(srt.values[:, :, :T].reshape(nq, g * T))
        off = a + tile * torch.arange(g, device=dev)[None, :, None]
        idxs.append((srt.indices[:, :, :T] + off).reshape(nq, g * T))
    vals, idxs = torch.cat(vals, dim=1), torch.cat(idxs, dim=1)
    srt = torch.sort(vals, dim=1, stable=True)
    v2 = srt.values[:, :T]
    cand = idxs.gather(1, srt.indices[:, :T])
    cand = torch.where(v2 < _INF, cand, torch.full_like(cand, -1))
    if T >= n_keys:
        return cand, torch.full((nq,), _INF, dtype=torch.float32, device=dev)
    return cand, v2[:, -1]


def _quant_union_cap(n_keys: int, nq: int, top_t: int) -> int:
    """Static batch-union capacity of the rescore gather: nq per-query
    top-T sets hold at most nq·T distinct rows, so this union never
    overflows (vT alone is the whole bound)."""
    return max(1, min(n_keys, nq * min(top_t, n_keys)))


def quantized_fused_lookup(queries: torch.Tensor, keys: torch.Tensor,
                           h_key: torch.Tensor, meta: torch.Tensor,
                           kq: QuantizedRows, top_t: int = DEFAULT_TOP_T,
                           tile: int = DEFAULT_QTILE, metric: str = "l2",
                           gamma: float = 1.0, h_repo: float = 0.0,
                           repo_level: int = -1, fold_repo: bool = True
                           ) -> tuple[torch.Tensor, ...]:
    """Compressed-first-pass variant of :func:`fused_lookup`.

    ``kq`` is the int8 image of ``keys`` (quant.quantize_rows over the
    same rows; SimCacheNetwork memoizes it). The certified-lower-bound
    first pass selects the top ``top_t`` candidates per query, their
    batch union is compacted ascending and rescored through
    :func:`fused_lookup` (kernel A). Returns (cost, approx_cost, level,
    slot, payload, bound) with ``bound`` the per-query (B,) certificate:
    ``cost < bound`` proves the result the exact scan's.

    Each new signature bumps ``tracecount["quantized_fused_lookup"]``
    once, as the reference's trace does.
    """
    _QUANT_SIGNATURES.seen(_signature(
        queries, (queries, keys, h_key, meta, kq.q), int(top_t), int(tile),
        metric, float(gamma), float(h_repo), int(repo_level),
        bool(fold_repo)))
    if keys.shape[0] == 0:          # no cache keys at all → repository
        return _repo_only(queries, keys, h_key, meta, metric, gamma, h_repo,
                          repo_level, fold_repo)
    cand, bound = _quantized_select(queries, h_key, meta[3, :] > 0, kq,
                                    top_t, tile, metric, gamma)
    cap = _quant_union_cap(keys.shape[0], queries.shape[0], top_t)
    kept, _ = candidate_union(cand, keys.shape[0], cap)
    gk, gh, gm = gather_candidate_rows(keys, h_key, meta, kept)
    out = fused_lookup(queries, gk, gh, gm, metric=metric, gamma=gamma,
                       h_repo=h_repo, repo_level=repo_level,
                       fold_repo=fold_repo)
    return (*out, bound)


def sharded_quantized_fused_lookup(queries: torch.Tensor,
                                   keys: torch.Tensor, h_key: torch.Tensor,
                                   meta: torch.Tensor, kq: QuantizedRows,
                                   mesh, axes: tuple[str, ...],
                                   top_t: int = DEFAULT_TOP_T,
                                   tile: int = DEFAULT_QTILE,
                                   metric: str = "l2", gamma: float = 1.0,
                                   h_repo: float = 0.0, repo_level: int = -1
                                   ) -> tuple[torch.Tensor, ...]:
    """Sharded compressed lookup. ``kq`` is the int8 image of the
    shard-padded key tensor; quantization is per row, so the chunks that
    cut ``keys`` cut it. Each shard runs the first pass and the exact
    rescore on its chunk (:func:`quantized_fused_lookup`,
    ``fold_repo=False``), the minima are reduced as in
    :func:`sharded_fused_lookup`, and the per-query bound is the min over
    the shards' vT: an un-scanned key lies in some shard and costs at
    least that shard's vT. Padding rows (valid 0, scale 0) score +INF and
    are never selected.

    Each new signature bumps
    ``tracecount["sharded_quantized_fused_lookup"]`` once."""
    axes = tuple(axes)
    _SHARDED_QUANT_SIGNATURES.seen(_signature(
        queries, (queries, keys, h_key, meta, kq.q), mesh, axes,
        int(top_t), int(tile), metric, float(gamma), float(h_repo),
        int(repo_level)))
    n = mesh_axes_size(mesh, axes)
    chunks = _shard_chunks(keys, h_key, meta, n)
    S = keys.shape[0] // n
    parts = [quantized_fused_lookup(
        queries, k, h, m,
        QuantizedRows(*(t[s * S:(s + 1) * S] for t in kq)), top_t=top_t,
        tile=tile, metric=metric, gamma=gamma, h_repo=h_repo,
        repo_level=repo_level, fold_repo=False)
        for s, (k, h, m) in enumerate(chunks)]
    bound = torch.stack([p[5] for p in parts]).min(dim=0).values
    return (*_reduce(parts, h_repo, repo_level), bound)


def pruned_fused_lookup(queries: torch.Tensor, keys: torch.Tensor,
                        h_key: torch.Tensor, meta: torch.Tensor,
                        proj: torch.Tensor, buckets: torch.Tensor,
                        kind: str = "lsh", n_probes: int = 1,
                        cap_union: int = 512, metric: str = "l2",
                        gamma: float = 1.0, h_repo: float = 0.0,
                        repo_level: int = -1, fold_repo: bool = True,
                        quantize: bool = False, top_t: int = DEFAULT_TOP_T
                        ) -> tuple[torch.Tensor, ...]:
    """LSH/k-means candidate pre-filter in front of :func:`fused_lookup`
    (see kernels/knn/lsh.py).

    The query batch is hashed against ``proj``/``buckets`` (one
    CandidatePolicy's tables over this key segment), the batch union of
    candidate rows is compacted into one ascending padded index tensor of
    size ``cap_union``, and :func:`fused_lookup` runs over only the
    gathered rows: same arithmetic, masking and tie-break order as the
    exact scan. Returns (cost, approx_cost, level, slot, payload, bound),
    ``bound`` the min h over valid un-scanned keys (+INF if none), a
    scalar.

    ``quantize=True`` composes the compressed first pass inside the
    union: the gathered rows are quantized on the fly, the top ``top_t``
    per query reach the exact rescore, and the bound becomes per query,
    min(the h bound, vT) — a key is either outside the union (exact cost
    ≥ its h) or cut by the first pass (exact cost ≥ vT). An ascending
    sub-selection of an ascending union keeps the tie-break order.
    """
    nq = queries.shape[0]
    if keys.shape[0] == 0:          # no cache keys at all → repository
        out = _repo_only(queries, keys, h_key, meta, metric, gamma, h_repo,
                         repo_level, fold_repo)
        return out if quantize else (*out[:5], torch.tensor(
            _INF, dtype=torch.float32, device=queries.device))
    cand = candidate_matrix(kind, proj, buckets, queries, n_probes)
    kept, kept_mask = candidate_union(cand, keys.shape[0], cap_union)
    gk, gh, gm = gather_candidate_rows(keys, h_key, meta, kept)
    bound = unscanned_h_bound(h_key, meta, kept_mask)
    if quantize:
        kq_u = quant.quantize_rows(gk, metric)
        cand2, vt = _quantized_select(queries, gh, gm[3, :] > 0, kq_u,
                                      top_t, DEFAULT_QTILE, metric, gamma)
        cap2 = _quant_union_cap(gk.shape[0], nq, top_t)
        kept2, _ = candidate_union(cand2, gk.shape[0], cap2)
        gk, gh, gm = gather_candidate_rows(gk, gh, gm, kept2)
        bound = torch.minimum(bound, vt)
    out = fused_lookup(queries, gk, gh, gm, metric=metric, gamma=gamma,
                       h_repo=h_repo, repo_level=repo_level,
                       fold_repo=fold_repo)
    return (*out, bound)


def sharded_pruned_fused_lookup(queries: torch.Tensor, keys: torch.Tensor,
                                h_key: torch.Tensor, meta: torch.Tensor,
                                proj_s: torch.Tensor,
                                buckets_s: torch.Tensor, mesh,
                                axes: tuple[str, ...], kind: str = "lsh",
                                n_probes: int = 1, cap_union: int = 512,
                                metric: str = "l2", gamma: float = 1.0,
                                h_repo: float = 0.0, repo_level: int = -1,
                                quantize: bool = False,
                                top_t: int = DEFAULT_TOP_T
                                ) -> tuple[torch.Tensor, ...]:
    """Sharded pruned lookup: shard s hashes the queries against its own
    tables ``proj_s[s]``/``buckets_s[s]`` (lsh.stack_shard_tables) and
    scans only its chunk's candidate union (:func:`pruned_fused_lookup`,
    ``fold_repo=False``; ``cap_union`` is resolved on the chunk size).
    The reduction and the tie-break order are untouched. The bound is the
    min over the shards' bounds — a scalar, or with ``quantize`` (the
    compressed first pass inside each shard's union) per query.

    Each new signature bumps
    ``tracecount["sharded_pruned_fused_lookup"]`` once."""
    axes = tuple(axes)
    _SHARDED_PRUNED_SIGNATURES.seen(_signature(
        queries, (queries, keys, h_key, meta, proj_s, buckets_s), mesh,
        axes, kind, int(n_probes), int(cap_union), metric, float(gamma),
        float(h_repo), int(repo_level), bool(quantize), int(top_t)))
    chunks = _shard_chunks(keys, h_key, meta, mesh_axes_size(mesh, axes))
    parts = [pruned_fused_lookup(
        queries, k, h, m, proj_s[s], buckets_s[s], kind=kind,
        n_probes=n_probes, cap_union=cap_union, metric=metric, gamma=gamma,
        h_repo=h_repo, repo_level=repo_level, fold_repo=False,
        quantize=quantize, top_t=top_t)
        for s, (k, h, m) in enumerate(chunks)]
    bounds = torch.stack([p[5] for p in parts])
    bound = bounds.min(dim=0).values if quantize else bounds.min()
    return (*_reduce(parts, h_repo, repo_level), bound)
