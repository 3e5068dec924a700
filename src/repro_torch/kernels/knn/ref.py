"""Plain PyTorch versions of the lookup and gain kernels.

Counterpart of ``repro.kernels.knn.ref``. Same semantics as the CUDA
kernels (kernels/knn/knn.py, kernels/knn/gains.py): per query the minimum
dissimilarity cost d(q, k)^γ and the argmin key index, ties broken toward
the lowest index (``torch.argmin`` keeps the first minimum). These are
what the wrappers run for tensors on the CPU, and what the kernels are
held against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.costs import approx_cost, approx_cost_from_distance

_INF = 3.0e38


def _dense_ca(queries: torch.Tensor, keys: torch.Tensor, metric: str,
              gamma: float) -> torch.Tensor:
    """Dense (Q, K) approximation-cost matrix C_a = d(q, k)^γ in f32, in
    the matmul form of ``core.costs.approx_cost`` (l2 clamped at 0 before
    the root) that the kernels compute."""
    return approx_cost(queries.float(), keys.float(), metric, gamma)


def _pair_ca(queries: torch.Tensor, keys: torch.Tensor, metric: str,
             gamma: float, block: int = 1 << 26) -> torch.Tensor:
    """:func:`_dense_ca` with each pair's dot product summed on its own
    (an elementwise product reduced over the feature axis, in query
    blocks of at most ``block`` elements). A plain matmul on the CPU sums
    a small batch (one row, or a few rows against many keys) in another
    order than a large one, which broke the engine's bucketed ≡
    unbucketed contract on the lookup's plain version; on CPU tensors
    this reduction follows only D, so a pair's value depends on neither
    the batch it came in nor the keys beside it. On the card, where the
    engine runs the kernels and never this version, a ``sum(-1)`` is
    not promised to be shape-independent (see
    ``core.costs.pairwise_distance_stable``)."""
    if metric == "l1":          # elementwise |q − k| sums: already per pair
        return _dense_ca(queries, keys, metric, gamma)
    q, k = queries.float(), keys.float()
    rows = max(1, block // max(k.shape[0] * k.shape[1], 1))
    dot = torch.cat([(q[s:s + rows, None, :] * k[None]).sum(-1)
                     for s in range(0, q.shape[0], rows)]) \
        if q.shape[0] else q.new_zeros((0, k.shape[0]))
    d2 = ((q * q).sum(-1)[:, None] + (k * k).sum(-1)[None, :]
          - 2.0 * dot).clamp_min(0.0)
    return approx_cost_from_distance(d2 if metric == "l2sq" else d2.sqrt(),
                                     gamma)


def knn_ref(queries: torch.Tensor, keys: torch.Tensor, metric: str = "l2",
            gamma: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel B: (min C_a per query, its argmin)."""
    cost = _pair_ca(queries, keys, metric, gamma)
    idx = torch.argmin(cost, dim=1).to(torch.int32)
    return cost.min(dim=1).values, idx


def placement_gains_ref(x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor,
                        cur: torch.Tensor, hreq: torch.Tensor,
                        metric: str = "l2", gamma: float = 1.0
                        ) -> torch.Tensor:
    """Oracle of the placement gains, materializing the (I, R, O, J) slack
    tensor — small instances only. Returns the (O, J) gains

        gain[o', j] = Σ_i Σ_r λ[i, r]·relu(cur[i, r] − C_a(x_r, y_o')
                                            − H[i, j])
    """
    ca = _dense_ca(x, y, metric, gamma)
    slack = (cur[:, :, None, None] - ca[None, :, :, None]
             - hreq[:, None, None, :])                       # (I, R, O, J)
    slack = torch.where(torch.isnan(slack), -torch.inf, slack)
    return (lam[:, :, None, None].float()
            * slack.clamp_min(0.0)).sum(dim=(0, 1))


def fused_lookup_ref(queries: torch.Tensor, keys: torch.Tensor,
                     h_key: torch.Tensor, meta: torch.Tensor,
                     metric: str = "l2", gamma: float = 1.0,
                     h_repo: float = 0.0, repo_level: int = -1,
                     fold_repo: bool = True) -> tuple[torch.Tensor, ...]:
    """Plain version of kernel A, the fused multi-level lookup.

    Invalid keys (meta row 3 == 0) are masked to +INF before the min; the
    repository wins only on strict improvement; ties among keys break to
    the lowest concatenated index. ``fold_repo=False`` returns the
    segment-local minimum, (+INF, 0, repo_level, 0, −1) when no valid key
    exists. Returns (cost, approx_cost, level, slot, payload).
    """
    ca = _pair_ca(queries, keys, metric, gamma)
    valid = (meta[3, :] > 0)[None, :]
    cost = torch.where(valid, ca + h_key[None, :].float(),
                       torch.full_like(ca, _INF))
    best = torch.argmin(cost, dim=1)
    bcost = cost.gather(1, best[:, None])[:, 0]
    rows = torch.arange(queries.shape[0], device=queries.device)
    bca = torch.where(valid[0, best], ca[rows, best],
                      torch.zeros_like(bcost))
    use_repo = (h_repo < bcost) if fold_repo else (bcost >= _INF)
    rcost = torch.full_like(bcost, h_repo) if fold_repo else bcost
    i32 = torch.int32
    return (torch.where(use_repo, rcost, bcost),
            torch.where(use_repo, torch.zeros_like(bca), bca),
            torch.where(use_repo, repo_level, meta[0, best]).to(i32),
            torch.where(use_repo, 0, meta[1, best]).to(i32),
            torch.where(use_repo, -1, meta[2, best]).to(i32))


def pad_to_shards(keys: torch.Tensor, h_key: torch.Tensor,
                  meta: torch.Tensor, n_shards: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad the segmented key tensor so the key axis divides ``n_shards``.

    Padding keys are all-zero with h == 0, valid == 0 and payload == −1,
    so they are masked and contiguous balanced chunks never perturb a
    distance."""
    pad = (-keys.shape[0]) % n_shards
    if pad:
        keys = torch.cat([keys, keys.new_zeros((pad, keys.shape[1]))])
        h_key = torch.cat([h_key, h_key.new_zeros((pad,))])
        mpad = meta.new_zeros((4, pad))
        mpad[2] = -1
        meta = torch.cat([meta, mpad], dim=1)
    return keys, h_key, meta


def reduce_shard_minima(cost_s: torch.Tensor, ca_s: torch.Tensor,
                        lvl_s: torch.Tensor, slot_s: torch.Tensor,
                        pay_s: torch.Tensor, h_repo: float,
                        repo_level: int = -1, fold_repo: bool = True
                        ) -> tuple[torch.Tensor, ...]:
    """Reduce per-shard (n_shards, B) lookup minima to the global winner.

    Lexicographic: the minimum cost, ties to the lowest shard
    (``torch.argmin`` keeps the first minimum). Shards are contiguous
    chunks of the concatenated key tensor in order, so (shard, index in
    shard) order is concatenated-index order and the tie-break equals the
    unsharded lookup's. The repository is folded once here, on a strict
    ``<``, never inside a shard; ``fold_repo=False`` leaves it out (the
    shards' own no-key result, (+INF, 0, repo_level, 0, −1), then stands).
    This is the plain version of kernel A's and B's cross-split merge."""
    best = torch.argmin(cost_s, dim=0)
    take = lambda x: x.gather(0, best[None, :])[0]     # noqa: E731
    bcost, bca = take(cost_s), take(ca_s)
    blvl, bslot, bpay = take(lvl_s), take(slot_s), take(pay_s)
    i32 = torch.int32
    if not fold_repo:
        return bcost, bca, blvl.to(i32), bslot.to(i32), bpay.to(i32)
    use_repo = h_repo < bcost
    return (torch.where(use_repo, torch.full_like(bcost, h_repo), bcost),
            torch.where(use_repo, torch.zeros_like(bca), bca),
            torch.where(use_repo, repo_level, blvl).to(i32),
            torch.where(use_repo, 0, bslot).to(i32),
            torch.where(use_repo, -1, bpay).to(i32))


def sharded_fused_lookup_ref(queries: torch.Tensor, keys: torch.Tensor,
                             h_key: torch.Tensor, meta: torch.Tensor,
                             n_shards: int, metric: str = "l2",
                             gamma: float = 1.0, h_repo: float = 0.0,
                             repo_level: int = -1, fold_repo: bool = True
                             ) -> tuple[torch.Tensor, ...]:
    """The fused lookup over ``n_shards`` contiguous balanced chunks of
    the (padded) key tensor: each chunk's minimum with ``fold_repo=False``,
    then :func:`reduce_shard_minima`. It equals :func:`fused_lookup_ref`
    bit for bit at every shard count."""
    keys, h_key, meta = pad_to_shards(keys, h_key, meta, n_shards)
    S = keys.shape[0] // n_shards
    parts = [fused_lookup_ref(
        queries, keys[s * S:(s + 1) * S], h_key[s * S:(s + 1) * S],
        meta[:, s * S:(s + 1) * S], metric=metric, gamma=gamma,
        h_repo=h_repo, repo_level=repo_level, fold_repo=False)
        for s in range(n_shards)]
    stk = [torch.stack([p[i] for p in parts]) for i in range(5)]
    return reduce_shard_minima(*stk, h_repo=h_repo, repo_level=repo_level,
                               fold_repo=fold_repo)


def pruned_fused_lookup_ref(queries: torch.Tensor, keys: torch.Tensor,
                            h_key: torch.Tensor, meta: torch.Tensor,
                            tables, cap_union: int, metric: str = "l2",
                            gamma: float = 1.0, h_repo: float = 0.0,
                            repo_level: int = -1, fold_repo: bool = True
                            ) -> tuple[torch.Tensor, ...]:
    """Oracle of ops.pruned_fused_lookup: the same candidate hashing,
    union and row gather (kernels/knn/lsh.py), the scan through
    :func:`fused_lookup_ref`. ``tables`` is a lsh.CandidateTables.
    Returns (cost, approx_cost, level, slot, payload, bound)."""
    from repro_torch.kernels.knn.lsh import (candidate_matrix,
                                             candidate_union,
                                             gather_candidate_rows,
                                             unscanned_h_bound)
    if keys.shape[0] == 0:
        out = fused_lookup_ref(queries, keys, h_key, meta, metric=metric,
                               gamma=gamma, h_repo=h_repo,
                               repo_level=repo_level, fold_repo=fold_repo)
        return (*out, torch.tensor(_INF, dtype=torch.float32,
                                   device=queries.device))
    dev = keys.device
    cand = candidate_matrix(tables.kind, torch.as_tensor(tables.proj,
                                                         device=dev),
                            torch.as_tensor(tables.buckets, device=dev),
                            queries, tables.n_probes)
    kept, kept_mask = candidate_union(cand, keys.shape[0], cap_union)
    gk, gh, gm = gather_candidate_rows(keys, h_key, meta, kept)
    out = fused_lookup_ref(queries, gk, gh, gm, metric=metric, gamma=gamma,
                           h_repo=h_repo, repo_level=repo_level,
                           fold_repo=fold_repo)
    return (*out, unscanned_h_bound(h_key, meta, kept_mask))


def sharded_pruned_fused_lookup_ref(queries: torch.Tensor,
                                    keys: torch.Tensor, h_key: torch.Tensor,
                                    meta: torch.Tensor, tables: list,
                                    cap_union: int, metric: str = "l2",
                                    gamma: float = 1.0, h_repo: float = 0.0,
                                    repo_level: int = -1
                                    ) -> tuple[torch.Tensor, ...]:
    """Mesh-free oracle of ops.sharded_pruned_fused_lookup: the (padded)
    key tensor in ``len(tables)`` contiguous balanced chunks, each pruned
    with its own tables (``fold_repo=False``), :func:`reduce_shard_minima`,
    and the min of the shards' un-scanned-h bounds."""
    n_shards = len(tables)
    keys, h_key, meta = pad_to_shards(keys, h_key, meta, n_shards)
    S = keys.shape[0] // n_shards
    parts = [pruned_fused_lookup_ref(
        queries, keys[s * S:(s + 1) * S], h_key[s * S:(s + 1) * S],
        meta[:, s * S:(s + 1) * S], tables[s], cap_union, metric=metric,
        gamma=gamma, h_repo=h_repo, repo_level=repo_level,
        fold_repo=False) for s in range(n_shards)]
    stk = [torch.stack([p[i] for p in parts]) for i in range(5)]
    red = reduce_shard_minima(*stk, h_repo=h_repo, repo_level=repo_level)
    return (*red, torch.stack([p[5] for p in parts]).min())


def quantized_fused_lookup_ref(queries: torch.Tensor, keys: torch.Tensor,
                               h_key: torch.Tensor, meta: torch.Tensor,
                               kq=None, top_t: int = 64,
                               metric: str = "l2", gamma: float = 1.0,
                               h_repo: float = 0.0, repo_level: int = -1,
                               fold_repo: bool = True
                               ) -> tuple[torch.Tensor, ...]:
    """Oracle of ops.quantized_fused_lookup: the same first-pass
    selection (one tile over every key) and union gather, the exact
    rescore through :func:`fused_lookup_ref`. ``kq``
    (quant.quantize_rows of ``keys``) is built when omitted. Returns
    (cost, approx_cost, level, slot, payload, bound), the bound (B,)."""
    from repro_torch.kernels import quant
    from repro_torch.kernels.knn.lsh import (candidate_union,
                                             gather_candidate_rows)
    from repro_torch.kernels.knn.ops import (_quant_union_cap,
                                             _quantized_select)
    nq = queries.shape[0]
    if keys.shape[0] == 0:
        out = fused_lookup_ref(queries, keys, h_key, meta, metric=metric,
                               gamma=gamma, h_repo=h_repo,
                               repo_level=repo_level, fold_repo=fold_repo)
        return (*out, torch.full((nq,), _INF, dtype=torch.float32,
                                 device=queries.device))
    if kq is None:
        kq = quant.quantize_rows(keys.float(), metric)
    cand, bound = _quantized_select(queries.float(), h_key, meta[3, :] > 0,
                                    kq, top_t, keys.shape[0], metric, gamma)
    kept, _ = candidate_union(cand, keys.shape[0],
                              _quant_union_cap(keys.shape[0], nq, top_t))
    gk, gh, gm = gather_candidate_rows(keys, h_key, meta, kept)
    out = fused_lookup_ref(queries, gk, gh, gm, metric=metric, gamma=gamma,
                           h_repo=h_repo, repo_level=repo_level,
                           fold_repo=fold_repo)
    return (*out, bound)


def sharded_quantized_fused_lookup_ref(queries: torch.Tensor,
                                       keys: torch.Tensor,
                                       h_key: torch.Tensor,
                                       meta: torch.Tensor, n_shards: int,
                                       top_t: int = 64, metric: str = "l2",
                                       gamma: float = 1.0,
                                       h_repo: float = 0.0,
                                       repo_level: int = -1
                                       ) -> tuple[torch.Tensor, ...]:
    """Mesh-free oracle of ops.sharded_quantized_fused_lookup: the padded
    key tensor in ``n_shards`` chunks, the compressed lookup per chunk
    (``fold_repo=False``; per-row quantization makes a chunk's int8 image
    the chunk of the whole image), :func:`reduce_shard_minima`, and the
    per-query min of the shards' vT bounds."""
    keys, h_key, meta = pad_to_shards(keys, h_key, meta, n_shards)
    S = keys.shape[0] // n_shards
    parts = [quantized_fused_lookup_ref(
        queries, keys[s * S:(s + 1) * S], h_key[s * S:(s + 1) * S],
        meta[:, s * S:(s + 1) * S], top_t=top_t, metric=metric,
        gamma=gamma, h_repo=h_repo, repo_level=repo_level,
        fold_repo=False) for s in range(n_shards)]
    stk = [torch.stack([p[i] for p in parts]) for i in range(5)]
    red = reduce_shard_minima(*stk, h_repo=h_repo, repo_level=repo_level)
    return (*red, torch.stack([p[5] for p in parts]).min(dim=0).values)
