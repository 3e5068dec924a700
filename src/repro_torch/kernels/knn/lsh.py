"""LSH / k-means candidate pruning in front of the fused lookup.

Counterpart of ``repro.kernels.knn.lsh``. A :class:`CandidatePolicy`
(SimHash random-hyperplane tables with multi-probe, or k-means routing)
maps a query batch to a per-query candidate matrix of key rows; the batch
union of those candidates is compacted into one padded, *ascending* index
tensor, and kernel A runs over only the gathered rows. The ``meta`` rows
(level, slot, payload, valid) travel with each gathered key, and the
union is ascending, so the tie-break order is the full scan's.

The build side (:class:`SimHashPolicy`, :class:`KMeansPolicy`,
:func:`_fill_buckets`, :func:`stack_shard_tables`) is the reference's
host NumPy, copied line for line: the tables equal the reference's bit
for bit. The query side (:func:`candidate_matrix`,
:func:`candidate_union`, :func:`gather_candidate_rows`,
:func:`unscanned_h_bound`) is torch on the tables' device. Where the
reference sorts (``jnp.argsort`` for the least-confident bits,
``lax.top_k`` for the nearest centroids, both lower index first among
equal values), the port sorts stably, so ties break the same way.

Verifier contract (``verify=True``): a pruned lookup also returns a
bound, the minimum retrieval cost h over the valid keys it did *not*
scan (+INF when the union covered everything). Any un-scanned key costs
at least that, so a pruned result with ``cost < bound`` is the exact
winner; ``SimCacheNetwork`` re-scans every other query through the exact
path, which makes the verified result bit-identical to the exact fused
lookup by construction.

Tables are memoized next to the fused layout and dropped by
``SimCacheNetwork.invalidate_layout``; a pruned lookup against mutated
but not invalidated levels raises.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Protocol, runtime_checkable

import numpy as np
import torch

_INF = 3.0e38


@dataclasses.dataclass(frozen=True)
class CandidateTables:
    """Built lookup tables of one :class:`CandidatePolicy` over one key
    segment (the whole fused layout, or one shard's resident chunk).

    ``proj`` is (T, d, n_bits) hyperplane normals for SimHash, (C, d)
    centroids for k-means routing; ``buckets`` is (T, 2**n_bits, cap) /
    (C, cap) int32 member lists of segment-local key rows, −1-padded,
    each bucket's members in ascending row order. ``n_probes`` is the
    resolved multi-probe count (exact bucket + least-confident bit
    flips, or the n nearest centroids).
    """
    kind: str                 # "lsh" | "kmeans"
    proj: np.ndarray
    buckets: np.ndarray
    n_keys: int
    n_probes: int


@runtime_checkable
class CandidatePolicy(Protocol):
    """One interface in front of the fused kernel: build tables over a
    key segment, later hash query batches into candidate rows."""
    kind: ClassVar[str]
    seed: int

    def build(self, keys: np.ndarray, valid: np.ndarray) -> CandidateTables:
        ...

    def for_shard(self, shard: int) -> "CandidatePolicy":
        ...

    def resolve_cap(self, n_keys: int) -> int:
        ...


def _resolve_cap(max_candidates: int | None, n_keys: int) -> int:
    """Static capacity of the batch-union candidate tensor. Overflowing
    candidates (highest rows) are dropped — admissible, and accounted
    for by the verify bound, which treats dropped rows as un-scanned."""
    if max_candidates is not None:
        return max(1, min(n_keys, max_candidates))
    return max(1, min(n_keys, max(4096, n_keys // 4)))


def _bucket_cap_limit(bucket_cap: int, n_valid: int, n_buckets: int,
                      over: int = 8) -> int:
    """Per-bucket member capacity: ``over``× the mean load by default
    (≥ 16), so one hot bucket of duplicate keys can't inflate the whole
    dense (tables, buckets, cap) tensor to O(hottest·buckets). Members
    past the cap (highest rows, the fill is ascending) are dropped at
    build time — never candidates, i.e. "un-scanned" to the verify
    bound, which keeps ``verify=True`` exact regardless of skew.
    k-means passes a larger ``over``: Lloyd clusters skew naturally
    (dense regions get big clusters) where balanced hash buckets
    don't."""
    if bucket_cap:
        return bucket_cap
    return max(16, over * -(-n_valid // max(n_buckets, 1)))


def _fill_buckets(buckets: np.ndarray, codes: np.ndarray, vi: np.ndarray,
                  cap: int) -> None:
    """Fill one table's (n_buckets, cap) member lists from per-key
    bucket ``codes``; each bucket keeps its first ``cap`` members in
    ascending key order (stable sort over ascending ``vi``)."""
    order = np.argsort(codes, kind="stable")
    cs = codes[order]
    _, start, cnt = np.unique(cs, return_index=True, return_counts=True)
    rank = np.arange(cs.size) - np.repeat(start, cnt)
    keep = rank < cap
    buckets[cs[keep], rank[keep]] = vi[order][keep]


@dataclasses.dataclass(frozen=True)
class SimHashPolicy:
    """Random-hyperplane (SimHash) tables with multi-probe.

    ``n_bits=0`` resolves to log2(segment/32) clamped to [2, 16] (≈32
    keys per bucket); ``n_probes=0`` resolves to 1 + min(n_bits, 3):
    the exact bucket plus flips of the least-confident (smallest
    |margin|) bits, the standard multi-probe sequence.
    """
    kind: ClassVar[str] = "lsh"
    n_tables: int = 8
    n_bits: int = 0
    n_probes: int = 0
    bucket_cap: int = 0
    max_candidates: int | None = None
    seed: int = 0

    def for_shard(self, shard: int) -> "SimHashPolicy":
        return dataclasses.replace(self, seed=self.seed + shard + 1)

    def resolve_bits(self, n_keys: int) -> int:
        if self.n_bits:
            return self.n_bits
        return int(np.clip(round(np.log2(max(n_keys, 1) / 32.0)), 2, 16))

    def resolve_probes(self, n_bits: int) -> int:
        p = self.n_probes or 1 + min(n_bits, 3)
        return int(np.clip(p, 1, n_bits + 1))

    def resolve_cap(self, n_keys: int) -> int:
        return _resolve_cap(self.max_candidates, n_keys)

    def build(self, keys: np.ndarray, valid: np.ndarray) -> CandidateTables:
        keys = np.asarray(keys, np.float32)
        valid = np.asarray(valid, bool)
        n_keys, d = keys.shape
        bits = self.resolve_bits(n_keys)
        rng = np.random.default_rng(self.seed)
        planes = rng.standard_normal((self.n_tables, d, bits)) \
            .astype(np.float32)
        vi = np.nonzero(valid)[0].astype(np.int32)
        # per-table loop keeps the (n_valid, bits) margin temporary small
        codes = np.empty((self.n_tables, vi.size), np.int64)
        for t in range(self.n_tables):
            m = keys[vi] @ planes[t]                      # (n_valid, bits)
            codes[t] = ((m > 0).astype(np.int64)
                        << np.arange(bits)).sum(-1)
        cap = 1
        if vi.size:
            cap = max(int(np.bincount(codes[t], minlength=2 ** bits).max())
                      for t in range(self.n_tables))
            cap = min(cap, _bucket_cap_limit(self.bucket_cap, vi.size,
                                             2 ** bits))
        buckets = np.full((self.n_tables, 2 ** bits, cap), -1, np.int32)
        for t in range(self.n_tables):
            _fill_buckets(buckets[t], codes[t], vi, cap)
        return CandidateTables(kind=self.kind, proj=planes, buckets=buckets,
                               n_keys=n_keys,
                               n_probes=self.resolve_probes(bits))


@dataclasses.dataclass(frozen=True)
class KMeansPolicy:
    """k-means routing alternative: keys cluster under Lloyd's algorithm
    (fit on a subsample, all keys assigned once), a query probes the
    ``n_probes`` nearest centroids and scans their member lists.

    ``n_clusters=0`` resolves to √segment clamped to [4, 1024];
    ``n_probes=0`` to a quarter of the clusters clamped to [2, 64] (the
    generous default that keeps recall ≥ 0.99 on the paper's demands).
    """
    kind: ClassVar[str] = "kmeans"
    n_clusters: int = 0
    n_probes: int = 0
    n_iters: int = 10
    fit_sample: int = 20_000
    bucket_cap: int = 0
    max_candidates: int | None = None
    seed: int = 0

    def for_shard(self, shard: int) -> "KMeansPolicy":
        return dataclasses.replace(self, seed=self.seed + shard + 1)

    def resolve_clusters(self, n_keys: int) -> int:
        if self.n_clusters:
            return self.n_clusters
        return int(np.clip(round(np.sqrt(max(n_keys, 1))), 4, 1024))

    def resolve_probes(self, n_clusters: int) -> int:
        p = self.n_probes or int(np.clip(round(n_clusters / 4), 2, 64))
        return int(np.clip(p, 1, n_clusters))

    def resolve_cap(self, n_keys: int) -> int:
        return _resolve_cap(self.max_candidates, n_keys)

    def build(self, keys: np.ndarray, valid: np.ndarray) -> CandidateTables:
        keys = np.asarray(keys, np.float32)
        valid = np.asarray(valid, bool)
        n_keys, d = keys.shape
        C = self.resolve_clusters(n_keys)
        rng = np.random.default_rng(self.seed)
        vi = np.nonzero(valid)[0].astype(np.int32)
        if vi.size == 0:
            return CandidateTables(
                kind=self.kind, proj=np.zeros((C, d), np.float32),
                buckets=np.full((C, 1), -1, np.int32), n_keys=n_keys,
                n_probes=self.resolve_probes(C))
        x = keys[vi]
        sub = x[rng.choice(vi.size, min(vi.size, self.fit_sample),
                           replace=False)]
        cent = x[rng.choice(vi.size, C, replace=vi.size < C)].copy()
        for _ in range(self.n_iters):
            a = _nearest_centroid(sub, cent)
            for c in range(C):
                m = a == c
                if m.any():
                    cent[c] = sub[m].mean(axis=0)
        assign = _nearest_centroid(x, cent)
        cap = max(1, int(np.bincount(assign, minlength=C).max()))
        cap = min(cap, _bucket_cap_limit(self.bucket_cap, vi.size, C,
                                         over=16))
        buckets = np.full((C, cap), -1, np.int32)
        _fill_buckets(buckets, assign, vi, cap)
        return CandidateTables(kind=self.kind, proj=cent, buckets=buckets,
                               n_keys=n_keys, n_probes=self.resolve_probes(C))


def _nearest_centroid(x: np.ndarray, cent: np.ndarray,
                      chunk: int = 65_536) -> np.ndarray:
    """Chunked argmin over centroids: the (chunk, C) distance block caps
    build-time memory at ~chunk·C f32 however large the key segment."""
    c2 = (cent * cent).sum(-1)[None, :]
    out = np.empty(x.shape[0], np.int64)
    for s in range(0, x.shape[0], chunk):
        xs = x[s:s + chunk]
        d2 = (xs * xs).sum(-1)[:, None] + c2 - 2.0 * xs @ cent.T
        out[s:s + chunk] = np.argmin(d2, axis=1)
    return out


def default_policy(kind: str, seed: int = 0) -> CandidatePolicy:
    if kind == "lsh":
        return SimHashPolicy(seed=seed)
    if kind == "kmeans":
        return KMeansPolicy(seed=seed)
    raise ValueError(f"unknown candidate policy {kind!r} "
                     "(expected 'lsh' or 'kmeans')")


# ------------------------------------------------------------ query side
def candidate_matrix(kind: str, proj: torch.Tensor, buckets: torch.Tensor,
                     queries: torch.Tensor, n_probes: int) -> torch.Tensor:
    """(B, P) candidate rows per query, −1-padded.

    SimHash: per table, the query's own bucket plus ``n_probes − 1``
    buckets at Hamming distance 1, flipping the least-confident bits
    (smallest |margin|) first. k-means: the ``n_probes`` nearest
    centroids' member lists. Both orders are stable sorts: equal values
    keep the lower index first, as the reference's argsort and top_k do.
    """
    q = queries.float()
    if kind == "lsh":
        T, _, bits = proj.shape
        margins = torch.einsum("bd,tdh->bth", q, proj)     # (B, T, bits)
        weights = 1 << torch.arange(bits, dtype=torch.int64,
                                    device=q.device)
        code = ((margins > 0).long() * weights).sum(dim=-1)  # (B, T)
        if n_probes > 1:
            order = torch.argsort(margins.abs(), dim=-1,
                                  stable=True)            # least sure 1st
            flips = 1 << order[..., :n_probes - 1]
            codes = torch.cat([code[..., None], code[..., None] ^ flips],
                              dim=-1)
        else:
            codes = code[..., None]                        # (B, T, P)
        tt = torch.arange(T, device=q.device)[None, :, None]
        return buckets[tt, codes].reshape(q.shape[0], -1)
    if kind == "kmeans":
        d2 = ((q * q).sum(-1)[:, None] + (proj * proj).sum(-1)[None, :]
              - 2.0 * q @ proj.T)                          # (B, C)
        idx = torch.argsort(d2, dim=1, stable=True)[:, :n_probes]
        return buckets[idx].reshape(q.shape[0], -1)
    raise ValueError(kind)


def candidate_union(cand: torch.Tensor, n_keys: int, cap: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch union of (B, P) candidates → (``kept``, ``kept_mask``).

    ``kept`` (cap,) int64 holds the first ``cap`` distinct candidate rows
    in ascending order (the full scan's tie-break order), padded with
    ``n_keys``; ``kept_mask`` (K,) marks the rows that get scanned, so
    the verify bound counts everything else, overflow drops included, as
    un-scanned. The compaction is a cumulative-sum rank and a scatter,
    with no host synchronization."""
    dev = cand.device
    c = torch.where(cand >= 0, cand.long(),
                    torch.full_like(cand, n_keys, dtype=torch.int64))
    mask = torch.zeros((n_keys + 1,), dtype=torch.bool, device=dev)
    mask[c.reshape(-1)] = True
    mask[n_keys] = False
    rank = torch.cumsum(mask, dim=0) - 1
    # each kept row lands at its rank; every other row at the dump slot
    pos = torch.where(mask & (rank < cap), rank,
                      torch.full_like(rank, cap))
    kept = torch.full((cap + 1,), n_keys, dtype=torch.int64, device=dev)
    kept[pos] = torch.arange(n_keys + 1, device=dev)
    kept = kept[:cap]
    kept_mask = torch.zeros((n_keys + 1,), dtype=torch.bool, device=dev)
    kept_mask[kept] = True
    return kept, kept_mask[:n_keys]


def gather_candidate_rows(keys: torch.Tensor, h_key: torch.Tensor,
                          meta: torch.Tensor, kept: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Gather the kept rows of the segmented layout; the padding index
    ``n_keys`` resolves to an appended invalid row (valid = 0, payload =
    −1) that kernel A masks."""
    pad_key = keys.new_zeros((1, keys.shape[1]))
    pad_meta = torch.tensor([[0], [0], [-1], [0]], dtype=meta.dtype,
                            device=meta.device)
    keys_e = torch.cat([keys, pad_key])
    h_e = torch.cat([h_key.float(),
                     torch.zeros((1,), dtype=torch.float32,
                                 device=h_key.device)])
    meta_e = torch.cat([meta, pad_meta], dim=1)
    return keys_e[kept], h_e[kept], meta_e[:, kept]


def unscanned_h_bound(h_key: torch.Tensor, meta: torch.Tensor,
                      kept_mask: torch.Tensor) -> torch.Tensor:
    """Scalar verify bound: min h over valid keys *outside* the scanned
    union (+INF when it covered everything)."""
    outside = (meta[3, :] > 0) & ~kept_mask
    h = h_key.float()
    return torch.where(outside, h, torch.full_like(h, _INF)).min()


def stack_shard_tables(tables: list[CandidateTables]
                       ) -> tuple[np.ndarray, np.ndarray, int]:
    """Stack per-shard tables on a leading (n_shards, …) axis for
    shard_map, padding bucket capacities to the max with −1."""
    cap = max(t.buckets.shape[-1] for t in tables)
    padded = [np.concatenate(
        [t.buckets,
         np.full(t.buckets.shape[:-1] + (cap - t.buckets.shape[-1],), -1,
                 np.int32)], axis=-1) for t in tables]
    probes = {t.n_probes for t in tables}
    assert len(probes) == 1, "shards resolved different probe counts"
    return (np.stack([t.proj for t in tables]), np.stack(padded),
            probes.pop())
