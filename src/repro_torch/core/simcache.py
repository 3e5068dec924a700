"""Runtime similarity-cache network: lookup → forward → serve.

Counterpart of ``repro.core.simcache``: the *online data plane* for an
allocation produced by the placement algorithms. A
:class:`SimCacheNetwork` holds, per cache level, the stored object
embeddings ("keys") and payload ids ("values").

``lookup`` realizes eq. (1): every request is served by the approximizer
minimizing C_a(o, o') + h(i, j) over the caches on its path plus the
repository. The default (``fused=True``) path concatenates every level's
keys into one segmented tensor with per-key cost offsets and answers the
network-wide query with a *single* launch of kernel A (the repository
rides along as a virtual key). ``fused=False`` keeps the per-level probe
(one launch of kernel B per level, minima compared centrally) as the
differential twin; the two serve identical traffic.

``lookup(prune="lsh"|"kmeans")`` puts a candidate pre-filter
(kernels/knn/lsh.py) in front of the fused scan: the batch is hashed
against memoized SimHash / k-means tables, the batch union of candidate
rows is gathered, and kernel A runs over only those rows.
``lookup(quantize=True)`` scores every key (or every gathered row, with
``prune``) by a certified int8 lower bound and rescores each query's
``top_t`` best through kernel A. ``verify=True`` re-scans every query
whose cost reaches the returned bound through the exact fused path, which
makes the result bit-identical to the exact lookup by construction; the
network counts those re-scans (``rescan_calls``, ``rescan_queries``).
Tables and the int8 image are memoized next to the layout; unlike the
plain fused path, a pruned or quantized lookup against mutated but not
invalidated ``levels`` raises.

``sharded=True`` (with a ``mesh``, launch/mesh.py) is the sharded
variant of the fused path: :meth:`sharded_layout` pads the segmented
tensor so that the key axis divides the shard count, the key axis is
cut into contiguous balanced chunks along ``shard_axes``, each chunk is
scanned on its own (kernel A with ``fold_repo=False``, one launch per
shard, in turn on the keys' device), and the per-shard minima are
reduced lexicographically with the repository folded once, bitwise the
fused lookup. Pruned and quantized lookups shard the same way, with
per-shard candidate tables (``policy.for_shard(s)``) and the int8 image
of the padded layout; their verifier re-scans through the sharded path.
:meth:`invalidate_layout` drops the sharded layouts with the rest.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import quant
from repro_torch.kernels.knn import (DEFAULT_TOP_T, default_policy,
                                     fused_lookup, mesh_axes_size,
                                     nearest_approximizer, pad_to_shards,
                                     pruned_fused_lookup,
                                     quantized_fused_lookup, shard_meta,
                                     sharded_fused_lookup,
                                     sharded_pruned_fused_lookup,
                                     sharded_quantized_fused_lookup,
                                     stack_shard_tables)

REPO_LEVEL = -1

# Empty-level sentinel coordinate: far enough that a sentinel can never
# undercut the repository, small enough that its squared l2 distance
# (~1e30) stays finite in f32. The fused kernel also masks sentinel keys
# explicitly via the valid flag, so it never relies on magnitude.
SENTINEL_COORD = 1e15


@dataclasses.dataclass
class CacheLevel:
    keys: torch.Tensor        # (k_j, d) stored object embeddings
    values: torch.Tensor      # (k_j,) payload ids (int32)
    h: float                  # retrieval cost from the ingress


@dataclasses.dataclass
class LookupResult:
    level: torch.Tensor       # (B,) serving level per request (−1 = repo)
    slot: torch.Tensor        # (B,) slot within level (undefined for repo)
    payload: torch.Tensor     # (B,) payload id (−1 for repo)
    cost: torch.Tensor        # (B,) total C(r, A) incurred
    approx_cost: torch.Tensor  # (B,) C_a component only
    hit: torch.Tensor         # (B,) bool, served by some cache


@dataclasses.dataclass
class SimCacheNetwork:
    """A chain of similarity caches in front of a repository (model).

    ``sharded=True`` serves lookups through the sharded fused path:
    ``mesh`` must be set, and the key axis is cut over ``shard_axes``
    (default: every mesh axis, in order).
    """
    levels: list[CacheLevel]
    h_repo: float
    metric: str = "l2"
    gamma: float = 1.0
    fused: bool = True
    sharded: bool = False
    mesh: object | None = None
    shard_axes: tuple[str, ...] | None = None
    # CandidatePolicy override, used only when its ``kind`` matches the
    # ``prune=`` argument of lookup(); other kinds fall back to
    # kernels.knn.lsh.default_policy
    candidate_policy: object | None = None
    _layout: tuple | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _layout_fp: tuple | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _sharded_layout: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    _tables: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    # verify=True's exact re-scans: launches of the exact path, queries
    rescan_calls: int = dataclasses.field(default=0, init=False,
                                          compare=False)
    rescan_queries: int = dataclasses.field(default=0, init=False,
                                            compare=False)

    def __post_init__(self):
        if self.sharded and self.mesh is None:
            raise ValueError("sharded=True requires a mesh")

    @classmethod
    def from_placement(cls, coords: np.ndarray, slots: np.ndarray,
                       slot_cache: np.ndarray, hs: Sequence[float],
                       h_repo: float, metric: str = "l2",
                       gamma: float = 1.0, fused: bool = True,
                       device: str | torch.device | None = None,
                       candidate_policy: object | None = None,
                       sharded: bool = False, mesh: object | None = None,
                       shard_axes: tuple[str, ...] | None = None
                       ) -> "SimCacheNetwork":
        """Build the runtime network from a placement-algorithm output on
        ``device`` (CUDA unless named). ``slots``/``slot_cache`` are the
        flat allocation of objective.Instance; payload id = object id."""
        dev = resolve_device(device)
        levels = []
        for j, h in enumerate(hs):
            idx = slots[slot_cache == j]
            idx = idx[idx >= 0]
            if idx.size == 0:           # empty cache level still valid
                keys = np.full((1, coords.shape[1]), SENTINEL_COORD,
                               np.float32)     # unreachable sentinel key
                vals = np.full((1,), -1, np.int32)
            else:
                keys = coords[idx].astype(np.float32)
                vals = idx.astype(np.int32)
            levels.append(CacheLevel(keys=torch.as_tensor(keys, device=dev),
                                     values=torch.as_tensor(vals,
                                                            device=dev),
                                     h=float(h)))
        return cls(levels=levels, h_repo=float(h_repo), metric=metric,
                   gamma=gamma, fused=fused, sharded=sharded, mesh=mesh,
                   shard_axes=shard_axes, candidate_policy=candidate_policy)

    # ------------------------------------------------------- fused layout
    def fused_layout(self) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
        """Concatenated (keys, h_key, meta) over all levels, memoized.

        ``meta`` is (4, ΣK_j) i32 with rows (level, slot, payload,
        valid); sentinel entries of empty levels keep payload == −1 and
        valid == 0 so the kernel masks them explicitly. Mutating
        ``levels`` after the first lookup requires
        :meth:`invalidate_layout`, or the fused path keeps serving the
        stale concatenation.
        """
        if self._layout is None:
            dev = (self.levels[0].keys.device if self.levels
                   else torch.device("cpu"))
            keys, h_key, metas = [], [], []
            for j, lv in enumerate(self.levels):
                kj = lv.keys.shape[0]
                vals = lv.values.to(torch.int32)
                keys.append(lv.keys.float())
                h_key.append(torch.full((kj,), lv.h, dtype=torch.float32,
                                        device=dev))
                metas.append(torch.stack([
                    torch.full((kj,), j, dtype=torch.int32, device=dev),
                    torch.arange(kj, dtype=torch.int32, device=dev),
                    vals, (vals >= 0).to(torch.int32)]))
            d = self.levels[0].keys.shape[1] if self.levels else 1
            cat = (torch.cat(keys) if keys
                   else torch.zeros((0, d), dtype=torch.float32))
            hk = (torch.cat(h_key) if h_key
                  else torch.zeros((0,), dtype=torch.float32))
            mt = (torch.cat(metas, 1) if metas
                  else torch.zeros((4, 0), dtype=torch.int32))
            self._layout = (cat, hk, mt)
            self._layout_fp = self._levels_fingerprint()
        return self._layout

    # ----------------------------------------------------- sharded layout
    def resolved_shard_axes(self) -> tuple[str, ...]:
        """Mesh axes the key axis shards over (default: all, in order)."""
        if self.shard_axes is not None:
            return tuple(self.shard_axes)
        return tuple(self.mesh.axis_names)

    def n_shards(self) -> int:
        return mesh_axes_size(self.mesh, self.resolved_shard_axes())

    def sharded_layout(self, n_shards: int) -> tuple[torch.Tensor,
                                                     torch.Tensor,
                                                     torch.Tensor]:
        """The fused layout padded so that the key axis divides
        ``n_shards`` (ref.pad_to_shards: all-zero keys with valid 0 and
        payload −1, masked by kernel A), so shards are equal contiguous
        chunks of the level-ordered concatenation. Memoized per shard
        count, under the same :meth:`invalidate_layout` contract."""
        return self._sharded(n_shards)[:3]

    def sharded_meta(self, n_shards: int) -> torch.Tensor:
        """:meth:`sharded_layout`'s meta regrouped per shard, (n, 4,
        K/n) (ops.shard_meta), memoized with it: what the sharded
        lookups take, so a lookup only slices it."""
        return self._sharded(n_shards)[3]

    def _sharded(self, n_shards: int) -> tuple:
        if n_shards not in self._sharded_layout:
            keys, h_key, meta = pad_to_shards(*self.fused_layout(),
                                              n_shards)
            self._sharded_layout[n_shards] = (
                keys, h_key, meta, shard_meta(meta, n_shards))
        return self._sharded_layout[n_shards]

    def invalidate_layout(self) -> None:
        """Drop the memoized fused and sharded layouts (and the candidate
        tables and int8 images built from them) after mutating
        ``levels``."""
        self._layout = None
        self._layout_fp = None
        self._sharded_layout = {}
        self._tables = {}

    def _levels_fingerprint(self) -> tuple:
        """Identity of the current ``levels`` content: the tensor objects
        themselves (strong references, compared with ``is``) plus the h
        costs, so a mutation not followed by :meth:`invalidate_layout`
        can be detected."""
        return tuple((lv.keys, lv.values, float(lv.h))
                     for lv in self.levels)

    @staticmethod
    def _fingerprints_match(a: tuple | None, b: tuple) -> bool:
        return a is not None and len(a) == len(b) and all(
            ak is bk and av is bv and ah == bh
            for (ak, av, ah), (bk, bv, bh) in zip(a, b))

    def _check_layout_fresh(self) -> None:
        """Raise when the memoized layout no longer matches ``levels``:
        the pruned and quantized lookups run it before indexing tables
        built from the layout."""
        if self._layout is not None and not self._fingerprints_match(
                self._layout_fp, self._levels_fingerprint()):
            raise RuntimeError(
                "stale candidate tables: `levels` were mutated after the "
                "fused layout (and the LSH/k-means tables indexing it) "
                "were built — call invalidate_layout() before a pruned "
                "lookup. The un-pruned paths serve the stale layout "
                "verbatim; pruning refuses, rather than returning "
                "candidates into a layout that no longer exists.")

    # -------------------------------------------------- candidate tables
    def _resolve_policy(self, prune: str):
        pol = self.candidate_policy
        if pol is not None and getattr(pol, "kind", None) == prune:
            return pol
        return default_policy(prune)

    def _tables_for(self, policy, n_shards: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Memoized (proj, buckets, n_probes) of one policy, built on the
        host and moved to the keys' device: over the fused layout
        (``n_shards == 0``), or per contiguous chunk of the sharded
        layout from ``policy.for_shard(s)``, stacked on a leading shard
        axis (lsh.stack_shard_tables). Dropped by
        :meth:`invalidate_layout`."""
        memo_key = (policy, n_shards)
        if memo_key not in self._tables:
            if n_shards == 0:
                keys, _, meta = self.fused_layout()
                t = policy.build(keys.cpu().numpy(),
                                 meta[3].cpu().numpy() > 0)
                proj, buckets, n_probes = t.proj, t.buckets, t.n_probes
            else:
                keys, _, meta = self.sharded_layout(n_shards)
                keys_np = keys.cpu().numpy()
                valid_np = meta[3].cpu().numpy() > 0
                S = keys_np.shape[0] // n_shards
                proj, buckets, n_probes = stack_shard_tables([
                    policy.for_shard(s).build(keys_np[s * S:(s + 1) * S],
                                              valid_np[s * S:(s + 1) * S])
                    for s in range(n_shards)])
            self._tables[memo_key] = (
                torch.as_tensor(proj, device=keys.device),
                torch.as_tensor(buckets, device=keys.device), n_probes)
        return self._tables[memo_key]

    def _quant_rows(self, n_shards: int = 0) -> quant.QuantizedRows:
        """Memoized int8 image (quant.QuantizedRows) of the fused
        (``n_shards == 0``) or sharded key rows, dropped with the layouts
        by :meth:`invalidate_layout`. All-zero padding rows quantize to
        scale 0 and stay masked by their valid flag."""
        memo_key = ("quant_rows", n_shards)
        if memo_key not in self._tables:
            keys = (self.fused_layout() if n_shards == 0
                    else self.sharded_layout(n_shards))[0]
            self._tables[memo_key] = quant.quantize_rows(keys, self.metric)
        return self._tables[memo_key]

    # ------------------------------------------------------------ lookup
    def lookup(self, queries: torch.Tensor, prune: str | None = None,
               verify: bool = False, quantize: bool = False,
               top_t: int | None = None) -> LookupResult:
        """Serve a batch of query embeddings (B, d) per eq. (1).

        Sharded (``sharded=True`` and a mesh): one launch of kernel A per
        key shard and the cross-shard reduction, bitwise the fused path.
        Fused (default): one launch of kernel A over every level's keys.
        Looped (``fused=False``): one launch of kernel B per level and a
        central argmin, the differential twin.
        Pruned (``prune="lsh"|"kmeans"``): the candidate pre-filter in
        front of the fused scan. Quantized (``quantize=True``): the int8
        lower-bound first pass keeps ``top_t`` candidates per query (64
        by default) for the exact rescore; it composes with ``prune``
        (LSH gather first, quantized cut second); both shard with
        ``sharded``. With ``verify=True`` either is bit-identical to the
        exact fused lookup.
        """
        if prune is not None:
            return self._lookup_pruned(queries, prune, verify,
                                       quantize=quantize, top_t=top_t)
        if quantize:
            return self._lookup_quantized(queries, verify, top_t)
        if self.sharded:
            return self._lookup_sharded(queries)
        if self.fused:
            return self._lookup_fused(queries)
        return self._lookup_looped(queries)

    def _lookup_fused(self, queries: torch.Tensor) -> LookupResult:
        keys, h_key, meta = self.fused_layout()
        cost, ca, lvl, slot, pay = fused_lookup(
            queries, keys, h_key, meta, metric=self.metric,
            gamma=self.gamma, h_repo=self.h_repo, repo_level=REPO_LEVEL)
        return LookupResult(level=lvl, slot=slot, payload=pay, cost=cost,
                            approx_cost=ca, hit=lvl != REPO_LEVEL)

    def _lookup_sharded(self, queries: torch.Tensor) -> LookupResult:
        if self.fused_layout()[0].shape[0] == 0:   # no keys → repository
            return self._lookup_fused(queries)
        n = self.n_shards()
        keys, h_key, _ = self.sharded_layout(n)
        cost, ca, lvl, slot, pay = sharded_fused_lookup(
            queries, keys, h_key, self.sharded_meta(n), self.mesh,
            self.resolved_shard_axes(), metric=self.metric,
            gamma=self.gamma, h_repo=self.h_repo, repo_level=REPO_LEVEL)
        return LookupResult(level=lvl, slot=slot, payload=pay, cost=cost,
                            approx_cost=ca, hit=lvl != REPO_LEVEL)

    def _lookup_quantized(self, queries: torch.Tensor, verify: bool,
                          top_t: int | None) -> LookupResult:
        self._check_layout_fresh()
        if self.fused_layout()[0].shape[0] == 0:   # no keys → repository
            return self._lookup_fused(queries)
        tt = DEFAULT_TOP_T if top_t is None else int(top_t)
        common = dict(top_t=tt, metric=self.metric, gamma=self.gamma,
                      h_repo=self.h_repo, repo_level=REPO_LEVEL)
        if self.sharded:
            n = self.n_shards()
            keys, h_key, _ = self.sharded_layout(n)
            out = sharded_quantized_fused_lookup(
                queries, keys, h_key, self.sharded_meta(n),
                self._quant_rows(n), self.mesh, self.resolved_shard_axes(),
                **common)
        else:
            out = quantized_fused_lookup(
                queries, *self.fused_layout(), self._quant_rows(), **common)
        return self._result(queries, out, verify)

    def _lookup_pruned(self, queries: torch.Tensor, prune: str,
                       verify: bool, quantize: bool = False,
                       top_t: int | None = None) -> LookupResult:
        policy = self._resolve_policy(prune)
        self._check_layout_fresh()
        if self.fused_layout()[0].shape[0] == 0:   # no keys → repository
            return self._lookup_fused(queries)
        tt = DEFAULT_TOP_T if top_t is None else int(top_t)
        common = dict(kind=policy.kind, metric=self.metric,
                      gamma=self.gamma, h_repo=self.h_repo,
                      repo_level=REPO_LEVEL, quantize=quantize, top_t=tt)
        if self.sharded:
            n = self.n_shards()
            keys, h_key, _ = self.sharded_layout(n)
            proj, buckets, n_probes = self._tables_for(policy, n)
            out = sharded_pruned_fused_lookup(
                queries, keys, h_key, self.sharded_meta(n), proj, buckets,
                self.mesh, self.resolved_shard_axes(), n_probes=n_probes,
                cap_union=policy.resolve_cap(keys.shape[0] // n), **common)
        else:
            keys, h_key, meta = self.fused_layout()
            proj, buckets, n_probes = self._tables_for(policy)
            out = pruned_fused_lookup(
                queries, keys, h_key, meta, proj, buckets,
                n_probes=n_probes,
                cap_union=policy.resolve_cap(keys.shape[0]), **common)
        return self._result(queries, out, verify)

    def _result(self, queries: torch.Tensor, out: tuple,
                verify: bool) -> LookupResult:
        cost, ca, lvl, slot, pay, bound = out
        res = LookupResult(level=lvl, slot=slot, payload=pay, cost=cost,
                           approx_cost=ca, hit=lvl != REPO_LEVEL)
        if not verify:
            return res
        return self._verify_rescan(queries, res, bound)

    def _verify_rescan(self, queries: torch.Tensor, res: LookupResult,
                       bound: torch.Tensor) -> LookupResult:
        """The verifier: ``cost < bound`` proves a pruned or quantized
        winner exact (every un-scanned valid key costs ≥ bound); every
        other query, exact ties included (their break could prefer an
        un-scanned lower index), re-scans through the exact fused path
        (the sharded one on a sharded network).
        Only the flagged queries re-scan (a kernel row depends on its own
        query alone, so a sub-batch gives the full batch's rows), padded
        with query 0 to a power of two so that repeated calls see few
        shapes. ``bound`` is a scalar for the LSH path and (B,) for the
        quantized cut; the compare broadcasts either."""
        idx = torch.nonzero(res.cost >= bound).reshape(-1)
        n = int(idx.numel())
        if n == 0:
            return res
        m = 1
        while m < n:
            m <<= 1
        m = min(m, queries.shape[0])
        pad_idx = torch.cat([idx, idx.new_zeros((m - n,))])
        exact = (self._lookup_sharded if self.sharded
                 else self._lookup_fused)(queries[pad_idx])
        self.rescan_calls += 1
        self.rescan_queries += n

        def put(dst, src):
            return dst.index_put((idx,), src[:n])
        lvl = put(res.level, exact.level)
        return LookupResult(
            level=lvl, slot=put(res.slot, exact.slot),
            payload=put(res.payload, exact.payload),
            cost=put(res.cost, exact.cost),
            approx_cost=put(res.approx_cost, exact.approx_cost),
            hit=lvl != REPO_LEVEL)

    def _lookup_looped(self, queries: torch.Tensor) -> LookupResult:
        B, dev = queries.shape[0], queries.device
        costs, slots_, pays, appr = [], [], [], []
        for lv in self.levels:
            ca, idx = nearest_approximizer(queries, lv.keys,
                                           metric=self.metric,
                                           gamma=self.gamma)
            costs.append(ca + lv.h)
            appr.append(ca)
            slots_.append(idx)
            pays.append(lv.values.to(torch.int32)[idx.long()])
        # repository: zero approximation cost, fixed h_repo
        costs.append(torch.full((B,), self.h_repo, dtype=torch.float32,
                                device=dev))
        appr.append(torch.zeros((B,), dtype=torch.float32, device=dev))
        slots_.append(torch.zeros((B,), dtype=torch.int32, device=dev))
        pays.append(torch.full((B,), -1, dtype=torch.int32, device=dev))

        call = torch.stack(costs)                     # (L+1, B)
        best = torch.argmin(call, dim=0)              # first minimum
        n_lv = len(self.levels)
        level = torch.where(best == n_lv, REPO_LEVEL, best).to(torch.int32)
        take = lambda xs: torch.stack(xs).gather(       # noqa: E731
            0, best[None, :])[0]
        return LookupResult(
            level=level, slot=take(slots_), payload=take(pays),
            cost=take(costs), approx_cost=take(appr),
            hit=level != REPO_LEVEL)

    def expected_cost(self, queries: torch.Tensor,
                      weights: torch.Tensor | None = None) -> float:
        """Empirical C(A) over a query sample (eq. (2) estimator)."""
        res = self.lookup(queries)
        if weights is None:
            return float(res.cost.mean())
        return float((weights * res.cost).sum() / weights.sum())
