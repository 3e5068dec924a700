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

Sharded, pruned, quantized and verified lookups are later slices of the
port (ROADMAP queue 1, items 10 and 11).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.knn import fused_lookup, nearest_approximizer

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
    """A chain of similarity caches in front of a repository (model)."""
    levels: list[CacheLevel]
    h_repo: float
    metric: str = "l2"
    gamma: float = 1.0
    fused: bool = True
    _layout: tuple | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _layout_fp: tuple | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @classmethod
    def from_placement(cls, coords: np.ndarray, slots: np.ndarray,
                       slot_cache: np.ndarray, hs: Sequence[float],
                       h_repo: float, metric: str = "l2",
                       gamma: float = 1.0, fused: bool = True,
                       device: str | torch.device | None = None
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
                   gamma=gamma, fused=fused)

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

    def invalidate_layout(self) -> None:
        """Drop the memoized fused layout after mutating ``levels``."""
        self._layout = None
        self._layout_fp = None

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
        """Raise when the memoized layout no longer matches ``levels``
        (the guard the reference's pruned lookups run before indexing
        candidate tables into the layout)."""
        if self._layout is not None and not self._fingerprints_match(
                self._layout_fp, self._levels_fingerprint()):
            raise RuntimeError(
                "stale layout: `levels` were mutated after the fused "
                "layout was built — call invalidate_layout() first")

    # ------------------------------------------------------------ lookup
    def lookup(self, queries: torch.Tensor) -> LookupResult:
        """Serve a batch of query embeddings (B, d) per eq. (1): one
        fused kernel launch (default) or one KNN launch per level
        (``fused=False``)."""
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
