"""Request processes (demand models) over a catalog × ingress nodes.

The paper's request model: request r = (o, i) arrives as a Poisson process
of rate λ_r. We represent demand as a matrix ``lam`` of shape
(n_ingress, n_objects), normalized so the aggregate rate is 1 (the paper
normalizes costs per request).

Demand generators cover the paper's experiments:
* Gaussian-on-grid (§6.1): λ_o ∝ exp(−d_o² / 2σ²), d_o = hop distance to
  the grid center.
* Uniform (§6.1 / Fig 5 right, Fig 6).
* Zipf popularity over an embedding catalog (the Amazon trace stand-in,
  §6.2 — popularity rank uncorrelated with distance from barycenter).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.catalog import Catalog


@dataclasses.dataclass(frozen=True)
class Demand:
    lam: np.ndarray            # (n_ingress, n_objects), sums to 1
    name: str = "demand"

    @property
    def n_ingress(self) -> int:
        return self.lam.shape[0]

    @property
    def n_objects(self) -> int:
        return self.lam.shape[1]

    @functools.cached_property
    def _cdf(self) -> np.ndarray:
        """Normalized cumulative weights over the flattened (ingress,
        object) grid, computed once per Demand (``lam`` is frozen).

        Cast to float64 and renormalized: a float32 catalog's
        probabilities can sum to 1 ± few·1e-7, and the renormalization
        keeps draws reproducible under a fixed ``rng`` regardless of
        the platform's float/int widths. (``cached_property`` writes
        straight into the instance ``__dict__``, which is fine on a
        frozen dataclass — only ``__setattr__`` is blocked.)
        """
        p = np.asarray(self.lam, np.float64).ravel()
        cdf = np.cumsum(p)
        cdf /= cdf[-1]
        return cdf

    def sample(self, n: int,
               rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
        """Sample n requests → (object_idx, ingress_idx), iid ∝ λ.

        Draws are inverse-CDF over the cached cumulative weights —
        O(n·log(O)) per call instead of the O(n_ingress·O) per call of
        rebuilding the probability vector for ``rng.choice`` (which
        ``serve/stream.py`` was paying once per streamed request).
        This is bit-compatible with the previous implementation:
        ``Generator.choice(size, p)`` itself draws
        ``cdf.searchsorted(random(n), side='right')``, so the same
        ``rng`` state yields the same requests, and n calls of
        ``sample(1)`` equal one ``sample(n)``.
        """
        flat = self._cdf.searchsorted(rng.random(n), side="right")
        ing, obj = np.divmod(flat, self.lam.shape[1])
        return obj.astype(np.int64), ing.astype(np.int64)


def _normalize(lam: np.ndarray) -> np.ndarray:
    """Normalize rates to sum 1, rejecting degenerate inputs up front:
    a zero/NaN total would silently produce NaN lam here and only blow
    up later deep inside a solver."""
    total = float(np.sum(lam))
    if not np.isfinite(total) or total <= 0.0:
        raise ValueError(
            f"demand rates must have a positive finite sum, got {total}")
    return (lam / total).astype(np.float64)


def gaussian_grid(cat: Catalog, sigma: float, n_ingress: int = 1,
                  betas: np.ndarray | None = None) -> Demand:
    """Gaussian demand centered on the grid (paper §6.1).

    λ_o ∝ exp(−d_o²/(2σ²)) with d_o the norm-1 hop distance from the grid
    center. With multiple ingress nodes the spatial shape is identical up
    to per-ingress scale factors β_ℓ (the paper's equi-depth-tree
    assumption, §4.3).
    """
    center = cat.coords.mean(axis=0)
    d = np.abs(cat.coords - center).sum(axis=1)
    base = np.exp(-d.astype(np.float64) ** 2 / (2.0 * sigma ** 2))
    betas = np.ones(n_ingress) if betas is None else np.asarray(betas, np.float64)
    lam = betas[:, None] * base[None, :]
    return Demand(lam=_normalize(lam), name=f"gauss_s{sigma:g}")


def uniform(cat: Catalog, n_ingress: int = 1,
            betas: np.ndarray | None = None) -> Demand:
    betas = np.ones(n_ingress) if betas is None else np.asarray(betas, np.float64)
    lam = np.repeat(betas[:, None], cat.n, axis=1)
    return Demand(lam=_normalize(lam), name="uniform")


def zipf(cat: Catalog, alpha: float = 0.8, n_ingress: int = 1, seed: int = 0,
         betas: np.ndarray | None = None) -> Demand:
    """Zipf popularity assigned in a random order (rank ⟂ geometry, §6.2)."""
    rng = np.random.default_rng(seed)
    ranks = rng.permutation(cat.n) + 1
    base = 1.0 / ranks.astype(np.float64) ** alpha
    betas = np.ones(n_ingress) if betas is None else np.asarray(betas, np.float64)
    lam = betas[:, None] * base[None, :]
    return Demand(lam=_normalize(lam), name=f"zipf{alpha:g}")


def from_trace(n_objects: int, obj_ids: np.ndarray, ingress_ids: np.ndarray,
               n_ingress: int = 1) -> Demand:
    """Empirical demand from a request trace (object id, ingress id).

    Raises ``ValueError`` on an empty trace or on ids outside the
    catalog/ingress ranges — both used to flow through as NaN lam or an
    IndexError from ``np.add.at``, failing far from the broken input."""
    obj_ids = np.asarray(obj_ids, dtype=np.int64)
    ingress_ids = np.asarray(ingress_ids, dtype=np.int64)
    if obj_ids.size == 0:
        raise ValueError("empty trace: no requests to build demand from")
    if obj_ids.shape != ingress_ids.shape:
        raise ValueError(
            f"trace length mismatch: {obj_ids.size} object ids vs "
            f"{ingress_ids.size} ingress ids")
    if obj_ids.min() < 0 or obj_ids.max() >= n_objects:
        raise ValueError(
            f"object ids must be in [0, {n_objects}), got range "
            f"[{obj_ids.min()}, {obj_ids.max()}]")
    if ingress_ids.min() < 0 or ingress_ids.max() >= n_ingress:
        raise ValueError(
            f"ingress ids must be in [0, {n_ingress}), got range "
            f"[{ingress_ids.min()}, {ingress_ids.max()}]")
    lam = np.zeros((n_ingress, n_objects), dtype=np.float64)
    np.add.at(lam, (ingress_ids, obj_ids), 1.0)
    return Demand(lam=_normalize(lam), name="trace")
