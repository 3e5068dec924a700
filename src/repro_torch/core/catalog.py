"""Object catalogs: discrete grids and continuous R^p embedding spaces.

The paper's two instances (§2):

* **grid** — §6.1: objects on the points of an L×L grid with the norm-1
  (hop) metric and C_a(x,y) = d(x,y)^γ.
* **embeddings** — §6.2: objects embedded in R^d (d=100 for the Amazon
  trace), Euclidean distance as dissimilarity.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import costs


@dataclasses.dataclass(frozen=True)
class Catalog:
    """A finite catalog of objects with coordinates in R^p.

    ``coords`` are float32 (n_objects, p). The request space is the
    catalog itself in the discrete setting (O_R == O), which is how the
    paper's experiments are set up.
    """
    coords: np.ndarray
    metric: str = "l1"
    gamma: float = 1.0
    name: str = "catalog"

    @property
    def n(self) -> int:
        return self.coords.shape[0]

    @property
    def dim(self) -> int:
        return self.coords.shape[1]

    def ca(self, rows: np.ndarray | None = None,
           cols: np.ndarray | None = None) -> np.ndarray:
        """C_a block between object subsets (default: full matrix)."""
        x = self.coords if rows is None else self.coords[rows]
        y = self.coords if cols is None else self.coords[cols]
        return costs.approx_cost_np(x, y, self.metric, self.gamma)


def grid(L: int = 100, gamma: float = 1.0) -> Catalog:
    """L×L grid catalog with norm-1 metric (paper §6.1; 10000 objects at L=100)."""
    xs, ys = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
    coords = np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float32)
    return Catalog(coords=coords, metric="l1", gamma=gamma, name=f"grid{L}")


def embedding_catalog(n: int, dim: int, seed: int = 0, radial: str = "decreasing",
                      gamma: float = 1.0) -> Catalog:
    """Synthetic R^dim catalog emulating the Amazon/McAuley embeddings (§6.2).

    Directions are uniform on the sphere; radii are drawn so that the
    request density within spherical shells *decreases* with distance from
    the barycenter, matching the paper's Fig 8 observation. The scale is
    chosen so typical inter-item distances are O(100), comparable to the
    paper's h = 150 setting.
    """
    rng = np.random.default_rng(seed)
    dirs = rng.standard_normal((n, dim)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    if radial == "decreasing":
        radii = rng.gamma(shape=2.0, scale=120.0, size=n).astype(np.float32)
    elif radial == "uniform_ball":
        radii = 400.0 * rng.random(n).astype(np.float32) ** (1.0 / dim)
    else:
        raise ValueError(radial)
    coords = dirs * radii[:, None]
    return Catalog(coords=coords, metric="l2", gamma=gamma,
                   name=f"emb{n}d{dim}")
