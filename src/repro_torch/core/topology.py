"""Cache-network topologies (paper §2).

A :class:`CacheNetwork` is a set of cache nodes plus one repository.
Requests enter at *ingress* nodes and may be served by any cache on the
(unique) forwarding path from the ingress to the repository — the paper's
routing constraint, encoded by setting h(i, j) = +inf for j off-path
(cf. the remark after Prop 3.2).

Provided constructors cover every topology the paper analyses:

* ``chain(N)``        — §4.2: requests at cache 1, forwarded along 1..N.
* ``tandem()``        — the 2-cache chain of §3.4 / §6.1 (leaf + parent).
* ``tandem_both()``   — §4.4: same tandem, arrivals at both nodes.
* ``equi_depth_tree`` — §4.3: L leaves at depth D, arrivals at leaves.
* ``star`` / custom   — general networks for the "structure is lost" study.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class CacheNetwork:
    """Static description of a similarity-cache network.

    Attributes:
      n_caches: number of cache nodes (the repository is *not* a cache).
      capacities: (n_caches,) slots per cache, k_i.
      ingress: (n_ingress,) cache node ids where requests enter.
      H: (n_ingress, n_caches) retrieval cost h(i, j); +inf if cache j is
         not on the forwarding path of requests entering at ingress i.
      h_repo: (n_ingress,) cost to the authoritative repository (= C(r, ∅)
         since the repository approximates at zero cost, paper §2).
      name: label used in logs/benchmarks.
    """

    n_caches: int
    capacities: np.ndarray
    ingress: np.ndarray
    H: np.ndarray
    h_repo: np.ndarray
    name: str = "custom"

    def __post_init__(self):
        assert self.capacities.shape == (self.n_caches,)
        assert self.H.shape == (len(self.ingress), self.n_caches)
        assert self.h_repo.shape == (len(self.ingress),)
        assert np.all(self.h_repo > 0), "repository must cost something to reach"

    @property
    def n_ingress(self) -> int:
        return len(self.ingress)

    @property
    def total_slots(self) -> int:
        return int(self.capacities.sum())

    # -- slot layout: slot s belongs to cache slot_cache[s] ---------------
    def slot_layout(self) -> np.ndarray:
        """(total_slots,) cache id owning each slot (contiguous per cache)."""
        return np.repeat(np.arange(self.n_caches), self.capacities)


def chain(n: int, k: int | Sequence[int], h_hop: float | Sequence[float],
          h_repo: float) -> CacheNetwork:
    """Chain of ``n`` caches; requests enter at cache 0 (paper's cache 1).

    ``h_hop`` is either a scalar per-hop cost or the per-node cumulative
    costs h_j (len n, h_0 typically 0). The repository sits after cache
    n-1 at cumulative cost ``h_repo``.
    """
    caps = np.full(n, k, dtype=np.int64) if np.isscalar(k) else np.asarray(k, np.int64)
    if np.isscalar(h_hop):
        h = np.arange(n, dtype=np.float64) * float(h_hop)
    else:
        h = np.asarray(h_hop, dtype=np.float64)
    assert h.shape == (n,) and np.all(np.diff(h) >= 0), "h_j must be nondecreasing"
    return CacheNetwork(
        n_caches=n, capacities=caps,
        ingress=np.array([0]), H=h[None, :].astype(np.float32),
        h_repo=np.array([h_repo], dtype=np.float32), name=f"chain{n}")


def tandem(k_leaf: int, k_parent: int, h: float, h_repo: float) -> CacheNetwork:
    """Two caches in tandem, arrivals at the leaf only (§6.1, Fig 3/4)."""
    net = chain(2, [k_leaf, k_parent], [0.0, h], h_repo)
    return dataclasses.replace(net, name="tandem")


def tandem_both(k_leaf: int, k_parent: int, h: float, h_repo: float) -> CacheNetwork:
    """Tandem with arrivals at both leaf (ingress 0) and parent (ingress 1).

    Paper §4.4 / Fig 5: leaf can forward to parent (cost h); the parent
    cannot forward down, so the leaf cache is off-path for its requests.
    """
    H = np.array([[0.0, h],
                  [np.inf, 0.0]], dtype=np.float32)
    return CacheNetwork(
        n_caches=2, capacities=np.array([k_leaf, k_parent]),
        ingress=np.array([0, 1]), H=H,
        h_repo=np.array([h_repo + h, h_repo], dtype=np.float32),
        name="tandem_both")


def equi_depth_tree(branching: int, depth: int, k_per_level: Sequence[int],
                    h_per_level: Sequence[float], h_repo: float) -> CacheNetwork:
    """Equi-depth tree (§4.3): ``branching**depth`` leaves, arrivals at leaves.

    ``k_per_level[d]``/``h_per_level[d]`` give capacity and cumulative cost
    of the cache met after climbing ``d`` levels from a leaf (d=0 is the
    leaf itself, h_per_level[0] == 0). The root's parent is the repository.
    """
    assert len(k_per_level) == depth + 1 == len(h_per_level)
    assert h_per_level[0] == 0.0
    # enumerate nodes level by level, leaves first
    nodes, level_of = [], []
    counts = [branching ** (depth - d) for d in range(depth + 1)]  # per level
    offsets = np.concatenate([[0], np.cumsum(counts)])
    n_caches = int(offsets[-1])
    caps = np.concatenate([
        np.full(counts[d], k_per_level[d], dtype=np.int64) for d in range(depth + 1)])
    n_leaves = counts[0]
    H = np.full((n_leaves, n_caches), np.inf, dtype=np.float32)
    for leaf in range(n_leaves):
        idx = leaf
        for d in range(depth + 1):
            node = int(offsets[d] + idx)
            H[leaf, node] = h_per_level[d]
            idx //= branching
    return CacheNetwork(
        n_caches=n_caches, capacities=caps,
        ingress=np.arange(n_leaves), H=H,
        h_repo=np.full(n_leaves, h_repo, dtype=np.float32),
        name=f"tree_b{branching}_d{depth}")


def single_cache(k: int, h_repo: float) -> CacheNetwork:
    """Degenerate 1-cache network (the setting of [12], used in tests)."""
    net = chain(1, [k], [0.0], h_repo)
    return dataclasses.replace(net, name="single")


def tpu_hierarchy(k_device: int, k_pod: int, k_global: int,
                  h_ici: float, h_dcn: float, h_model: float) -> CacheNetwork:
    """The hardware-adapted 3-level hierarchy of DESIGN.md §2.

    Level 0: per-device HBM shard (h=0); level 1: pod-level index reached
    over ICI (h_ici); level 2: cross-pod index over DCN (h_dcn); the
    repository is the model itself (h_model = amortized forward cost).
    Costs are in the same unit as C_a after calibration (serve/engine.py).
    """
    net = chain(3, [k_device, k_pod, k_global], [0.0, h_ici, h_dcn], h_model)
    return dataclasses.replace(net, name="tpu_hier")
