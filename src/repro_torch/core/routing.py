"""On-path routing strategies: *where a response gets cached* along the
return path — the online, λ-unaware alternative to the offline
placement plane.

The offline plane (GREEDY/LOCALSWAP over ``objective.Instance``)
decides the allocation once from measured demand; this module instead
runs the classic ICN on-path strategies over the same
:class:`~repro_torch.core.topology.CacheNetwork` contract — each cache is an
LRU list, a request walks the caches on its ingress's forwarding path
(finite ``H[i, ·]`` entries in ascending reach-cost order), and the
strategy decides which caches take a copy of the response on the way
back (Icarus `models/strategy/onpath.py`), generalized to *similarity*
serving: a cache serves a request from its nearest stored key at cost
C_a(o, key) + h(i, j), exactly eq. (1) restricted to current contents.

Serving rule (all strategies): the request is served by the
cost-minimizing server among the on-path caches' nearest keys and the
repository (ties → the cache nearest the ingress), so per-request cost
is never above h_repo. An optional ``threshold`` restricts cache hits
to C_a ≤ threshold (the literal SIM-LRU admission of "Similarity
Caching: Theory and Algorithms", 1912.03888).

Strategies (insertion/refresh behavior):

* ``lce``      — leave copy everywhere: a miss inserts the object at
  every on-path cache; a hit at path position p additionally copies the
  *served key* into every cache below p (the return path).
* ``lcd``      — leave copy down: a miss inserts only at the cache
  adjacent to the repository; a hit at position p copies the served key
  one hop down (position p−1). Content migrates toward the ingress one
  level per hit.
* ``probcache``— ProbCache-style probabilistic insert: a miss inserts
  at position p with probability (remaining cache capacity from p to
  the repository / 10·mean capacity) · (p+1)/path-length — deeper
  caches insert rarely, edge caches aggressively, capacity-weighted as
  in Psaras et al.; a hit applies the same rule below the serving
  position.
* ``sim-lru``  — similarity LRU (SIM-LRU of 1912.03888, applied
  per cache along the path): a hit only refreshes the served key's LRU
  position; a miss inserts the exact object at every traversed cache.
* ``rnd-lru``  — RND-LRU: like ``sim-lru``, but an eligible cache
  serves only with probability q = 1 − C_a/θ_eff (nearer keys are
  likelier to answer; θ_eff is ``threshold`` or the cache's repo-cost
  slack) — a refusal falls through to the next cache on the path.

Every cache is bounded LRU: inserting into a full cache evicts the
least-recently-used key; re-inserting an existing key refreshes it.
The conservation contract — each request served exactly once, cache
occupancy ≤ capacity — is locked by tests/test_scenarios.py.

``serve.engine.SimCacheEngine`` plugs this in via
``EngineConfig.strategy`` (the strategy plane replaces the
offline-placement simcache as the serving decision maker; model calls
for misses are unchanged) and ``serve/stream.py`` threads per-request
ingress ids through to it.

Counterpart of ``repro.core.routing``, NumPy only and copied line for
line: the coins come from ``np.random.default_rng(seed)``, so equal
seeds and traces give bitwise equal decisions and LRU contents. It
stays on the host (one LRU walk per request, f64).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

from repro_torch.core.topology import CacheNetwork

STRATEGIES = ("lce", "lcd", "probcache", "sim-lru", "rnd-lru")


def rnd_lru_serve_prob(ca: float, theta_eff: float) -> float:
    """RND-LRU serving probability, clamped to a probability:

        q = clamp(1 − C_a/θ_eff, 0, 1)

    with the two boundary semantics made explicit instead of left to
    the raw formula:

    * ``ca <= 0`` (an exact-match key) always serves — q → 1 as
      C_a → 0 for any positive θ_eff, and an exact hit under θ_eff = 0
      (an exact-hit-only threshold) is still a hit;
    * ``theta_eff <= 0`` (non-positive slack) never serves — the raw
      1 − C_a/θ_eff is negative for every C_a > 0 there (the old
      ``max(theta, 1e-300)`` guard only kept the *division* finite, so
      q could still come out hugely negative and only accidentally
      behaved like "never" when compared against a uniform draw).

    ``serve_one``'s own eligibility arithmetic (C_a + H < h_repo in
    f64) cannot currently produce an eligible cache whose unclamped q
    is negative, so this is defensive hardening pinned at the unit
    level (tests/test_scenarios.py) rather than a behavior change on
    reachable traces.
    """
    if ca <= 0.0:
        return 1.0
    if theta_eff <= 0.0:
        return 0.0
    return float(min(max(1.0 - ca / theta_eff, 0.0), 1.0))


@dataclasses.dataclass
class RouteDecision:
    """Per-request serving decisions of one batch (host f64 arrays)."""
    cost: np.ndarray          # (B,) C_a + h of the chosen server
    approx_cost: np.ndarray   # (B,) C_a component only (0 for repo)
    hit: np.ndarray           # (B,) bool — served by some cache
    cache: np.ndarray         # (B,) serving cache id, −1 = repository
    payload: np.ndarray       # (B,) served object id (−1 = fresh fetch)


class StrategyPlane:
    """LRU cache states + one on-path strategy over a ``CacheNetwork``.

    ``coords`` is the catalog embedding matrix; approximation costs are
    computed on the fly as metric(o, key)^γ in f64 (host plane — this
    is the baseline the device-resident offline plane is benchmarked
    against, not a hot path)."""

    def __init__(self, net: CacheNetwork, coords: np.ndarray,
                 metric: str = "l2", gamma: float = 1.0,
                 strategy: str = "lce", threshold: float | None = None,
                 seed: int = 0):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; "
                             f"expected one of {STRATEGIES}")
        self.net = net
        self.coords = np.asarray(coords, np.float64)
        self.metric = metric
        self.gamma = float(gamma)
        self.strategy = strategy
        self.threshold = threshold
        self.rng = np.random.default_rng(seed)
        H = np.asarray(net.H, np.float64)
        # per-ingress forwarding path: finite-H caches in ascending
        # reach-cost order (stable ties → lowest cache id)
        self.paths = []
        for i in range(net.n_ingress):
            fin = np.nonzero(np.isfinite(H[i]))[0]
            self.paths.append(fin[np.argsort(H[i, fin], kind="stable")])
        self.H = H
        self.h_repo = np.asarray(net.h_repo, np.float64)
        self.caps = np.asarray(net.capacities, np.int64)
        # LRU state: OrderedDict per cache, most-recently-used last
        self.caches = [OrderedDict() for _ in range(net.n_caches)]
        self.n_served = 0
        self.n_inserted = 0
        self.n_evicted = 0

    # ------------------------------------------------------------ helpers
    def _ca(self, obj: int, keys: np.ndarray) -> np.ndarray:
        """(K,) approximation costs C_a(obj, keys) in f64 numpy (no jit:
        cache sizes change every step, a jitted path would retrace)."""
        q = self.coords[obj]
        x = self.coords[keys]
        if self.metric == "l1":
            d = np.abs(x - q).sum(axis=1)
        elif self.metric in ("l2", "l2sq"):
            d2 = ((x - q) ** 2).sum(axis=1)
            d = d2 if self.metric == "l2sq" else np.sqrt(d2)
        else:
            raise ValueError(f"unknown metric {self.metric!r}")
        return d if self.gamma == 1.0 else d ** self.gamma

    def _nearest(self, j: int, obj: int) -> tuple[float, int]:
        """(C_a, key) of cache j's nearest stored key (inf, −1 if empty;
        ties → the lowest key id, matching the solvers' argmin order)."""
        if not self.caches[j]:
            return np.inf, -1
        keys = np.fromiter(self.caches[j].keys(), np.int64,
                           len(self.caches[j]))
        keys.sort()
        ca = self._ca(obj, keys)
        a = int(np.argmin(ca))
        return float(ca[a]), int(keys[a])

    def _insert(self, j: int, obj: int) -> None:
        c = self.caches[j]
        if self.caps[j] <= 0:
            return
        if obj in c:
            c.move_to_end(obj)
            return
        c[obj] = None
        self.n_inserted += 1
        if len(c) > self.caps[j]:
            c.popitem(last=False)              # evict LRU
            self.n_evicted += 1

    def _refresh(self, j: int, key: int) -> None:
        if key in self.caches[j]:
            self.caches[j].move_to_end(key)

    def _prob_insert(self, path: np.ndarray, upto: int) -> None:
        """ProbCache-style inserts at path positions [0, upto)."""
        L = len(path)
        if L == 0:
            return
        caps = self.caps[path].astype(np.float64)
        mean_cap = max(float(caps.mean()), 1.0)
        for p in range(upto):
            weight = float(caps[p:].sum()) / (10.0 * mean_cap)
            prob = min(1.0, weight * (p + 1) / L)
            if self.rng.random() < prob:
                self._insert(int(path[p]), self._pending_obj)

    # ------------------------------------------------------------- serving
    def serve_one(self, obj: int, ing: int) -> tuple[float, float, int, int]:
        """Serve one request; returns (cost, approx_cost, cache, payload)
        with cache = −1 / payload = −1 for a repository fetch."""
        path = self.paths[ing]
        repo = float(self.h_repo[ing])
        # nearest key + total cost per on-path cache
        cas = np.empty(len(path), np.float64)
        keys = np.empty(len(path), np.int64)
        for p, j in enumerate(path):
            cas[p], keys[p] = self._nearest(int(j), obj)
        costs = cas + self.H[ing, path]
        eligible = costs < repo
        if self.threshold is not None:
            eligible &= cas <= self.threshold
        serve_p = -1
        if self.strategy == "rnd-lru":
            # walk up the path; each eligible cache answers with prob
            # q = clamp(1 − C_a/θ_eff, 0, 1), a refusal falls through
            for p in np.nonzero(eligible)[0]:
                theta = (self.threshold if self.threshold is not None
                         else repo - self.H[ing, path[p]])
                q = rnd_lru_serve_prob(float(cas[p]), float(theta))
                if q <= 0.0 and theta <= 0.0:
                    # non-positive slack: can never serve — skip
                    # without spending a coin (q = 0 at ca == θ still
                    # draws, matching the pre-clamp rng stream)
                    continue
                if self.rng.random() < q:
                    serve_p = int(p)
                    break
        elif np.any(eligible):
            masked = np.where(eligible, costs, np.inf)
            serve_p = int(np.argmin(masked))    # ties → nearest cache

        self._pending_obj = obj
        if serve_p < 0:                          # repository fetch
            for p in self._miss_insert_positions(path):
                self._insert(int(path[p]), obj)
            if self.strategy == "probcache":
                self._prob_insert(path, len(path))
            return repo, 0.0, -1, -1
        j = int(path[serve_p])
        key = int(keys[serve_p])
        self._refresh(j, key)
        self._hit_insert(path, serve_p, key)
        return float(costs[serve_p]), float(cas[serve_p]), j, key

    def _miss_insert_positions(self, path: np.ndarray) -> range:
        if len(path) == 0 or self.strategy == "probcache":
            return range(0)
        if self.strategy == "lcd":
            return range(len(path) - 1, len(path))   # top cache only
        return range(len(path))                      # lce / sim-lru / rnd-lru

    def _hit_insert(self, path: np.ndarray, p: int, key: int) -> None:
        """Copies left on the return path below the serving position."""
        if self.strategy == "lce":
            for q in range(p):
                self._insert(int(path[q]), key)
        elif self.strategy == "lcd" and p > 0:
            self._insert(int(path[p - 1]), key)
        elif self.strategy == "probcache":
            self._pending_obj = key
            self._prob_insert(path, p)
        # sim-lru / rnd-lru: refresh only, no new copies

    def serve(self, objs: np.ndarray, ings: np.ndarray) -> RouteDecision:
        """Serve a batch in arrival order; every request is served by
        exactly one server (a cache or the repository)."""
        objs = np.asarray(objs, np.int64)
        ings = np.asarray(ings, np.int64)
        B = objs.shape[0]
        dec = RouteDecision(
            cost=np.empty(B), approx_cost=np.empty(B),
            hit=np.zeros(B, bool), cache=np.full(B, -1, np.int64),
            payload=np.full(B, -1, np.int64))
        for b in range(B):
            c, ca, j, key = self.serve_one(int(objs[b]), int(ings[b]))
            dec.cost[b] = c
            dec.approx_cost[b] = ca
            dec.cache[b] = j
            dec.payload[b] = key
            dec.hit[b] = j >= 0
        self.n_served += B
        return dec

    # ---------------------------------------------------------- inspection
    def occupancy(self) -> np.ndarray:
        """(n_caches,) stored-key counts (≤ capacities, always)."""
        return np.array([len(c) for c in self.caches], np.int64)

    def contents(self) -> list[np.ndarray]:
        """Stored keys per cache, LRU → MRU order."""
        return [np.fromiter(c.keys(), np.int64, len(c))
                for c in self.caches]


def build_strategy(strategy: str, net: CacheNetwork, coords: np.ndarray,
                   metric: str = "l2", gamma: float = 1.0,
                   threshold: float | None = None,
                   seed: int = 0) -> StrategyPlane:
    """Factory used by ``serve.engine`` (EngineConfig.strategy)."""
    return StrategyPlane(net, coords, metric=metric, gamma=gamma,
                         strategy=strategy, threshold=threshold, seed=seed)
