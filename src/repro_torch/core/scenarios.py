"""Icarus-style scenario plane: arbitrary graphs → :class:`CacheNetwork`.

The paper's placement machinery (eqs. (1)–(4), GREEDY/LOCALSWAP, the
device control plane) is defined for *any* network in which each
request (ingress i, object o) has a forwarding path with reach costs
h(i, j) — the solvers only ever see the (n_ingress, n_caches) H matrix
with +inf off-path entries. ``core/topology.py`` can construct just the
paper's chains/tandems/trees; this module generates the H matrix for
general graphs, the way Icarus generates experiment scenarios
(`icarus/scenarios/cacheplacement.py`):

1. **graph generators** — :func:`isp_like` (two-tier core/edge/leaf
   POP structure), :func:`scale_free` (Barabási–Albert preferential
   attachment), :func:`watts_strogatz` (rewired ring lattice). All
   return a :class:`Graph`: a symmetric (V, V) link-delay matrix with
   +inf for absent links, repaired to a single connected component.
2. **batched shortest paths** — :func:`floyd_warshall` (one vectorized
   numpy relaxation per pivot, good for dense/small V) and
   :func:`batched_dijkstra` (all sources advanced in lockstep, one
   vectorized frontier relaxation per settled node — the right shape
   when only the ingress rows are needed). Both return the same metric
   closure; :func:`shortest_paths` dispatches.
3. **cache-budget placement** — :func:`assign_budget` splits a total
   slot budget over candidate nodes proportionally to
   degree/betweenness centrality (or uniformly), largest-remainder so
   the budget is met exactly (Icarus's ``iround`` discipline).
4. **network emission** — :func:`build_scenario` picks ingress (lowest
   degree — the receivers sit at the network edge) and repository
   (highest degree) nodes, routes every ingress to the repository along
   its shortest path, and emits the existing ``CacheNetwork`` contract:
   ``H[i, j] = dist(i, cache_j)`` when cache_j lies on ingress i's
   forwarding path, +inf otherwise (the paper's routing constraint),
   ``h_repo[i] = dist(i, repository)``. Everything downstream —
   ``objective.Instance``, ``DeviceInstance``, GREEDY/LOCALSWAP, the
   NETDUEL plane, ``warmstart.classify_topology`` (which returns None
   on irreducible graphs and falls through to the discrete solvers) —
   consumes the result unchanged.

The on-path *strategy* layer that serves requests over these networks
online (LCE/LCD/ProbCache/SIM-LRU/RND-LRU) lives in
``core/routing.py``.

Counterpart of ``repro.core.scenarios``, NumPy only and copied line for
line: equal arguments give bitwise equal graphs, closures, paths and
networks; the network is the port's own :class:`CacheNetwork`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.topology import CacheNetwork

INF = np.inf


# ------------------------------------------------------------------ graphs
@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected weighted graph: ``adj[u, v]`` is the link delay
    (symmetric, +inf = no link, 0 on the diagonal)."""
    adj: np.ndarray
    name: str = "graph"

    @property
    def n_nodes(self) -> int:
        return self.adj.shape[0]

    def degrees(self) -> np.ndarray:
        """(V,) link count per node (unweighted degree)."""
        return np.sum(np.isfinite(self.adj) & (self.adj > 0), axis=1)


def _empty_adj(n: int) -> np.ndarray:
    adj = np.full((n, n), INF, dtype=np.float64)
    np.fill_diagonal(adj, 0.0)
    return adj


def _add_edge(adj: np.ndarray, u: int, v: int, w: float) -> None:
    if u == v:
        return
    adj[u, v] = adj[v, u] = min(adj[u, v], float(w))


def _delay(rng: np.random.Generator, delay: tuple[float, float]) -> float:
    lo, hi = delay
    return float(rng.uniform(lo, hi))


def _connect_components(adj: np.ndarray, rng: np.random.Generator,
                        delay: tuple[float, float]) -> None:
    """Repair connectivity in place: link each extra component's
    lowest-id node to the main component (deterministic given rng)."""
    n = adj.shape[0]
    comp = np.full(n, -1, np.int64)
    c = 0
    for s in range(n):
        if comp[s] >= 0:
            continue
        stack = [s]
        comp[s] = c
        while stack:
            u = stack.pop()
            for v in np.nonzero(np.isfinite(adj[u]))[0]:
                if comp[v] < 0:
                    comp[v] = c
                    stack.append(int(v))
        c += 1
    for cc in range(1, c):
        u = int(np.nonzero(comp == cc)[0][0])
        v = int(rng.integers(0, np.sum(comp == 0)))
        v = int(np.nonzero(comp == 0)[0][v])
        _add_edge(adj, u, v, _delay(rng, delay))


def scale_free(n: int = 48, m: int = 2, seed: int = 0,
               delay: tuple[float, float] = (1.0, 2.0)) -> Graph:
    """Barabási–Albert preferential attachment: each new node links to
    ``m`` distinct existing nodes chosen ∝ degree."""
    assert n > m >= 1
    rng = np.random.default_rng(seed)
    adj = _empty_adj(n)
    # seed clique over the first m+1 nodes, then preferential attachment
    targets = []                    # degree-weighted repeat list
    for u in range(m + 1):
        for v in range(u + 1, m + 1):
            _add_edge(adj, u, v, _delay(rng, delay))
            targets += [u, v]
    for u in range(m + 1, n):
        chosen: set[int] = set()
        while len(chosen) < m:
            chosen.add(int(targets[rng.integers(0, len(targets))]))
        for v in chosen:
            _add_edge(adj, u, v, _delay(rng, delay))
            targets += [u, v]
    return Graph(adj=adj, name=f"ba_n{n}_m{m}")


def watts_strogatz(n: int = 40, k: int = 4, beta: float = 0.3,
                   seed: int = 0,
                   delay: tuple[float, float] = (1.0, 2.0)) -> Graph:
    """Watts–Strogatz small world: ring lattice (each node linked to its
    k/2 nearest neighbours per side), each edge rewired with prob β;
    connectivity repaired afterwards."""
    assert k % 2 == 0 and 0 < k < n
    rng = np.random.default_rng(seed)
    adj = _empty_adj(n)
    for u in range(n):
        for off in range(1, k // 2 + 1):
            v = (u + off) % n
            if rng.random() < beta:
                w = int(rng.integers(0, n))
                tries = 0
                while (w == u or np.isfinite(adj[u, w])) and tries < 8:
                    w = int(rng.integers(0, n))
                    tries += 1
                v = v if (w == u or np.isfinite(adj[u, w])) else w
            _add_edge(adj, u, v, _delay(rng, delay))
    _connect_components(adj, rng, delay)
    return Graph(adj=adj, name=f"ws_n{n}_k{k}")


def isp_like(n_core: int = 6, n_edge: int = 12, n_leaf: int = 24,
             seed: int = 0,
             core_delay: tuple[float, float] = (0.5, 1.0),
             edge_delay: tuple[float, float] = (1.0, 2.0),
             leaf_delay: tuple[float, float] = (2.0, 4.0)) -> Graph:
    """Two-tier ISP-like POP structure: a core ring with chord links
    (fast), edge routers dual-homed onto random cores, access leaves
    single-homed onto edge routers (slow last mile). Node order:
    cores [0, n_core), edges [n_core, n_core+n_edge), leaves after."""
    rng = np.random.default_rng(seed)
    n = n_core + n_edge + n_leaf
    adj = _empty_adj(n)
    for u in range(n_core):                        # core ring + chords
        _add_edge(adj, u, (u + 1) % n_core, _delay(rng, core_delay))
    for u in range(n_core):
        for v in range(u + 2, n_core):
            if rng.random() < 0.3:
                _add_edge(adj, u, v, _delay(rng, core_delay))
    for e in range(n_edge):                        # dual-homed edges
        u = n_core + e
        homes = rng.choice(n_core, size=min(2, n_core), replace=False)
        for v in homes:
            _add_edge(adj, u, int(v), _delay(rng, edge_delay))
    for l in range(n_leaf):                        # single-homed leaves
        u = n_core + n_edge + l
        v = n_core + int(rng.integers(0, n_edge))
        _add_edge(adj, u, v, _delay(rng, leaf_delay))
    return Graph(adj=adj, name=f"isp_c{n_core}_e{n_edge}_l{n_leaf}")


GENERATORS = {"isp": isp_like, "scale_free": scale_free,
              "watts_strogatz": watts_strogatz}


# ----------------------------------------------------------- shortest paths
def floyd_warshall(adj: np.ndarray) -> np.ndarray:
    """All-pairs shortest path distances, one vectorized (V, V)
    relaxation per pivot node."""
    d = np.array(adj, dtype=np.float64)
    for k in range(d.shape[0]):
        np.minimum(d, d[:, k, None] + d[None, k, :], out=d)
    return d


def batched_dijkstra(adj: np.ndarray,
                     sources: np.ndarray | Sequence[int]) -> np.ndarray:
    """(S, V) shortest-path distances from ``sources``: all sources
    advance in lockstep — each of the V settle rounds picks every
    source's nearest unvisited node at once and relaxes all S frontiers
    with one broadcast minimum (no per-edge Python loop)."""
    src = np.asarray(sources, np.int64)
    V = adj.shape[0]
    S = src.shape[0]
    dist = np.full((S, V), INF, dtype=np.float64)
    dist[np.arange(S), src] = 0.0
    done = np.zeros((S, V), dtype=bool)
    for _ in range(V):
        cand = np.where(done, INF, dist)                  # (S, V)
        u = np.argmin(cand, axis=1)                       # (S,)
        still = np.isfinite(cand[np.arange(S), u])
        done[np.arange(S), u] |= still
        # relax every source's frontier row in one broadcast
        du = dist[np.arange(S), u][:, None]               # (S, 1)
        relax = np.where(still[:, None], du + adj[u, :], INF)
        np.minimum(dist, relax, out=dist)
    return dist


def shortest_paths(adj: np.ndarray,
                   sources: np.ndarray | Sequence[int] | None = None,
                   method: str = "auto") -> np.ndarray:
    """Distance rows for ``sources`` (all nodes when None). ``method``:
    "fw" | "dijkstra" | "auto" (Dijkstra when only a few source rows
    are needed, Floyd–Warshall for the full closure)."""
    V = adj.shape[0]
    if sources is None:
        sources = np.arange(V)
    src = np.asarray(sources, np.int64)
    if method == "auto":
        method = "dijkstra" if src.shape[0] * 4 < V else "fw"
    if method == "fw":
        return floyd_warshall(adj)[src]
    if method == "dijkstra":
        return batched_dijkstra(adj, src)
    raise ValueError(f"unknown method {method!r}")


def route(adj: np.ndarray, dist_to_dst: np.ndarray, src: int,
          dst: int) -> list[int]:
    """Shortest path src → dst as a node list, reconstructed by greedy
    descent on ``dist_to_dst`` (= dist[:, dst]): from u, step to the
    neighbour minimizing link + remaining distance (ties → lowest node
    id, so routes are deterministic)."""
    path = [int(src)]
    u = int(src)
    while u != dst:
        nxt = adj[u] + dist_to_dst
        nxt[u] = INF         # zero diagonal: staying put ties the
        #                      optimal hop and argmin would pick it
        v = int(np.argmin(nxt))
        if not np.isfinite(nxt[v]):
            raise ValueError(f"no route from {src} to {dst}")
        path.append(v)
        u = v
    return path


# --------------------------------------------------------------- centrality
def degree_centrality(g: Graph) -> np.ndarray:
    return g.degrees().astype(np.float64)


def betweenness_centrality(g: Graph) -> np.ndarray:
    """Weighted betweenness (Brandes): per-source Dijkstra with
    predecessor lists + the standard dependency back-accumulation."""
    adj = g.adj
    V = adj.shape[0]
    bc = np.zeros(V, dtype=np.float64)
    nbrs = [np.nonzero(np.isfinite(adj[u]) & (np.arange(V) != u))[0]
            for u in range(V)]
    for s in range(V):
        dist = np.full(V, INF)
        sigma = np.zeros(V)
        preds: list[list[int]] = [[] for _ in range(V)]
        dist[s] = 0.0
        sigma[s] = 1.0
        done = np.zeros(V, dtype=bool)
        order = []
        for _ in range(V):
            cand = np.where(done, INF, dist)
            u = int(np.argmin(cand))
            if not np.isfinite(cand[u]):
                break
            done[u] = True
            order.append(u)
            for v in nbrs[u]:
                alt = dist[u] + adj[u, v]
                if alt < dist[v] - 1e-12:
                    dist[v] = alt
                    sigma[v] = sigma[u]
                    preds[v] = [u]
                elif abs(alt - dist[v]) <= 1e-12 and not done[v]:
                    sigma[v] += sigma[u]
                    preds[v].append(u)
        delta = np.zeros(V)
        for w in reversed(order):
            for u in preds[w]:
                delta[u] += sigma[u] / sigma[w] * (1.0 + delta[w])
            if w != s:
                bc[w] += delta[w]
    return bc / 2.0                      # undirected: each pair counted twice


CENTRALITIES = {"uniform": None, "degree": degree_centrality,
                "betweenness": betweenness_centrality}


def assign_budget(scores: np.ndarray, budget: int) -> np.ndarray:
    """Split ``budget`` slots over candidates ∝ ``scores`` (uniform when
    all-zero), largest remainder so the total is met exactly."""
    scores = np.asarray(scores, np.float64)
    n = scores.shape[0]
    assert budget >= 0 and n > 0
    if scores.sum() <= 0.0:
        scores = np.ones(n)
    frac = scores / scores.sum() * budget
    caps = np.floor(frac).astype(np.int64)
    short = budget - int(caps.sum())
    if short > 0:
        order = np.argsort(-(frac - caps), kind="stable")
        caps[order[:short]] += 1
    return caps


# ----------------------------------------------------------------- scenario
@dataclasses.dataclass(frozen=True)
class Scenario:
    """A generated experiment scenario: the graph, its metric closure,
    and the emitted :class:`CacheNetwork` the solvers consume.

    ``cache_nodes[j]`` is the graph node hosting cache j;
    ``paths[i]`` the full node sequence of ingress i's forwarding path
    (ingress → … → repository)."""
    graph: Graph
    net: CacheNetwork
    dist: np.ndarray                   # (V, V) metric closure
    cache_nodes: np.ndarray            # (n_caches,)
    ingress_nodes: np.ndarray          # (n_ingress,)
    repo_node: int
    paths: tuple                       # tuple[tuple[int, ...], ...]
    placement: str = "degree"

    @property
    def name(self) -> str:
        return self.net.name


def build_scenario(g: Graph, cache_budget: int, placement: str = "degree",
                   n_ingress: int = 8, repo_node: int | None = None,
                   ingress_nodes: np.ndarray | None = None) -> Scenario:
    """Emit the :class:`CacheNetwork` for ``g``.

    Ingress nodes default to the ``n_ingress`` lowest-degree nodes
    (receivers live at the network edge, as in Icarus topologies), the
    repository to the highest-degree non-ingress node (the best-connected
    POP hosts the origin). Candidate cache nodes are every other node;
    ``cache_budget`` total slots are split over them by ``placement``
    centrality and nodes awarded zero slots are dropped from the cache
    list. H follows the paper's on-path routing constraint.
    """
    if placement not in CENTRALITIES:
        raise ValueError(f"unknown placement {placement!r}; "
                         f"expected one of {sorted(CENTRALITIES)}")
    V = g.n_nodes
    deg = g.degrees()
    if ingress_nodes is None:
        # lowest degree first, ties to the lowest node id
        order = np.lexsort((np.arange(V), deg))
        ingress_nodes = np.sort(order[:n_ingress])
    ingress_nodes = np.asarray(ingress_nodes, np.int64)
    if repo_node is None:
        mask = np.ones(V, dtype=bool)
        mask[ingress_nodes] = False
        cand = np.nonzero(mask)[0]
        repo_node = int(cand[np.argmax(deg[cand])])
    if repo_node in set(ingress_nodes.tolist()):
        raise ValueError("repository node cannot also be an ingress")

    candidates = np.array([v for v in range(V)
                           if v != repo_node
                           and v not in set(ingress_nodes.tolist())],
                          np.int64)
    cent_fn = CENTRALITIES[placement]
    scores = (np.ones(candidates.shape[0]) if cent_fn is None
              else cent_fn(g)[candidates])
    caps = assign_budget(scores, cache_budget)

    dist = floyd_warshall(g.adj)
    paths = tuple(tuple(route(g.adj, dist[:, repo_node], int(i), repo_node))
                  for i in ingress_nodes)

    # coverage repair: centrality splits can leave an ingress whose whole
    # forwarding path got zero slots (an all-inf H row — the solvers then
    # can't serve that ingress from any cache). Move one slot from the
    # largest cache to the best-scoring intermediate node of each
    # uncovered path; a direct ingress→repo edge has no intermediates
    # and legitimately stays repo-only.
    cand_idx = {int(v): c for c, v in enumerate(candidates)}
    for p in paths:
        mid = [cand_idx[v] for v in p[1:-1] if v in cand_idx]
        if not mid or any(caps[c] > 0 for c in mid):
            continue
        donor = int(np.argmax(caps))
        if caps[donor] <= 1:
            continue                    # nothing to spare
        take = mid[int(np.argmax(scores[mid]))]
        caps[donor] -= 1
        caps[take] += 1

    keep = caps > 0
    cache_nodes = candidates[keep]
    caps = caps[keep]
    node_to_cache = {int(v): j for j, v in enumerate(cache_nodes)}
    H = np.full((ingress_nodes.shape[0], cache_nodes.shape[0]), np.inf,
                dtype=np.float32)
    for i, p in enumerate(paths):
        for v in p:
            j = node_to_cache.get(int(v))
            if j is not None:
                H[i, j] = dist[ingress_nodes[i], v]
    h_repo = dist[ingress_nodes, repo_node].astype(np.float32)
    net = CacheNetwork(
        n_caches=cache_nodes.shape[0], capacities=caps.astype(np.int64),
        ingress=ingress_nodes, H=H, h_repo=h_repo,
        name=f"{g.name}_{placement}")
    return Scenario(graph=g, net=net, dist=dist, cache_nodes=cache_nodes,
                    ingress_nodes=ingress_nodes, repo_node=int(repo_node),
                    paths=paths, placement=placement)


def scenario(family: str, cache_budget: int = 64,
             placement: str = "degree", n_ingress: int = 8, seed: int = 0,
             **graph_kw) -> Scenario:
    """One-call helper: generate the ``family`` graph and emit its
    network. ``family`` ∈ {"isp", "scale_free", "watts_strogatz"}."""
    if family not in GENERATORS:
        raise ValueError(f"unknown family {family!r}; "
                         f"expected one of {sorted(GENERATORS)}")
    g = GENERATORS[family](seed=seed, **graph_kw)
    return build_scenario(g, cache_budget=cache_budget,
                          placement=placement, n_ingress=n_ingress)
