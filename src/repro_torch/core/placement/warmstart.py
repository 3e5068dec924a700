"""Continuous-limit warm starts — §4 as the production placement path.

Counterpart of ``repro.core.placement.warmstart``; everything but the
tandem solve and the polish is the reference's NumPy, line for line.

The discrete control plane (GREEDY over the batched gain oracle,
placement/device.py) pays O(O·J) oracle work per solve: past ~10⁵
objects a refresh no longer fits between serving batches, and at
10⁶–10⁷ the gain table cannot exist at all. The paper's §4 continuous
formulation closes exactly that gap — for every topology it analyses
the *optimal* continuous allocation has threshold/closed form
(Prop 4.2: in a chain each cache serves a contiguous popularity band;
Prop 4.4: equi-depth trees replicate one chain solution per level;
eqs. (14)–(15) for the tandem with arrivals at both nodes), and
solving it costs milliseconds at any catalog size.

Pipeline (near-O(O) end to end):

1. **classify** — :func:`classify_topology` reduces a
   :class:`~repro_torch.core.topology.CacheNetwork` to the continuous
   program it instantiates: any single-ingress net is a chain (caches
   ordered by retrieval cost; covers ``single_cache``/``tandem``/
   ``chain``/``tpu_hierarchy``), the §4.4 two-ingress tandem is matched
   by its H pattern, and leaf-fed equi-depth trees by identical
   per-ingress cost vectors with uniform per-level capacities. Returns ``None`` for
   topologies outside the paper's analysis — callers fall back to the
   discrete solvers.
2. **solve** — :func:`solve_continuous`: Prop 4.2 threshold coordinate
   descent (``solve_chain_thresholds``: O(O) prefix sums + an
   O(N·grid)-evaluation golden-section search, NumPy) for chains and
   trees, the projected-gradient ``solve_tandem_both`` (f32, autograd,
   on a torch device) for the §4.4 tandem.
3. **map** — :func:`map_solution`: band-partition the λ-descending
   catalog at the solved split points and fill each cache from its band
   by quantile-striding the §4.1 slot density λ^{2/(γ+2)} (each slot
   covers an equal share of its band's density mass — the discrete
   shadow of the optimal tessellation), respecting
   ``CacheNetwork.slot_layout()``.
4. **polish** — a bounded ``device_localswap`` window of O(K) steps
   (K = total slots, independent of O) removes the discretization error
   at band edges. The reference scans the window in one ``lax.scan``;
   the port's ``device_localswap`` has one form, which takes the same
   decisions as the reference's per-step and scanned windows.

:func:`warm_start` runs 1–4 and returns a :class:`WarmStartReport`
carrying the allocation plus per-stage wall clock (measured optimality
gap vs ``device_greedy`` where greedy still runs, and Prop 4.2 band
containment everywhere, are held in tests/test_torch_warmstart.py).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.objective import DeviceInstance, Instance
from repro_torch.core.placement import continuous as cont
from repro_torch.core.placement.device import SWAP_TOL, device_localswap
from repro_torch.core.placement.localswap import localswap
from repro_torch.core.topology import CacheNetwork


# --------------------------------------------------------------- reductions
@dataclasses.dataclass(frozen=True)
class ChainReduction:
    """Single-ingress net as the chain program (11).

    ``path`` lists cache ids in h-ascending chain order; ``unreachable``
    the caches with +inf retrieval cost (off the forwarding path — they
    can never serve, so the warm start fills them by popularity and the
    polish window is free to repurpose them if the discrete objective
    ever disagrees)."""
    spec: cont.ChainSpec
    path: tuple
    unreachable: tuple = ()
    kind: str = "chain"


@dataclasses.dataclass(frozen=True)
class TreeReduction:
    """Leaf-fed equi-depth tree (§4.3): one chain program, replicated
    across every cache of each level per Prop 4.4 (levels[0] = leaves,
    solved at the leaf-aggregate rate — homogeneity degree 1 makes the
    aggregate chain cost equal the Prop 4.4 tree cost Σ_ℓ β_ℓ·C)."""
    spec: cont.ChainSpec
    levels: tuple                      # tuple[tuple[cache ids], ...]
    kind: str = "tree"


@dataclasses.dataclass(frozen=True)
class TandemBothReduction:
    """The §4.4 tandem with arrivals at both nodes (eqs. 14–15)."""
    leaf: int
    parent: int
    leaf_ingress: int
    parent_ingress: int
    h: float
    gamma: float = 1.0
    kind: str = "tandem_both"


Reduction = ChainReduction | TreeReduction | TandemBothReduction


def classify_topology(net: CacheNetwork, gamma: float = 1.0
                      ) -> Reduction | None:
    """Reduce ``net`` to the §4 continuous program it instantiates.

    Order of attempts: single ingress → chain (always reducible — the
    finite-H caches sorted by retrieval cost are the chain, ties broken
    by cache id); the two-ingress ``tandem_both`` H pattern; leaf-fed
    equi-depth trees. Anything else returns None and the caller falls
    back to the discrete solvers.
    """
    H = np.asarray(net.H, np.float64)
    if net.n_ingress == 1:
        finite = np.isfinite(H[0])
        reach = np.nonzero(finite)[0]
        if reach.size == 0:
            return None
        path = reach[np.argsort(H[0, reach], kind="stable")]
        return ChainReduction(
            spec=cont.ChainSpec(
                ks=tuple(float(net.capacities[j]) for j in path),
                hs=tuple(float(H[0, j]) for j in path),
                h_repo=float(net.h_repo[0]), gamma=gamma),
            path=tuple(int(j) for j in path),
            unreachable=tuple(int(j) for j in np.nonzero(~finite)[0]))
    red = _classify_tandem_both(net, H, gamma)
    if red is not None:
        return red
    return _classify_tree(net, H, gamma)


def _classify_tandem_both(net: CacheNetwork, H: np.ndarray, gamma: float
                          ) -> TandemBothReduction | None:
    if H.shape != (2, 2):
        return None
    nfin = np.isfinite(H).sum(axis=1)
    if sorted(nfin.tolist()) != [1, 2]:
        return None
    a = int(np.argmax(nfin))           # leaf ingress reaches both caches
    b = 1 - a
    parent = int(np.nonzero(np.isfinite(H[b]))[0][0])
    leaf = 1 - parent
    if not np.isfinite(H[a, leaf]) or H[a, leaf] > H[a, parent]:
        return None
    return TandemBothReduction(
        leaf=leaf, parent=parent, leaf_ingress=a, parent_ingress=b,
        h=float(H[a, parent] - H[a, leaf]), gamma=gamma)


def _classify_tree(net: CacheNetwork, H: np.ndarray, gamma: float
                   ) -> TreeReduction | None:
    if net.n_ingress < 2 or not np.allclose(net.h_repo, net.h_repo[0]):
        return None
    paths, hs0 = [], None
    for i in range(net.n_ingress):
        fi = np.nonzero(np.isfinite(H[i]))[0]
        p = fi[np.argsort(H[i, fi], kind="stable")]
        hv = H[i, p]
        if hs0 is None:
            hs0 = hv
        elif hv.shape != hs0.shape or not np.allclose(hv, hs0):
            return None                # unequal depths / unequal hop costs
        paths.append(p)
    level_of = np.full(net.n_caches, -1, np.int64)
    for p in paths:
        for d, j in enumerate(p):
            if level_of[j] not in (-1, d):
                return None            # one cache at two depths: not a tree
            level_of[j] = d
    if np.any(level_of < 0):
        return None                    # cache on no ingress path
    levels = []
    for d in range(hs0.shape[0]):
        ld = np.nonzero(level_of == d)[0]
        caps = net.capacities[ld]
        if ld.size == 0 or not np.all(caps == caps[0]):
            return None                # Prop 4.4 needs uniform level sizes
        levels.append(tuple(int(j) for j in ld))
    return TreeReduction(
        spec=cont.ChainSpec(
            ks=tuple(float(net.capacities[lv[0]]) for lv in levels),
            hs=tuple(float(h) for h in hs0),
            h_repo=float(net.h_repo[0]), gamma=gamma),
        levels=tuple(levels))


# -------------------------------------------------------------------- solve
@dataclasses.dataclass(frozen=True)
class ContinuousSolution:
    """Output of the per-topology continuous solver.

    ``order`` is the λ-descending object permutation the bands live on;
    chains/trees carry ``splits`` (fractional Prop 4.2 split points on
    that axis), the tandem-both carries the per-object leaf-keep
    fraction ``w1`` (natural object order) and the arrival ratio β."""
    kind: str
    cost: float
    order: np.ndarray
    splits: np.ndarray | None = None
    w1: np.ndarray | None = None
    beta: float = 0.0


def solve_continuous(inst: Instance, red: Reduction,
                     md_iters: int = 3000, sweeps: int = 16,
                     grid: int = 48,
                     device: str | torch.device | None = None
                     ) -> ContinuousSolution:
    """Solve the continuous program ``red`` on ``inst``'s demand rates.

    ``sweeps``/``grid`` are lighter than ``solve_chain_thresholds``'s
    analysis defaults (60/96): measured on 10³–10⁶-region Zipf and grid
    instances the optimal cost agrees to ~1e-9 relative while the solve
    runs ~3× faster — golden section past ~48 halvings only burnishes
    digits far below the discretization error the band map introduces
    anyway. ``device`` is where the tandem's descent runs (CUDA unless
    named); chains and trees solve in NumPy."""
    if red.kind == "tandem_both":
        lam0 = np.asarray(inst.lam[red.leaf_ingress], np.float64)
        lam1 = np.asarray(inst.lam[red.parent_ingress], np.float64)
        beta = float(lam1.sum() / max(lam0.sum(), 1e-300))
        w1, c = cont.solve_tandem_both(
            lam0, float(inst.net.capacities[red.leaf]),
            float(inst.net.capacities[red.parent]), red.h, beta,
            gamma=red.gamma, iters=md_iters, device=device)
        return ContinuousSolution(
            kind=red.kind, cost=float(c),
            order=np.argsort(-lam0, kind="stable"),
            w1=np.asarray(w1, np.float64), beta=beta)
    lams = inst.lam[0] if red.kind == "chain" else inst.lam.sum(axis=0)
    splits, c, order = cont.solve_chain_thresholds(
        np.asarray(lams, np.float64), red.spec, sweeps=sweeps, grid=grid)
    return ContinuousSolution(kind=red.kind, cost=float(c), order=order,
                              splits=splits)


# ---------------------------------------------------------------------- map
def _quantile_picks(w: np.ndarray, k: int) -> np.ndarray:
    """k distinct indices into ``w`` spread so each pick owns an equal
    share of the cumulative mass — the §4.1 slot density discretized
    (slot i sits at the (i+½)/k mass quantile). Zero total mass falls
    back to an even positional stride. Requires 0 < k ≤ len(w)."""
    m = w.shape[0]
    c = np.cumsum(np.maximum(np.asarray(w, np.float64), 0.0))
    if c[-1] <= 0.0:
        picks = np.floor((np.arange(k) + 0.5) * (m / k)).astype(np.int64)
    else:
        targets = (np.arange(k) + 0.5) * (c[-1] / k)
        picks = np.searchsorted(c, targets).astype(np.int64)
    # dedupe while staying in-range: clamp against the max tail each
    # position can still reach, then push strictly increasing
    picks = np.minimum(picks, m - k + np.arange(k))
    for i in range(1, k):
        if picks[i] <= picks[i - 1]:
            picks[i] = picks[i - 1] + 1
    return picks


def band_bounds(splits: np.ndarray, n_objects: int) -> np.ndarray:
    """Integer rank boundaries of the Prop 4.2 bands: band p covers
    λ-descending ranks [bounds[p], bounds[p+1]); the segment past the
    last bound is the repository's tail."""
    pos = np.concatenate([[0.0], np.asarray(splits, np.float64),
                          [float(n_objects)]])
    pos = np.maximum.accumulate(np.clip(pos, 0.0, float(n_objects)))
    return np.maximum.accumulate(np.rint(pos).astype(np.int64))


def rank_window(n_objects: int, lo: int, hi: int, k: int) -> tuple[int, int]:
    """The contiguous rank window a k-slot cache with band [lo, hi)
    draws from: the band itself when it holds ≥ k objects, otherwise the
    band grown toward the tail (and, at the catalog edge, toward the
    head) until k fit. tests/test_warmstart.py asserts every stored
    object's rank lies inside this window — the discrete Prop 4.2."""
    if k >= n_objects:
        return 0, n_objects
    lo = int(min(lo, n_objects - k))
    hi = int(min(max(hi, lo + k), n_objects))
    return lo, hi


def _fill_band(order: np.ndarray, w_sorted: np.ndarray, lo: int, hi: int,
               k: int) -> np.ndarray:
    """k object ids for one cache whose Prop 4.2 band is ranks [lo, hi):
    the whole band when exactly k wide, a λ^{2/(γ+2)}-quantile stride
    when wider, the :func:`rank_window` extension when narrower. A
    catalog smaller than the cache wraps (duplicate slots are legal —
    the polish pass diversifies them if that ever helps)."""
    n = order.shape[0]
    if k >= n:
        return order[np.resize(np.arange(n), k)]
    lo, hi = rank_window(n, lo, hi, k)
    if hi - lo == k:
        return order[lo:hi]
    return order[lo + _quantile_picks(w_sorted[lo:hi], k)]


def map_solution(inst: Instance, red: Reduction, sol: ContinuousSolution
                 ) -> tuple[np.ndarray, np.ndarray | None]:
    """Discrete allocation from the continuous optimum.

    Returns ``(slots, bounds)``: every slot filled (no −1 — the
    continuous optimum never leaves capacity idle), ``bounds`` the
    integer Prop 4.2 band boundaries (None for the structure-free
    tandem-both, whose allocation is density- not band-shaped)."""
    O = inst.cat.n
    g = inst.cat.gamma
    slot_cache = inst.slot_cache
    caps = inst.net.capacities
    slots = np.empty(inst.net.total_slots, np.int64)
    order = sol.order
    if red.kind == "tandem_both":
        # eq. (14) split as slot densities: leaf ∝ (λ·w1)^{2/(γ+2)} per
        # region → after the regional λ^e factor, leaf mass λ^e·w1-ish;
        # parent serves forwarded border mass plus its own β arrivals.
        e = 2.0 / (2.0 + g)
        lam0 = np.asarray(inst.lam[red.leaf_ingress], np.float64)[order]
        lb = lam0 ** e
        w1s = np.clip(sol.w1[order], 0.0, 1.0)
        dens = {red.leaf: lb * w1s,
                red.parent: lb * (sol.beta +
                                  (1.0 - w1s) ** ((g + 2.0) / 2.0)) ** e}
        for j, w in dens.items():
            k = int(caps[j])
            chosen = order[_quantile_picks(w, k)] if k <= O \
                else order[np.resize(np.arange(O), k)]
            slots[slot_cache == j] = chosen
        return slots, None
    lams = inst.lam[0] if red.kind == "chain" else inst.lam.sum(axis=0)
    w_sorted = np.asarray(lams, np.float64)[order] ** (2.0 / (g + 2.0))
    bounds = band_bounds(sol.splits, O)
    groups = tuple((j,) for j in red.path) if red.kind == "chain" \
        else red.levels
    for p, caches in enumerate(groups):
        for j in caches:
            chosen = _fill_band(order, w_sorted, int(bounds[p]),
                                int(bounds[p + 1]), int(caps[j]))
            slots[slot_cache == j] = chosen
    if red.kind == "chain":
        for j in red.unreachable:       # never served: park the head
            k = int(caps[j])
            slots[slot_cache == j] = _fill_band(order, w_sorted, 0, k, k)
    return slots, bounds


# ----------------------------------------------------------------- pipeline
@dataclasses.dataclass
class WarmStartReport:
    """What :func:`warm_start` produced and what each stage cost."""
    kind: str                          # reduction kind solved
    slots: np.ndarray                  # post-polish allocation (no −1)
    slots_warm: np.ndarray             # analytic map before polish
    cont_cost: float                   # continuous-optimum objective
    order: np.ndarray                  # λ-descending object permutation
    bounds: np.ndarray | None          # integer band boundaries
    groups: tuple                      # caches per chain position
    solve_s: float
    map_s: float
    polish_s: float
    n_swaps: int = 0

    @property
    def total_s(self) -> float:
        return self.solve_s + self.map_s + self.polish_s


def default_polish_iters(n_slots: int) -> int:
    """Polish window ~O(K): long enough for the emulated request stream
    to touch every slot a few times, independent of catalog size — the
    near-O(O) contract of the pipeline."""
    return int(min(max(4 * n_slots, 128), 4096))


def warm_start(inst: Instance, *, reduction: Reduction | None = None,
               polish_iters: int | None = None, seed: int = 0,
               tol: float = SWAP_TOL, device: bool = True,
               dinst: DeviceInstance | None = None,
               md_iters: int = 3000,
               torch_device: str | torch.device | None = None
               ) -> WarmStartReport:
    """Classify → solve → map → polish. Deterministic for fixed inputs
    (the continuous solvers are fixed-iteration descents, the map is
    pure NumPy, the polish replays ``emulated_stream(seed)``) — which is
    what lets warm-started background refreshes stay replayable.

    ``device=False`` polishes with the host NumPy LOCALSWAP instead of
    the device window (only sensible at small O). A prebuilt ``dinst``
    (e.g. the engine's control-plane instance) is reused instead of
    building one per call. The tandem's descent and the device polish
    run on ``dinst.device`` when a ``dinst`` is given, else on
    ``torch_device`` (CUDA unless named); a chain or a tree polished on
    the host touches no torch device.
    """
    t0 = time.perf_counter()
    red = reduction if reduction is not None \
        else classify_topology(inst.net, gamma=inst.cat.gamma)
    if red is None:
        raise ValueError(
            "topology does not reduce to a §4 continuous program; use the "
            "discrete solvers (device_greedy / device_localswap)")
    sol = solve_continuous(
        inst, red, md_iters=md_iters,
        device=dinst.device if dinst is not None else torch_device)
    t1 = time.perf_counter()
    slots_warm, bounds = map_solution(inst, red, sol)
    t2 = time.perf_counter()
    if polish_iters is None:
        polish_iters = default_polish_iters(inst.net.total_slots)
    slots, n_swaps = slots_warm, 0
    if polish_iters > 0:
        if device:
            if dinst is None:
                dinst = DeviceInstance.from_instance(
                    inst, materialize_ca=False, device=torch_device)
            st = device_localswap(dinst, n_iters=polish_iters, seed=seed,
                                  slots0=slots_warm, tol=tol)
            slots, n_swaps = st.slots_np, int(st.n_swaps)
        else:
            st = localswap(inst, n_iters=polish_iters, seed=seed,
                           slots0=slots_warm, tol=tol)
            slots, n_swaps = st.slots, int(st.n_swaps)
    t3 = time.perf_counter()
    if red.kind == "chain":
        groups = tuple((j,) for j in red.path)
    elif red.kind == "tree":
        groups = red.levels
    else:
        groups = ()
    return WarmStartReport(
        kind=red.kind, slots=slots, slots_warm=slots_warm,
        cont_cost=sol.cost, order=sol.order, bounds=bounds, groups=groups,
        solve_s=t1 - t0, map_s=t2 - t1, polish_s=t3 - t2, n_swaps=n_swaps)
