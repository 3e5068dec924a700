"""Analytic hit-rate plane: the Che characteristic-time approximation
generalized to *similarity* caches, composed along forwarding paths.

Counterpart of ``repro.core.analysis.hitrate`` ("Computing the Hit Rate
of Similarity Caching", arXiv 2209.03174, and the classic Che/TTL
toolbox of Icarus ``tools/cacheperf.py``).

**Classic Che (one LRU cache).** Under IRM demand λ, a cache of
capacity ``C`` behaves as if every content were cached for a fixed
*characteristic time* T after its last request: the occupancy
probability is π_o = 1 − exp(−λ_o·T) and T solves Σ_o π_o = C.

**Similarity generalization (SIM-LRU / RND-LRU).** A stored key o
serves any request o′ in its *similarity ball* B(o) = {o′ :
C_a(o, o′) ≤ θ} — with probability q_{o′o} = 1 for SIM-LRU and
q_{o′o} = clamp(1 − C_a/θ, 0, 1) for RND-LRU. Timer resets are
exclusive (a stored key is refreshed only by the requests it serves:
the nearest cached ball member that answers), and hits are unions,
h_{o′} = 1 − Π_{o∈B(o′)} (1 − π_o·q_{o′o}). The per-cache constraint
Σ_o π_o = C closes the fixed point.

**Network composition.** Caches are composed along the per-ingress
forwarding paths ``core/routing.py`` serves (finite ``H[i, ·]`` in
ascending reach-cost order): the cache at path position p sees the miss
stream of the positions before it, a cache shared by several ingresses
sums their thinned streams, and a hit at (i, j) needs
C_a < h_repo[i] − H[i, j]. The whole system is solved by damped
fixed-point sweeps.

How the port splits the work:

* the ball structure, the occupancy model and the composition of
  :func:`predict_hitrates` are the reference's host f64 NumPy, copied
  line for line;
* the characteristic-time solve (:func:`_solve_tc`: 40 doubling steps,
  then 64 bisection steps) and the (ingress, cache) pass
  (:func:`_cache_pass`: an exclusive cumulative product by
  ``cumsum(log1p)``, then a scatter-add of the reset rates) are f32
  torch ops on ``device`` (CUDA unless the caller names another), as
  the reference's jitted functions are f32 with x64 off. Their inputs
  and outputs cross between host f64 and device f32 exactly where the
  reference's do, because those casts are part of the arithmetic;
* the scatter (:func:`_scatter_add`) sums in a fixed order on either
  device, so the refresh gate compares numbers that do not change from
  run to run: ``index_put_(accumulate=True)`` on CUDA, which sorts its
  indices (``index_add_`` is atomic there), and ``index_add_`` on the
  CPU, a serial loop in the reference's order (``index_put_`` is atomic
  there). The padding entries of the balls, whose contribution is
  exactly 0, are left out of it;
* :func:`similarity_balls` enumerates balls exactly, by direct f64
  differences on ``device`` (not the Gram form: a self-distance must be
  exactly 0), up to 20,000 objects. The LSH enumeration
  (``mode="lsh"``, and ``mode="auto"`` past 20,000 objects) comes with
  the pruned data plane, ROADMAP queue 1 item 10, and raises
  ``NotImplementedError`` until then.

torch's ``expm1``, ``log1p`` and ``exp`` and its sum orders are not
XLA's, and the bisection amplifies an ulp into T, so T, π and the
predictions match the reference's to a relative tolerance, not bitwise.

The serving engine uses the plane as a *surrogate cost oracle*
(:func:`surrogate_cost`): ``serve.engine.request_refresh`` prices the
observed-demand drift analytically (exact-hit balls — demand shape
only, no geometry) and skips the device placement solve when the
predicted cost moved less than ``EngineConfig.refresh_min_gain``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import costs
from repro_torch.core.topology import CacheNetwork

__all__ = ["SimilarityBalls", "HitRatePrediction", "similarity_balls",
           "exact_hit_balls", "solve_characteristic_time",
           "predict_hitrates", "surrogate_cost", "rescaled_coords"]

# the exact enumeration's ceiling: above it the reference enumerates by
# LSH, which is not ported yet
EXACT_MAX_OBJECTS = 20_000


# ======================================================================
# similarity balls
# ======================================================================
@dataclasses.dataclass(frozen=True)
class SimilarityBalls:
    """Padded neighbor structure of one catalog at one threshold θ.

    ``idx[o]`` holds the objects o′ with C_a(o, o′) ≤ θ (always
    including o itself, first), padded with ``n_objects``; ``q`` is the
    serve-probability weight q_{o′o} (SIM-LRU: 1 inside the ball;
    RND-LRU: 1 − C_a/θ), exactly 0 on padding; ``dist`` the C_a values
    (0 on padding). C_a is symmetric, so one structure serves both
    directions: "who can serve o" and "whom o refreshes".
    """
    idx: np.ndarray           # (O, M) int32, padded with n_objects
    q: np.ndarray             # (O, M) f32, 0 on padding
    dist: np.ndarray          # (O, M) f32 C_a, 0 on padding
    n_objects: int
    theta: float
    truncated: int = 0        # members dropped by max_ball

    @property
    def max_size(self) -> int:
        return self.idx.shape[1]

    @property
    def sizes(self) -> np.ndarray:
        return (self.q > 0.0).sum(axis=1)

    @property
    def mean_size(self) -> float:
        return float(self.sizes.mean())


def exact_hit_balls(n_objects: int) -> SimilarityBalls:
    """The degenerate θ=0 structure: every ball is {o} with q=1 — the
    classic Che model, no geometry needed (the engine surrogate's
    default)."""
    idx = np.arange(n_objects, dtype=np.int32)[:, None]
    return SimilarityBalls(idx=idx,
                           q=np.ones((n_objects, 1), np.float32),
                           dist=np.zeros((n_objects, 1), np.float32),
                           n_objects=n_objects, theta=0.0)


def _q_weights(dist: np.ndarray, theta: float, q_mode: str) -> np.ndarray:
    if q_mode == "hard":                       # SIM-LRU admission
        return (dist <= theta).astype(np.float32)
    if q_mode == "rnd":                        # RND-LRU serve probability
        return np.clip(1.0 - dist / max(theta, 1e-300), 0.0, 1.0) \
            .astype(np.float32)
    raise ValueError(f"unknown q_mode {q_mode!r} (expected 'hard'|'rnd')")


def _pack_rows(rows_idx: list, rows_d: list, n: int, theta: float,
               q_mode: str, max_ball: int | None) -> SimilarityBalls:
    """Pad per-object (indices, distances) lists into the rectangular
    structure; each row keeps its nearest ``max_ball`` members (self
    first, then ascending C_a — truncation drops the farthest, i.e. the
    lowest-q members first)."""
    sizes = np.fromiter((len(r) for r in rows_idx), np.int64, n)
    m = int(sizes.max()) if n else 1
    truncated = 0
    if max_ball is not None and m > max_ball:
        truncated = int(np.maximum(sizes - max_ball, 0).sum())
        m = max_ball
    m = max(m, 1)
    idx = np.full((n, m), n, np.int32)
    dist = np.zeros((n, m), np.float32)
    for o in range(n):
        ri = np.asarray(rows_idx[o], np.int32)
        rd = np.asarray(rows_d[o], np.float32)
        order = np.argsort(rd, kind="stable")       # self (d=0, first) stays
        ri, rd = ri[order][:m], rd[order][:m]
        idx[o, :ri.size] = ri
        dist[o, :ri.size] = rd
    q = _q_weights(dist, theta, q_mode)
    q[idx >= n] = 0.0
    return SimilarityBalls(idx=idx, q=q, dist=dist, n_objects=n,
                           theta=float(theta), truncated=truncated)


def _block_ca(x: torch.Tensor, y: torch.Tensor, metric: str,
              gamma: float) -> torch.Tensor:
    """(B, O) exact C_a in f64 on the tensors' device via direct
    differences — the reference's ``_block_ca_np`` arithmetic (not the
    Gram form, whose |x|²+|y|²−2x·y cancellation leaves a nonzero
    self-distance), column chunks of 2048 to bound the (B, Y, D)
    temporary."""
    out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.float64,
                      device=x.device)
    for s in range(0, y.shape[0], 2048):
        diff = x[:, None, :] - y[None, s:s + 2048, :]
        if metric == "l1":
            d = diff.abs().sum(dim=-1)
        elif metric in ("l2", "l2sq"):
            d2 = (diff * diff).sum(dim=-1)
            d = d2 if metric == "l2sq" else d2.sqrt()
        else:
            raise ValueError(f"unknown metric {metric!r}; "
                             f"expected one of {costs.METRICS}")
        out[:, s:s + 2048] = d if gamma == 1.0 else d ** gamma
    return out


def similarity_balls(coords: np.ndarray, theta: float, metric: str = "l2",
                     gamma: float = 1.0, q_mode: str = "hard",
                     mode: str = "auto", policy=None, block: int = 1024,
                     max_ball: int | None = None, seed: int = 0,
                     device: str | torch.device | None = None
                     ) -> SimilarityBalls:
    """Enumerate B(o) = {o′ : C_a(o, o′) ≤ θ} for every catalog object.

    ``mode='exact'`` runs a blocked O×O f64 distance pass on ``device``
    and keeps, per object, its members in ascending object order (the
    reference's ``np.nonzero``) before :func:`_pack_rows` sorts them by
    C_a. ``mode='auto'`` is exact up to 20,000 objects. The LSH mode
    (``mode='lsh'``, ``mode='auto'`` above 20,000 objects; ``policy``
    and ``seed`` are its arguments) raises ``NotImplementedError``
    until ROADMAP queue 1 item 10. ``q_mode`` sets the stored weights:
    'hard' (SIM-LRU indicator) or 'rnd' (RND-LRU 1 − C_a/θ). θ ≤ 0
    degenerates to exact-hit balls.
    """
    coords = np.asarray(coords, np.float32)
    n = coords.shape[0]
    if theta is None or theta <= 0.0:
        return exact_hit_balls(n)
    if mode == "auto":
        mode = "exact" if n <= EXACT_MAX_OBJECTS else "lsh"
    if mode == "lsh":
        raise NotImplementedError(
            "similarity_balls(mode='lsh') (the LSH candidate enumeration, "
            f"and mode='auto' above {EXACT_MAX_OBJECTS} objects) is not "
            "ported yet: ROADMAP queue 1 item 10")
    if mode != "exact":
        raise ValueError(f"unknown mode {mode!r} "
                         "(expected 'exact'|'lsh'|'auto')")
    dev = resolve_device(device)
    cj = torch.as_tensor(coords, device=dev).double()
    rows_idx: list = [None] * n
    rows_d: list = [None] * n
    for s in range(0, n, block):
        ca = _block_ca(cj[s:s + block], cj, metric, gamma)
        keep = ca <= theta
        # (row, col) pairs in row-major order: each row's members in
        # ascending object order, as np.nonzero gives them
        rc = keep.nonzero().cpu().numpy()
        dv = ca[keep].cpu().numpy()
        cuts = np.searchsorted(rc[:, 0], np.arange(1, ca.shape[0]))
        for b, (ri, rd) in enumerate(zip(np.split(rc[:, 1], cuts),
                                         np.split(dv, cuts))):
            rows_idx[s + b] = ri
            rows_d[s + b] = rd
    return _pack_rows(rows_idx, rows_d, n, theta, q_mode, max_ball)


# ======================================================================
# characteristic-time solver
# ======================================================================
def _occupancy_np(mu: np.ndarray, nu: np.ndarray, T: float) -> np.ndarray:
    """Host f64 stationary occupancy of the two-rate renewal model:

        π = expm1(μT) / (expm1(μT) + μ/ν)

    — a key enters at rate ν when absent (a global path miss inserts
    it) and is evicted T after its last *serve* (rate μ while present);
    E[busy] = (e^{μT} − 1)/μ against E[idle] = 1/ν gives the form
    above, which is EXACTLY classic Che π = 1 − e^{−λT} when μ = ν = λ
    (plain LRU: every request both inserts and refreshes).
    """
    mu = np.maximum(np.asarray(mu, np.float64), 1e-300)
    nu = np.asarray(nu, np.float64)
    if not np.isfinite(T):
        return (nu > 0.0).astype(np.float64)
    em = np.expm1(np.minimum(mu * T, 700.0))
    pi = em / (em + mu / np.maximum(nu, 1e-300))
    return np.where(nu > 0.0, pi, 0.0)


def _solve_tc(mu: torch.Tensor, nu: torch.Tensor, capacity: torch.Tensor,
              n_iters: int = 64) -> torch.Tensor:
    """Vectorized Che fixed point: the largest T with Σ_o π_o(T) ≤ C
    per cache row, for the two-rate occupancy of :func:`_occupancy_np`
    (μ = refresh rate while present, ν = entry rate while absent;
    μ = ν recovers the classic Σ (1 − e^{−λT}) = C).

    ``mu``/``nu`` are (J, O), ``capacity`` (J,), all f32 (the
    reference's jitted solve runs in f32 with x64 off). Σπ(T) is
    monotone increasing from 0 to the number of ν-positive objects, so
    40 doubling steps from the linear-regime guess bracket the root and
    ``n_iters`` bisection steps close it; a capacity at or above that
    count has no finite root and returns +inf, a zero capacity 0.
    Fixed step counts, as the reference's ``fori_loop``s.
    """
    mu = torch.clamp_min(mu.float(), 1e-30)
    nu = nu.float()
    cap = capacity.float()
    n_pos = (nu > 0.0).sum(dim=1).float()
    # small-T slope: π ≈ νT, so the linear-regime guess is C/Σν
    total = nu.sum(dim=1)
    ratio = mu / torch.clamp_min(nu, 1e-30)
    live = nu > 0.0

    def occ(T):
        em = torch.expm1(torch.clamp_max(mu * T[:, None], 60.0))
        pi = em / (em + ratio)
        return torch.where(live, pi, 0.0).sum(dim=1)

    # double from the linear-regime guess until f(hi) ≥ C (or give up
    # and report +inf — capacity not reachable)
    hi = torch.clamp_min(cap / torch.clamp_min(total, 1e-30), 1e-12)
    for _ in range(40):
        hi = torch.where(occ(hi) < cap, hi * 4.0, hi)
    lo = torch.zeros_like(hi)
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        below = occ(mid) < cap
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    T = 0.5 * (lo + hi)
    T = torch.where(cap >= n_pos, torch.inf, T)    # holds everything
    return torch.where(cap <= 0.0, 0.0, T)         # zero-capacity cache


def solve_characteristic_time(lam_eff: np.ndarray, capacities,
                              entry_rates: np.ndarray | None = None,
                              n_iters: int = 64,
                              device: str | torch.device | None = None
                              ) -> np.ndarray:
    """Che characteristic times T_C, one per cache.

    ``lam_eff`` — (J, O) or (O,) effective (timer-refresh) request
    rates; ``capacities`` — scalar or (J,) slot counts;
    ``entry_rates`` — optional (same shape) insertion rates when an
    object enters the cache on a different stream than it is refreshed
    by (similarity caches insert only on global path misses); defaults
    to ``lam_eff``, which is the classic Che solve
    Σ (1 − e^{−λT}) = C. Returns (J,) (or scalar for 1-D input) f64
    times; +inf when the cache can hold every requested object, 0.0
    for zero-capacity caches. The solve runs in f32 on ``device``.
    """
    dev = resolve_device(device)
    lam = np.asarray(lam_eff, np.float64)
    squeeze = lam.ndim == 1
    if squeeze:
        lam = lam[None, :]
    nu = lam if entry_rates is None else \
        np.asarray(entry_rates, np.float64).reshape(lam.shape)
    cap = np.broadcast_to(np.asarray(capacities, np.float64),
                          (lam.shape[0],))

    def f32(a):                       # host f64 → device f32, rounded
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    T = _solve_tc(f32(lam), f32(nu), f32(cap), n_iters=n_iters)
    T = T.cpu().numpy().astype(np.float64)
    return float(T[0]) if squeeze else T


def _scatter_add(n: int, index: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """(n,) bins of ``values`` summed at ``index``, in an order that
    does not change from run to run: on CUDA ``index_put_`` with
    accumulate, which sorts its indices (``index_add_`` is atomic
    there); on the CPU ``index_add_``, a serial loop in the order of
    ``values`` (``index_put_`` adds atomically there)."""
    out = values.new_zeros(n)
    if values.device.type == "cuda":
        return out.index_put_((index,), values, accumulate=True)
    return out.index_add_(0, index, values)


def _cache_pass(pi_row: torch.Tensor, rate_row: torch.Tensor,
                idx: torch.Tensor, q: torch.Tensor, dist: torch.Tensor,
                members: torch.Tensor | None = None):
    """One (ingress, cache) evaluation under *exclusive assignment*.

    A request o′ is served by the NEAREST cached ball member that
    answers, so with the ball sorted ascending by C_a and cache-state
    independence, member m serves o′ with probability

        s_m(o′) = π_m · q_m · reach_m,   reach_m = Π_{l<m} (1 − π_l·q_l)

    (every nearer member is absent or refuses). Returns, per object, f32
    on the inputs' device:

    * ``h[o′]``        = Σ_m s_m — probability o′ is served here;
    * ``lam_eff[o]``   = Σ_{o′: o ∈ B(o′)} R(o′)·q·reach — the timer
      reset rate of stored key o, scatter-added over the balls;
    * ``cost_num[o′]`` = Σ_m s_m·C_a — E[C_a·1{served here}];
    * ``s_self[o′]`` = π_{o′}·q_{o′o′} — the self term of h (0 when
      the slack mask removed it).

    ``pi_row`` and ``rate_row`` are (O,) f32; ``idx``, ``q`` and
    ``dist`` the (O, M) balls, padded gathers (idx = O) reading a
    trailing π = 0. ``members`` holds the flat positions of the
    non-padding entries of ``idx`` (computed here when None): only they
    enter the scatter, since a padding entry adds exactly 0 and all of
    them share one bin, where the sorted scatter would serialise them.
    """
    n = pi_row.shape[0]
    pi_pad = torch.cat([pi_row, pi_row.new_zeros(1)])
    pq = torch.clamp_max(pi_pad[idx] * q, 1.0 - 1e-6)    # (O, M)
    logs = torch.log1p(-pq)
    reach = torch.exp(torch.cumsum(logs, dim=1) - logs)  # exclusive cumprod
    s = pq * reach
    h = s.sum(dim=1)
    cost_num = (s * dist).sum(dim=1)
    contrib = rate_row[:, None] * q * reach
    if members is None:
        members = (idx.reshape(-1) < n).nonzero()[:, 0]
    lam_eff = _scatter_add(n, idx.reshape(-1)[members],
                           contrib.reshape(-1)[members])
    ar = torch.arange(n, device=idx.device)
    s_self = torch.where(idx[:, 0] == ar, s[:, 0], 0.0)
    return h, lam_eff, cost_num, s_self


# ======================================================================
# network fixed point
# ======================================================================
@dataclasses.dataclass(frozen=True)
class HitRatePrediction:
    """One solved analytic plane (all host f64 numpy).

    ``hit_prob[i, o]`` is the probability a request (o, ingress i) is
    served by *some* on-path cache; ``serve_prob[i, j, o]`` the
    probability it is served by cache j specifically (0 off-path);
    ``occupancy[j, o]`` the stationary π; ``T[j]`` the characteristic
    times. ``mean_cost`` prices eq. (1) on the predicted shares —
    E[C_a] from the exclusive-assignment serve shares plus reach and
    repo-miss costs.
    """
    T: np.ndarray              # (J,)
    occupancy: np.ndarray      # (J, O)
    hit_prob: np.ndarray       # (n_ingress, O)
    serve_prob: np.ndarray     # (n_ingress, J, O)
    hit_rate: float            # λ-weighted aggregate
    ingress_hit_rate: np.ndarray  # (n_ingress,)
    cache_hit_rate: np.ndarray    # (J,) share of all requests served there
    mean_cost: float           # predicted per-request cost, eq. (1)
    n_sweeps: int
    residual: float            # max |Δπ| of the last sweep

    @property
    def miss_rate(self) -> float:
        return 1.0 - self.hit_rate


def _paths(net: CacheNetwork) -> list[np.ndarray]:
    """Per-ingress forwarding paths — the exact rule of
    ``routing.StrategyPlane`` (finite H ascending, stable ties →
    lowest cache id)."""
    H = np.asarray(net.H, np.float64)
    out = []
    for i in range(net.n_ingress):
        fin = np.nonzero(np.isfinite(H[i]))[0]
        out.append(fin[np.argsort(H[i, fin], kind="stable")])
    return out


def predict_hitrates(net: CacheNetwork, lam: np.ndarray,
                     balls: SimilarityBalls, n_sweeps: int = 16,
                     damping: float = 0.6,
                     device: str | torch.device | None = None
                     ) -> HitRatePrediction:
    """Solve the similarity-Che fixed point over one cache network.

    ``lam`` — (n_ingress, O) request rates (any positive scale; costs
    and hit rates are per-request). ``balls`` — the catalog's
    similarity structure at the serving threshold (q already encodes
    SIM-LRU vs RND-LRU). Each sweep walks every ingress path once:
    per (ingress, cache) it evaluates the exclusive-assignment serve
    shares and reset rates from the current occupancies
    (:func:`_cache_pass`, f32 on ``device``), thins the arrival stream,
    then re-solves T_C per cache and damps the occupancy update
    (``damping`` = 1 is undamped). The composition is host f64.
    """
    dev = resolve_device(device)
    lam = np.asarray(lam, np.float64)
    n_ing, n_obj = lam.shape
    if balls.n_objects != n_obj:
        raise ValueError(f"balls were enumerated over {balls.n_objects} "
                         f"objects but lam has {n_obj}")
    J = net.n_caches
    H = np.asarray(net.H, np.float64)
    h_repo = np.asarray(net.h_repo, np.float64)
    caps = np.asarray(net.capacities, np.float64)
    paths = _paths(net)
    idx = torch.as_tensor(balls.idx.astype(np.int64), device=dev)
    dist = torch.as_tensor(balls.dist, device=dev)
    members = (idx.reshape(-1) < n_obj).nonzero()[:, 0]
    # per-(ingress, cache) ball pruning at the repo-cost slack: a hit at
    # (i, j) needs C_a < h_repo[i] − H[i, j] (routing.serve_one's
    # eligibility), so members past the slack can't serve or refresh;
    # the reference compares in f32, the slack rounded to f32
    q_ij: dict[tuple[int, int], torch.Tensor] = {}
    q_base = torch.as_tensor(balls.q, device=dev)
    for i in range(n_ing):
        for j in paths[i]:
            slack = np.float32(h_repo[i] - H[i, j])
            q_ij[(i, int(j))] = q_base * (dist < float(slack))

    def sweep_passes(pi):
        """One path walk: per-cache refresh (μ) and entry (ν) rates
        plus per-(ingress, cache) serve shares and cost numerators."""
        lam_eff = np.zeros((J, n_obj))
        hs: dict[tuple[int, int], np.ndarray] = {}
        cn: dict[tuple[int, int], np.ndarray] = {}
        s0: dict[tuple[int, int], np.ndarray] = {}
        for i in range(n_ing):
            stream = lam[i].copy()
            for j in paths[i]:
                # host f64 → device f32 in, device f32 → host f64 out
                ins = torch.as_tensor(
                    np.stack([pi[j], stream]).astype(np.float32),
                    device=dev)
                outs = torch.stack(_cache_pass(
                    ins[0], ins[1], idx, q_ij[(i, int(j))], dist,
                    members)).cpu().numpy().astype(np.float64)
                h, le, cnum, ss = outs
                lam_eff[j] += le
                hs[(i, int(j))] = h
                cn[(i, int(j))] = cnum
                s0[(i, int(j))] = ss
                stream = stream * (1.0 - hs[(i, int(j))])
        # entry rates: SIM/RND-LRU insert o at every traversed cache
        # only on a GLOBAL path miss, so ν_j(o) is the end-of-path miss
        # stream — with the factor at j itself conditioned on o being
        # absent there (h | o absent = (h − π_o·q_oo)/(1 − π_o·q_oo))
        nu = np.zeros((J, n_obj))
        for i in range(n_ing):
            gm = lam[i].copy()
            for j in paths[i]:
                gm = gm * (1.0 - hs[(i, int(j))])
            for j in paths[i]:
                h, ss = hs[(i, int(j))], s0[(i, int(j))]
                h_abs = (h - ss) / np.maximum(1.0 - ss, 1e-12)
                corr = (1.0 - h_abs) / np.maximum(1.0 - h, 1e-12)
                nu[j] += gm * np.minimum(corr, 1e12)
        return lam_eff, nu, hs, cn

    pi = np.zeros((J, n_obj))
    residual = np.inf
    for _ in range(n_sweeps):
        lam_eff, nu, hs, cn = sweep_passes(pi)
        T = solve_characteristic_time(lam_eff, caps, entry_rates=nu,
                                      device=dev)
        pi_new = np.zeros_like(pi)
        for j in range(J):
            if caps[j] <= 0:
                continue
            pi_new[j] = _occupancy_np(lam_eff[j], nu[j], T[j])
        residual = float(np.max(np.abs(pi_new - pi))) if J else 0.0
        pi = damping * pi_new + (1.0 - damping) * pi
        if residual < 1e-9:
            break

    # final serve/hit shares + predicted cost on the converged state
    lam_eff, nu, hs, cn = sweep_passes(pi)
    T = solve_characteristic_time(lam_eff, caps, entry_rates=nu,
                                  device=dev)
    serve = np.zeros((n_ing, J, n_obj))
    hit = np.zeros((n_ing, n_obj))
    cost = 0.0
    total = lam.sum()
    for i in range(n_ing):
        stream = lam[i].copy()
        for j in paths[i]:
            h = hs[(i, int(j))]
            serve[i, j] = stream * h
            # E[C_a·1{served at j}] + the reach cost of served mass
            cost += float(np.sum(stream * cn[(i, int(j))])
                          + np.sum(serve[i, j]) * H[i, j])
            stream = stream * (1.0 - h)
        hit[i] = 1.0 - np.divide(stream, lam[i], out=np.zeros(n_obj),
                                 where=lam[i] > 0)
        cost += float(np.sum(stream) * h_repo[i])

    served_mass = serve.sum(axis=(0, 2))
    ing_mass = lam.sum(axis=1)
    return HitRatePrediction(
        T=np.asarray(T), occupancy=pi, hit_prob=hit, serve_prob=serve,
        hit_rate=float(served_mass.sum() / max(total, 1e-300)),
        ingress_hit_rate=np.divide(
            (lam * hit).sum(axis=1), ing_mass,
            out=np.zeros(n_ing), where=ing_mass > 0),
        cache_hit_rate=served_mass / max(total, 1e-300),
        mean_cost=cost / max(total, 1e-300),
        n_sweeps=n_sweeps, residual=residual)


# ======================================================================
# engine surrogate
# ======================================================================
def surrogate_cost(net: CacheNetwork, lam: np.ndarray,
                   balls: SimilarityBalls | None = None,
                   n_sweeps: int = 8,
                   device: str | torch.device | None = None) -> float:
    """Analytic per-request cost of ``net`` under demand ``lam`` — the
    cheap surrogate the streaming engine consults before paying for a
    device placement solve (serve/engine.request_refresh).

    Defaults to exact-hit balls (θ=0): the classic Che plane needs
    only the demand *shape*, runs in O(O·path) per call, and moves
    monotonically with demand drift — which is all the refresh gate
    needs. The engine's static placements are not LRU caches; this is
    a drift thermometer in cost units, not a placement evaluator.
    """
    lam = np.asarray(lam, np.float64)
    if balls is None:
        balls = exact_hit_balls(lam.shape[1])
    return predict_hitrates(net, lam, balls, n_sweeps=n_sweeps,
                            device=device).mean_cost


# ======================================================================
# catalog scale
# ======================================================================
# the rule by which the reference's hit-rate bench puts C_a on a
# network's cost scale: θ is SLACK_FRAC × the median on-path slack
# h_repo[i] − H[i, j], and the catalog is scaled so that θ is the
# BALL_QUANTILE of the distances of 4,096 random pairs
SLACK_FRAC = 0.4
BALL_QUANTILE = 0.01


def rescaled_coords(net: CacheNetwork, coords: np.ndarray,
                    seed: int) -> tuple[np.ndarray, float]:
    """``coords`` scaled by the hit-rate bench's rule (pairs drawn from
    ``np.random.default_rng(seed)``); returns the scaled f32 coordinates
    and θ."""
    H = np.asarray(net.H, np.float64)
    slacks = (np.asarray(net.h_repo, np.float64)[:, None] - H)[
        np.isfinite(H)]
    theta = SLACK_FRAC * float(np.median(slacks[slacks > 0]))
    coords = np.asarray(coords, np.float64)
    n = coords.shape[0]
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n, 4096), rng.integers(0, n, 4096)
    keep = a != b
    d = np.sqrt(((coords[a[keep]] - coords[b[keep]]) ** 2).sum(axis=1))
    scale = theta / float(np.quantile(d, BALL_QUANTILE))
    return (coords * scale).astype(np.float32), theta
