"""Continuous-limit placement (paper §4).

Counterpart of ``repro.core.placement.continuous``:

* ζ(γ) and the single-cache optimum, eqs. (5)–(8)   → :func:`zeta`,
  :func:`single_cache_cost`, :func:`single_cache_allocation`;
* the chain-topology convex program (11)             → :func:`chain_cost`,
  :func:`solve_chain` (mirror descent / exponentiated gradient) and
  :func:`solve_chain_thresholds` (exploits the Prop 4.2 threshold
  structure: cache j serves a contiguous popularity band);
* equi-depth trees, Prop 4.4                         → :func:`tree_cost`
  (replicate the chain solution; cost is degree-1 homogeneous in λ);
* the tandem network with arrivals at both nodes, eqs. (14)–(15)
  → :func:`tandem_both_cost`, :func:`solve_tandem_both`,
  :func:`tandem_both_grad` (hand-coded (15), used to cross-check
  autodiff);
* the uniform-λ shifted-tessellation geometry of Fig. 2:
  z = max{0, (r−h)/2}, Δc = (8/3)·z³ for γ=1         → closed form
  :func:`shifted_tessellation_cost` plus a general-γ numerical
  integration :func:`shifted_tessellation_cost_numeric`.

The NumPy and float parts are the reference's, line for line.
:func:`chain_cost` and :func:`tandem_both_cost` are functions of torch
tensors, and the two descents are fixed-iteration loops on ``device``
(CUDA unless the caller names another) whose gradient is
``torch.autograd.grad``. They run in f32 as the reference's jitted
loops do, the step ``lr/√(1 + t/s)`` included (an f32 tensor, never a
Python double). Every ``max(·, 0)`` that a gradient passes through
splits the gradient in half at a tie, which is JAX's rule for
``jnp.maximum`` (``torch.clamp_min`` would pass it whole). What is left
between the two frameworks is rounding: their pow, logsumexp and sum
orders, and XLA's rewrite of the step into an FMA and an approximate
rsqrt (within 2 ulp of the f32 formula), so a descent's output matches
the reference's to a tolerance, not bitwise.

Conventions: M regions of unit area with piecewise-constant rates
``lams`` (the paper's discretization); caches 1..N have sizes ``ks`` and
cumulative reach costs ``hs`` (h₁ = 0 at the ingress leaf); the
repository is an extra virtual cache with k = ∞ and cost ``h_repo``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device


def zeta(gamma: float) -> float:
    """ζ ≜ 2^{(2−γ)/2}/(γ+2) — the norm-1 square-cell constant (§4.1)."""
    return 2.0 ** ((2.0 - gamma) / 2.0) / (gamma + 2.0)


def cell_cost(r: float, lam: float, gamma: float) -> float:
    """c(r) = 4 λ r^{γ+2}/(γ+2): approximation cost inside one square cell
    of radius r under norm-1 (eq. 5, two-dimensional domain)."""
    return 4.0 * lam * r ** (gamma + 2.0) / (gamma + 2.0)


# ------------------------------------------------------------- single cache
def single_cache_allocation(lams: np.ndarray, k: float, gamma: float) -> np.ndarray:
    """Optimal slots per region, k_i ∝ λ_i^{2/(γ+2)} (Lagrange, §4.1)."""
    w = lams ** (2.0 / (gamma + 2.0))
    return k * w / w.sum()


def single_cache_cost(lams: np.ndarray, k: float, gamma: float) -> float:
    """min C(k) = ζ k^{−γ/2} (Σ_i λ_i^{2/(γ+2)})^{(γ+2)/2}  (eq. 7)."""
    s = float(np.sum(lams ** (2.0 / (gamma + 2.0))))
    return zeta(gamma) * k ** (-gamma / 2.0) * s ** ((gamma + 2.0) / 2.0)


# ------------------------------------------------------------------- chains
@dataclasses.dataclass(frozen=True)
class ChainSpec:
    ks: tuple            # (N,) cache sizes
    hs: tuple            # (N,) cumulative costs from the ingress, h[0] = 0
    h_repo: float        # cost of the authoritative repository
    gamma: float = 1.0

    @property
    def n(self) -> int:
        return len(self.ks)


class _Maximum(torch.autograd.Function):
    """max(x, c) for a constant c, with JAX's gradient: where x == c the
    incoming gradient is halved (``lax.max`` splits it between its two
    operands), where x < c it is 0."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.save_for_backward(x)
        ctx.c = c
        return x.clamp_min(c)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        g = torch.where(x > ctx.c, g, torch.where(x == ctx.c, 0.5 * g,
                                                   torch.zeros_like(g)))
        return g, None


def _maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    return _Maximum.apply(x, c)


def _steps(lr: float, iters: int, scale: float,
           device: torch.device) -> torch.Tensor:
    """(iters,) f32 step sizes lr/√(1 + t/scale), t the loop counter:
    the reference computes them in f32 inside its jitted loop. NumPy's
    f32 division and square root are correctly rounded (torch's
    vectorized CPU sqrt is not always), so every device gets the same
    steps."""
    t = np.arange(iters, dtype=np.float32)
    steps = np.float32(lr) / np.sqrt(np.float32(1.0) + t / np.float32(scale))
    return torch.as_tensor(steps, device=device)


def chain_cost(w: torch.Tensor, lams: torch.Tensor,
               spec: ChainSpec) -> torch.Tensor:
    """Objective (11). ``w``: (M, N+1) rows on the simplex; column j < N is
    the fraction of region i served by cache j, column N the repository."""
    g = spec.gamma
    beta = 2.0 / (g + 2.0)
    lb = lams ** beta
    cost = 0.0
    for j in range(spec.n):
        wj = w[:, j]
        mass = torch.sum(wj * lb)
        cost += zeta(g) * spec.ks[j] ** (-g / 2.0) * \
            _maximum(mass, 0.0) ** (1.0 / beta)
        cost += spec.hs[j] * torch.sum(wj * lams)
    cost += spec.h_repo * torch.sum(w[:, spec.n] * lams)
    return cost


def _solve_chain_md(lams: torch.Tensor, spec: ChainSpec, iters: int,
                    lr: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Exponentiated-gradient (mirror) descent on the per-region simplices.

    (11) is convex over the product of simplices, so mirror descent with a
    modest step count converges to the global optimum; autograd supplies
    ∇_w of (11) exactly. No host synchronisation inside the loop.
    """
    M = lams.shape[0]
    w = torch.full((M, spec.n + 1), 1.0 / (spec.n + 1),
                   dtype=torch.float32, device=lams.device)
    steps = _steps(lr, iters, 50.0, lams.device)
    for t in range(iters):
        w.requires_grad_(True)
        gradw, = torch.autograd.grad(chain_cost(w, lams, spec), w)
        w = w.detach()
        # per-region gradient normalization: each simplex row gets its own
        # scale, so heterogeneous magnitudes (e.g. huge h_repo) cannot
        # freeze the other coordinates
        gradw = gradw / (gradw.abs().amax(dim=1, keepdim=True) + 1e-12)
        logw = torch.log(w.clamp_min(1e-30)) - steps[t] * gradw
        logw = logw - torch.logsumexp(logw, dim=1, keepdim=True)
        w = torch.exp(logw)
    with torch.no_grad():
        return w, chain_cost(w, lams, spec)


def solve_chain(lams: np.ndarray, spec: ChainSpec, iters: int = 4000,
                lr: float = 1.0, device: str | torch.device | None = None
                ) -> tuple[np.ndarray, float]:
    dev = resolve_device(device)
    w, c = _solve_chain_md(
        torch.as_tensor(np.asarray(lams, np.float32), device=dev), spec,
        iters, lr)
    return w.cpu().numpy(), float(c)


def _interp_prefix(cum: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Linear interpolation of a prefix-sum array at fractional indices.

    Equals ``np.interp(pos, np.arange(len(cum)), cum)`` for pos clipped
    to [0, len(cum)−1] — but O(1) per point instead of materializing an
    O(M)-sized arange per call, which is what keeps the golden-section
    coordinate descent of :func:`solve_chain_thresholds` at millisecond
    scale on 10⁶–10⁷-region instances (the warm-start regime)."""
    idx = np.clip(np.floor(pos).astype(np.int64), 0, cum.shape[0] - 2)
    frac = pos - idx
    return cum[idx] + frac * (cum[idx + 1] - cum[idx])


def _band_cost(lams_sorted: np.ndarray, cum_lb: np.ndarray, cum_l: np.ndarray,
               splits: np.ndarray, spec: ChainSpec) -> float:
    """Cost of the threshold allocation given fractional split points.

    ``splits`` are N nondecreasing cumulative coordinates in [0, M]; cache
    j serves the (fractional) band [splits[j-1], splits[j]) of the
    λ-descending-sorted regions; the repository serves the tail.
    ``cum_lb``/``cum_l`` are prefix sums of λ^{2/(γ+2)} and λ with a
    leading 0, linearly interpolated for fractional boundaries (a region
    split across caches contributes proportionally — the "portion of a
    region" of Prop 4.2).
    """
    g = spec.gamma
    pos = np.concatenate([[0.0], splits, [float(len(lams_sorted))]])
    pos = np.maximum.accumulate(np.clip(pos, 0.0, len(lams_sorted)))
    ilb = _interp_prefix(cum_lb, pos)
    il = _interp_prefix(cum_l, pos)
    cost = 0.0
    for j in range(spec.n):
        W = max(ilb[j + 1] - ilb[j], 0.0)
        lam_mass = max(il[j + 1] - il[j], 0.0)
        cost += zeta(g) * spec.ks[j] ** (-g / 2.0) * W ** ((g + 2.0) / 2.0)
        cost += spec.hs[j] * lam_mass
    cost += spec.h_repo * max(il[spec.n + 1] - il[spec.n], 0.0)
    return float(cost)


def solve_chain_thresholds(lams: np.ndarray, spec: ChainSpec,
                           sweeps: int = 60, grid: int = 96
                           ) -> tuple[np.ndarray, float, np.ndarray]:
    """Prop 4.2 structure: coordinate descent over N split points of the
    popularity-sorted axis (each 1-D problem solved by golden section).

    Returns (splits, cost, order) with ``order`` the λ-descending region
    permutation; the popularity thresholds λ*_j of Prop 4.2 are
    ``lams[order][ceil(splits)]``.
    """
    order = np.argsort(-lams, kind="stable")
    ls = lams[order].astype(np.float64)
    g = spec.gamma
    cum_lb = np.concatenate([[0.0], np.cumsum(ls ** (2.0 / (g + 2.0)))])
    cum_l = np.concatenate([[0.0], np.cumsum(ls)])
    M = float(len(ls))
    splits = np.linspace(M / (spec.n + 1), M * spec.n / (spec.n + 1), spec.n)

    def cost_at(j, x):
        trial = splits.copy()
        trial[j] = x
        return _band_cost(ls, cum_lb, cum_l, trial, spec)

    gr = (np.sqrt(5.0) - 1.0) / 2.0
    for _ in range(sweeps):
        moved = 0.0
        for j in range(spec.n):
            lo = splits[j - 1] if j > 0 else 0.0
            hi = splits[j + 1] if j + 1 < spec.n else M
            # golden-section over [lo, hi] (cost is unimodal along each
            # coordinate by convexity of (11) restricted to the band line)
            a, b = lo, hi
            c1, c2 = b - gr * (b - a), a + gr * (b - a)
            f1, f2 = cost_at(j, c1), cost_at(j, c2)
            for _ in range(grid):
                if f1 < f2:
                    b, c2, f2 = c2, c1, f1
                    c1 = b - gr * (b - a)
                    f1 = cost_at(j, c1)
                else:
                    a, c1, f1 = c1, c2, f2
                    c2 = a + gr * (b - a)
                    f2 = cost_at(j, c2)
            xnew = 0.5 * (a + b)
            moved = max(moved, abs(xnew - splits[j]))
            splits[j] = xnew
        if moved < 1e-10 * M:
            break
    return splits, _band_cost(ls, cum_lb, cum_l, splits, spec), order


def thresholds_to_w(lams: np.ndarray, splits: np.ndarray, order: np.ndarray,
                    n_caches: int) -> np.ndarray:
    """Convert Prop 4.2 split points into the w matrix of (11).

    Splits are sanitized the same way :func:`_band_cost` evaluates them —
    clipped to [0, M] and made nondecreasing — so out-of-range inputs
    (e.g. total cache capacity exceeding the catalog mass, which pushes
    the unconstrained optimum past M) still yield a row-stochastic w:
    every region row sums to 1 and column j's mass equals band j's width.
    """
    M = len(lams)
    w = np.zeros((M, n_caches + 1))
    pos = np.concatenate([[0.0], np.asarray(splits, np.float64), [float(M)]])
    pos = np.maximum.accumulate(np.clip(pos, 0.0, float(M)))
    for j in range(n_caches + 1):
        lo, hi = pos[j], pos[j + 1]
        for i in range(int(np.floor(lo)), int(np.ceil(hi))):
            frac = min(hi, i + 1.0) - max(lo, float(i))
            if frac > 0:
                w[order[i], j] += frac
    return w


# -------------------------------------------------------- equi-depth trees
def tree_cost(lams: np.ndarray, betas: np.ndarray, spec: ChainSpec,
              use_thresholds: bool = True,
              device: str | torch.device | None = None) -> float:
    """Prop 4.4: optimal equi-depth-tree cost = Σ_ℓ β_ℓ × (chain cost for
    the base rate λ). Each level replicates the chain allocation.
    ``device`` is where the mirror descent runs (``use_thresholds=False``
    only)."""
    if use_thresholds:
        _, c, _ = solve_chain_thresholds(lams, spec)
    else:
        _, c = solve_chain(lams, spec, device=device)
    return float(np.sum(betas) * c)


# ------------------------------------- tandem with arrivals at both nodes
def tandem_both_cost(w1: torch.Tensor, lams: torch.Tensor, k1, k2, h, beta,
                     gamma) -> torch.Tensor:
    """Eq. (14): leaf keeps fraction w1_i of region i, forwards the rest
    (its cell-border requests) to the parent; the parent also serves its
    own arrivals β·λ. No repository (the parent covers the domain).

    The scalars may be Python floats (their arithmetic then runs in f64,
    as the reference's does outside ``jit``) or 0-dim f32 tensors (f32, as
    inside the reference's jitted solve)."""
    g = gamma
    e = 2.0 / (2.0 + g)
    lb = lams ** e
    t1 = zeta(g) * k1 ** (-g / 2.0) * \
        _maximum(torch.sum(lb * w1), 0.0) ** (1.0 / e)
    inner = beta + _maximum(1.0 - w1, 0.0) ** ((g + 2.0) / 2.0)
    t2 = zeta(g) * k2 ** (-g / 2.0) * \
        torch.sum(lb * inner ** e) ** (1.0 / e)
    t3 = h * torch.sum(lams * (1.0 - w1))
    return t1 + t2 + t3


def tandem_both_grad(w1: np.ndarray, lams: np.ndarray, k1: float, k2: float,
                     h: float, beta: float, gamma: float) -> np.ndarray:
    """Hand-coded gradient (15) — used to cross-check JAX autodiff."""
    g = gamma
    e = 2.0 / (2.0 + g)
    lb = lams ** e
    A = np.sum(lb * w1)
    term1 = zeta(g) * k1 ** (-g / 2.0) * (1.0 / e) * A ** (g / 2.0) * lb
    inner = beta + (1.0 - w1) ** ((g + 2.0) / 2.0)
    B = np.sum(lb * inner ** e)
    dinner = -((g + 2.0) / 2.0) * (1.0 - w1) ** (g / 2.0)
    term2 = zeta(g) * k2 ** (-g / 2.0) * (1.0 / e) * B ** (g / 2.0) * \
        lb * e * inner ** (e - 1.0) * dinner
    term3 = -h * lams
    return term1 + term2 + term3


def _solve_tandem_both(lams, k1, k2, h, beta, gamma, iters: int,
                       lr: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Projected gradient on w1 ∈ [0,1]^M (convex in w1 → global opt).
    The scalars are 0-dim f32 tensors, as the reference's traced
    arguments are."""
    M = lams.shape[0]
    w1 = torch.full((M,), 0.5, dtype=torch.float32, device=lams.device)
    steps = _steps(lr, iters, 100.0, lams.device)
    for t in range(iters):
        w1.requires_grad_(True)
        gw, = torch.autograd.grad(
            tandem_both_cost(w1, lams, k1, k2, h, beta, gamma), w1)
        w1 = w1.detach()
        gw = gw / (gw.abs().amax() + 1e-12)
        # keep strictly below 1: at w1=1 with β=0 the parent term's
        # derivative d(x^e)/dx|_{x→0} = ∞ would poison the next gradient
        w1 = (w1 - steps[t] * gw).clamp(0.0, 1.0 - 1e-6)
    with torch.no_grad():
        return w1, tandem_both_cost(w1, lams, k1, k2, h, beta, gamma)


def solve_tandem_both(lams: np.ndarray, k1: float, k2: float, h: float,
                      beta: float, gamma: float = 1.0, iters: int = 4000,
                      lr: float = 0.05,
                      device: str | torch.device | None = None
                      ) -> tuple[np.ndarray, float]:
    dev = resolve_device(device)
    f32 = lambda x: torch.tensor(float(x), dtype=torch.float32,  # noqa
                                 device=dev)
    w1, c = _solve_tandem_both(
        torch.as_tensor(np.asarray(lams, np.float32), device=dev),
        f32(k1), f32(k2), f32(h), f32(beta), f32(gamma), iters, lr)
    return w1.cpu().numpy(), float(c)


# ------------------------------------ Fig 2: shifted regular tessellations
def shifted_tessellation_cost(k: int, h: float, area: float, lam: float,
                              beta: float = 1.0) -> float:
    """Closed-form total cost of the Fig 2 allocation, γ = 1, uniform λ.

    Leaf and parent each hold k slots; leaf cells are norm-1 squares of
    radius r = sqrt(area/(2k)); parent centroids sit at leaf-cell corners.
    z = max{0, (r−h)/2}; each parent slot reduces the leaf-arrival cost by
    Δc = λ·(8/3)·z³ (paper §4.4). Parent arrivals (rate β·λ per unit
    area) are approximated by the parent's own tessellation.
    """
    r = np.sqrt(area / (2.0 * k))
    z = max(0.0, (r - h) / 2.0)
    leaf_cost = k * cell_cost(r, lam, 1.0)            # k·(4/3)λr³
    saving = k * lam * (8.0 / 3.0) * z ** 3
    parent_cost = beta * k * cell_cost(r, lam, 1.0)
    return leaf_cost - saving + parent_cost


def shifted_tessellation_cost_numeric(k: int, h: float, area: float,
                                      lam: float, beta: float = 1.0,
                                      gamma: float = 1.0,
                                      samples: int = 512) -> float:
    """General-γ numerical version (quadrature over one tessellation
    period): leaf arrivals pay min(d_leaf^γ, d_parent^γ + h); parent
    arrivals pay d_parent^γ. Validates the γ=1 closed form and supplies
    the curves of Fig 6 for other γ."""
    r = np.sqrt(area / (2.0 * k))
    # period cell [0, 2r)²; leaf centers at (a·r, b·r), a+b even; parent
    # centers at a+b odd (the corners — maximally shifted, Fig 2)
    xs = (np.arange(samples) + 0.5) * (2.0 * r / samples)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    d_leaf = np.full_like(X, np.inf)
    d_par = np.full_like(X, np.inf)
    for a in range(-1, 4):
        for b in range(-1, 4):
            d = np.abs(X - a * r) + np.abs(Y - b * r)
            if (a + b) % 2 == 0:
                d_leaf = np.minimum(d_leaf, d)
            else:
                d_par = np.minimum(d_par, d)
    leaf_point = np.minimum(d_leaf ** gamma, d_par ** gamma + h)
    par_point = d_par ** gamma
    cell_area = (2.0 * r) ** 2
    n_cells = area / cell_area
    w = cell_area / X.size
    return float(n_cells * w * lam *
                 (np.sum(leaf_point) + beta * np.sum(par_point)))
