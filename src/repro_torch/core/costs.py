"""Dissimilarity and retrieval cost models (paper §2).

A request r = (o, i) served by approximizer α = (o', j) costs

    C(r, α) = C_a(o, o') + h(i, j)

where ``C_a`` is a non-negative dissimilarity cost and ``h`` the retrieval
(network) cost. Counterpart of ``repro.core.costs``: the same two
distance forms, on torch tensors of any device.
"""
from __future__ import annotations

import numpy as np
import torch

METRICS = ("l1", "l2", "l2sq")


def _check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(
            f"unknown metric {metric!r}; expected one of {METRICS}")


def pairwise_distance(x: torch.Tensor, y: torch.Tensor,
                      metric: str = "l1") -> torch.Tensor:
    """Pairwise distances between rows of ``x`` (n, p) and ``y`` (m, p).

    ``l2sq`` is the squared Euclidean distance (monotone in l2, so argmins
    agree). The l2 forms use the matmul identity |x|² + |y|² − 2x·y.
    """
    _check_metric(metric)
    if metric == "l1":
        return (x[:, None, :] - y[None, :, :]).abs().sum(-1)
    x2 = (x * x).sum(-1)[:, None]
    y2 = (y * y).sum(-1)[None, :]
    d2 = (x2 + y2 - 2.0 * (x @ y.T)).clamp_min(0.0)
    return d2 if metric == "l2sq" else d2.sqrt()


def approx_cost_from_distance(dist: torch.Tensor,
                              gamma: float) -> torch.Tensor:
    """C_a = f(d) with the paper's power law f(d) = d^γ (γ ≥ 0)."""
    if gamma == 1.0:
        return dist
    return dist.clamp_min(0.0).pow(gamma)


def approx_cost(x: torch.Tensor, y: torch.Tensor, metric: str = "l1",
                gamma: float = 1.0) -> torch.Tensor:
    """Pairwise approximation-cost matrix C_a(x_r, y_c) = d(x_r, y_c)^γ."""
    return approx_cost_from_distance(pairwise_distance(x, y, metric), gamma)


def pairwise_distance_stable(x: torch.Tensor, y: torch.Tensor,
                             metric: str = "l1") -> torch.Tensor:
    """Shape-stable pairwise distances: the same (row, col) pair gives the
    *same f32 bits* whether computed as one column, a k-candidate batch,
    a row block or the full matrix.

    The incremental control-plane ops (``gain_at``, ``apply_pick``, the
    best-two tables and the swap deltas) rely on it: with the matmul
    form a candidate already folded into the running cost vector can
    come back with a phantom positive gain. A reduction over the feature
    axis (``sum(-1)``) does not give that promise on CUDA, where the
    reduction strategy may follow the output shape, so the feature axis
    is accumulated here in an explicit ascending loop of elementwise
    ops, whose result for a pair cannot depend on the batch shape.
    (The CPU and the card agree to rounding, not bit for bit.) Memory:
    one (n, m) accumulator and one (n, m) temporary.
    """
    _check_metric(metric)
    acc = torch.zeros((x.shape[0], y.shape[0]), dtype=torch.float32,
                      device=x.device)
    for d in range(x.shape[1]):
        diff = x[:, d, None] - y[None, :, d]
        if metric == "l1":
            acc.add_(diff.abs_())
        else:
            acc.add_(diff.mul_(diff))
    return acc.sqrt_() if metric == "l2" else acc


def approx_cost_stable(x: torch.Tensor, y: torch.Tensor, metric: str = "l1",
                       gamma: float = 1.0) -> torch.Tensor:
    """Shape-stable C_a (see :func:`pairwise_distance_stable`)."""
    return approx_cost_from_distance(pairwise_distance_stable(x, y, metric),
                                     gamma)


def approx_cost_np(x: np.ndarray, y: np.ndarray, metric: str = "l1",
                   gamma: float = 1.0, block: int = 4096) -> np.ndarray:
    """Blocked host-side C_a for large catalogs, computed with torch on
    the CPU in row blocks of ``block``."""
    out = np.empty((x.shape[0], y.shape[0]), dtype=np.float32)
    yt = torch.as_tensor(np.asarray(y, np.float32))
    for s in range(0, x.shape[0], block):
        xs = torch.as_tensor(np.asarray(x[s:s + block], np.float32))
        out[s:s + block] = approx_cost(xs, yt, metric, gamma).numpy()
    return out


INF = np.float32(np.inf)
