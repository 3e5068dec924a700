"""Plain PyTorch versions of the lookup and gain kernels.

Counterpart of ``repro.kernels.knn.ref``. Same semantics as the CUDA
kernels (kernels/knn/knn.py, kernels/knn/gains.py): per query the minimum
dissimilarity cost d(q, k)^γ and the argmin key index, ties broken toward
the lowest index (``torch.argmin`` keeps the first minimum). These are
what the wrappers run for tensors on the CPU, and what the kernels are
held against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.costs import approx_cost, approx_cost_from_distance

_INF = 3.0e38


def _dense_ca(queries: torch.Tensor, keys: torch.Tensor, metric: str,
              gamma: float) -> torch.Tensor:
    """Dense (Q, K) approximation-cost matrix C_a = d(q, k)^γ in f32, in
    the matmul form of ``core.costs.approx_cost`` (l2 clamped at 0 before
    the root) that the kernels compute."""
    return approx_cost(queries.float(), keys.float(), metric, gamma)


def _pair_ca(queries: torch.Tensor, keys: torch.Tensor, metric: str,
             gamma: float, block: int = 1 << 26) -> torch.Tensor:
    """:func:`_dense_ca` with each pair's dot product summed on its own
    (an elementwise product reduced over the feature axis, in query
    blocks of at most ``block`` elements). A plain matmul on the CPU sums
    a small batch (one row, or a few rows against many keys) in another
    order than a large one, which broke the engine's bucketed ≡
    unbucketed contract on the lookup's plain version; on CPU tensors
    this reduction follows only D, so a pair's value depends on neither
    the batch it came in nor the keys beside it. On the card, where the
    engine runs the kernels and never this version, a ``sum(-1)`` is
    not promised to be shape-independent (see
    ``core.costs.pairwise_distance_stable``)."""
    if metric == "l1":          # elementwise |q − k| sums: already per pair
        return _dense_ca(queries, keys, metric, gamma)
    q, k = queries.float(), keys.float()
    rows = max(1, block // max(k.shape[0] * k.shape[1], 1))
    dot = torch.cat([(q[s:s + rows, None, :] * k[None]).sum(-1)
                     for s in range(0, q.shape[0], rows)]) \
        if q.shape[0] else q.new_zeros((0, k.shape[0]))
    d2 = ((q * q).sum(-1)[:, None] + (k * k).sum(-1)[None, :]
          - 2.0 * dot).clamp_min(0.0)
    return approx_cost_from_distance(d2 if metric == "l2sq" else d2.sqrt(),
                                     gamma)


def knn_ref(queries: torch.Tensor, keys: torch.Tensor, metric: str = "l2",
            gamma: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel B: (min C_a per query, its argmin)."""
    cost = _pair_ca(queries, keys, metric, gamma)
    idx = torch.argmin(cost, dim=1).to(torch.int32)
    return cost.min(dim=1).values, idx


def placement_gains_ref(x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor,
                        cur: torch.Tensor, hreq: torch.Tensor,
                        metric: str = "l2", gamma: float = 1.0
                        ) -> torch.Tensor:
    """Oracle of the placement gains, materializing the (I, R, O, J) slack
    tensor — small instances only. Returns the (O, J) gains

        gain[o', j] = Σ_i Σ_r λ[i, r]·relu(cur[i, r] − C_a(x_r, y_o')
                                            − H[i, j])
    """
    ca = _dense_ca(x, y, metric, gamma)
    slack = (cur[:, :, None, None] - ca[None, :, :, None]
             - hreq[:, None, None, :])                       # (I, R, O, J)
    slack = torch.where(torch.isnan(slack), -torch.inf, slack)
    return (lam[:, :, None, None].float()
            * slack.clamp_min(0.0)).sum(dim=(0, 1))


def fused_lookup_ref(queries: torch.Tensor, keys: torch.Tensor,
                     h_key: torch.Tensor, meta: torch.Tensor,
                     metric: str = "l2", gamma: float = 1.0,
                     h_repo: float = 0.0, repo_level: int = -1,
                     fold_repo: bool = True) -> tuple[torch.Tensor, ...]:
    """Plain version of kernel A, the fused multi-level lookup.

    Invalid keys (meta row 3 == 0) are masked to +INF before the min; the
    repository wins only on strict improvement; ties among keys break to
    the lowest concatenated index. ``fold_repo=False`` returns the
    segment-local minimum, (+INF, 0, repo_level, 0, −1) when no valid key
    exists. Returns (cost, approx_cost, level, slot, payload).
    """
    ca = _pair_ca(queries, keys, metric, gamma)
    valid = (meta[3, :] > 0)[None, :]
    cost = torch.where(valid, ca + h_key[None, :].float(),
                       torch.full_like(ca, _INF))
    best = torch.argmin(cost, dim=1)
    bcost = cost.gather(1, best[:, None])[:, 0]
    rows = torch.arange(queries.shape[0], device=queries.device)
    bca = torch.where(valid[0, best], ca[rows, best],
                      torch.zeros_like(bcost))
    use_repo = (h_repo < bcost) if fold_repo else (bcost >= _INF)
    rcost = torch.full_like(bcost, h_repo) if fold_repo else bcost
    i32 = torch.int32
    return (torch.where(use_repo, rcost, bcost),
            torch.where(use_repo, torch.zeros_like(bca), bca),
            torch.where(use_repo, repo_level, meta[0, best]).to(i32),
            torch.where(use_repo, 0, meta[1, best]).to(i32),
            torch.where(use_repo, -1, meta[2, best]).to(i32))
