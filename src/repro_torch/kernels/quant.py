"""Per-row int8 quantization and admissible lower-bound distance blocks.

Counterpart of ``repro.kernels.quant``. The compressed first pass of the
lookup (kernels/knn/ops.py) and of the gain oracle (kernels/knn/gains.py)
quantize per-row symmetric int8 through :func:`quantize_int8` and score
pairs with *certified lower bounds* on the exact distance between the
original f32 rows, from their int8 images alone:

    d(q, k)  ≥  d(q~, k~) − r_q − r_k                 (triangle inequality)

where q~ = dequantize(quantize(q)) and r_q ≥ ‖q − q~‖ is a per-row radius
derived from the quantization scale. Every step on top of that inequality
is made directionally safe against f32 rounding by explicit slack factors
(standard per-op error bounds, inflated 4×), so

    exact C_a(q, k) = d(q, k)^γ ≥ lb_approx_cost(q~, k~)

holds for every pair. That is what makes ``lookup(..., quantize=True,
verify=True)`` exact by construction. The slack assumes IEEE fp32
products: TF32 would break it, and ``repro_torch`` switches TF32 off
where it initialises.

Error budget per element (symmetric scale s = amax / 127): rounding to
the int8 grid ≤ s/2, f32 rounding of the division ≤ 127·eps·s, of the
dequantized product ≤ 127·eps·s; so |x − x~| ≤ s·(0.5 + 254·eps) <
s·ELEM_ERR with ELEM_ERR = 0.5005. Row radii follow by norm equivalence:
r = ELEM_ERR·s·√D (l2 family), r = ELEM_ERR·s·D (l1).

A row of exact zeros gets scale 0.0 (it quantizes and dequantizes to
exact zeros, radius 0); a sub-denormal row (amax < 127·F32_TINY) clamps
its scale to the smallest normal f32, so the division never produces inf
or NaN. Denormal elements are flushed to zero first, as XLA flushes
them. ``torch.round`` rounds half to even like ``jnp.round``, and the
scale and the division are single IEEE operations, so ``q``, ``scale``
and the dequantized rows equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

F32_TINY = 1.1754944e-38      # smallest normal f32
F32_EPS = 1.1920929e-07       # f32 machine epsilon
ELEM_ERR = 0.5005             # per-element |x − x~| ≤ ELEM_ERR·scale
_SQRT_DEFLATE = 1.0 - 4.0 * F32_EPS
_POW_DEFLATE = 1.0 - 8.0 * F32_EPS


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (trailing dim) symmetric int8 quantization.

    Returns (q int8, scale f32 with keepdim). All-zero rows get scale
    exactly 0.0, and ``dequantize_int8(q, 0.0) == 0`` bit for bit.
    """
    xf = x.float()
    if x.dim() == 0:
        xf = xf[None]
    tiny = torch.tensor(F32_TINY, dtype=torch.float32, device=xf.device)
    # XLA flushes denormal inputs to zero (on its CPU and on the TPU); the
    # flush is explicit here so that q and the scale are the reference's
    # on every device
    xf = torch.where(xf.abs() < tiny, torch.zeros_like(xf), xf)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0.0, torch.maximum(amax / 127.0, tiny),
                        torch.zeros_like(amax))
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def quant_row_radius(scale: torch.Tensor, dim: int,
                     metric: str) -> torch.Tensor:
    """Per-row radius r ≥ d_metric(x, x~) from the quantization scale;
    ``dim`` is the unpadded feature count. For the l2 family the radius
    is in distance units (l2sq callers subtract it from the un-squared
    distance)."""
    if metric in ("l2", "l2sq"):
        return scale * (ELEM_ERR * float(dim) ** 0.5)
    if metric == "l1":
        return scale * (ELEM_ERR * float(dim))
    raise ValueError(f"unknown metric {metric!r}")


class QuantizedRows(NamedTuple):
    """int8 image of a row tensor and what the lb blocks consume.

    The dequantized rows are not stored (the 4× memory saving is the
    point); consumers rematerialize tiles with :func:`dequantize_int8`,
    which is deterministic, so ``sq_norm`` stays consistent with any
    tile-local recompute."""
    q: torch.Tensor          # (N, D) int8
    scale: torch.Tensor      # (N, 1) f32, 0.0 for all-zero rows
    radius: torch.Tensor     # (N,)  f32, metric-space error radius
    sq_norm: torch.Tensor    # (N,)  f32, Σ dequantized² (l2 family; 0 l1)


def quantize_rows(x: torch.Tensor, metric: str,
                  dim: int | None = None) -> QuantizedRows:
    """Quantize a row tensor and precompute the lb blocks' side tables.
    ``dim`` overrides the radius dimension when the trailing axis carries
    zero padding."""
    q, scale = quantize_int8(x)
    radius = quant_row_radius(scale[:, 0], x.shape[-1] if dim is None
                              else dim, metric)
    if metric in ("l2", "l2sq"):
        deq = dequantize_int8(q, scale)
        sq_norm = (deq * deq).sum(dim=-1)
    else:
        sq_norm = torch.zeros(x.shape[:-1], dtype=torch.float32,
                              device=x.device)
    return QuantizedRows(q=q, scale=scale, radius=radius, sq_norm=sq_norm)


def _dot_slack(dim: int) -> float:
    """Directed f32 slack factor of the |q|² + |k|² − 2q·k contraction:
    absolute error ≤ _dot_slack(D)·(|q|² + |k|²)."""
    return 4.0 * (dim + 4.0) * F32_EPS


def lb_distance_block(qd: torch.Tensor, kd: torch.Tensor, rq: torch.Tensor,
                      rk: torch.Tensor, metric: str,
                      q_sq: torch.Tensor | None = None,
                      k_sq: torch.Tensor | None = None) -> torch.Tensor:
    """(B, K) certified lower bound on d_metric(orig_q, orig_k) from the
    dequantized rows ``qd``/``kd`` and their radii; for ``l2sq`` the bound
    is on the squared distance."""
    dim = qd.shape[-1]
    rpair = rq[:, None] + rk[None, :]
    if metric in ("l2", "l2sq"):
        q_sq = (qd * qd).sum(dim=-1) if q_sq is None else q_sq
        k_sq = (kd * kd).sum(dim=-1) if k_sq is None else k_sq
        d2 = q_sq[:, None] + k_sq[None, :] - 2.0 * (qd @ kd.T)
        slack = _dot_slack(dim) * (q_sq[:, None] + k_sq[None, :])
        d = (d2 - slack).clamp_min(0.0).sqrt() * _SQRT_DEFLATE
        lb = (d - rpair).clamp_min(0.0)
        if metric == "l2sq":
            # fl(lb·lb) ≤ lb²·(1+eps): one more deflate keeps it under
            return (lb * lb) * _SQRT_DEFLATE
        return lb
    if metric == "l1":
        d1 = (qd[:, None, :] - kd[None, :, :]).abs().sum(dim=-1)
        # non-negative summands: the summation error is ≤ D·eps·d1
        d1 = d1 * (1.0 - 4.0 * dim * F32_EPS)
        return (d1 - rpair).clamp_min(0.0)
    raise ValueError(f"unknown metric {metric!r}")


def lb_approx_cost_block(qd: torch.Tensor, kd: torch.Tensor,
                         rq: torch.Tensor, rk: torch.Tensor, metric: str,
                         gamma: float, q_sq: torch.Tensor | None = None,
                         k_sq: torch.Tensor | None = None) -> torch.Tensor:
    """(B, K) certified lower bound on C_a = d(orig_q, orig_k)^γ: x ↦ x^γ
    is monotone for γ ≥ 0, and one deflate absorbs the power's
    rounding."""
    lb = lb_distance_block(qd, kd, rq, rk, metric, q_sq=q_sq, k_sq=k_sq)
    if gamma == 1.0:
        return lb
    return torch.pow(lb, gamma) * _POW_DEFLATE


def lb_approx_cost_tiles(queries: torch.Tensor, kq: QuantizedRows,
                         metric: str, gamma: float,
                         dim: int | None = None) -> torch.Tensor:
    """(B, K) lower-bound C_a of a query batch against pre-quantized
    keys, quantizing the queries on the fly."""
    dim = queries.shape[-1] if dim is None else dim
    qq, qs = quantize_int8(queries)
    qd = dequantize_int8(qq, qs)
    rq = quant_row_radius(qs[:, 0], dim, metric)
    kd = dequantize_int8(kq.q, kq.scale)
    return lb_approx_cost_block(qd, kd, rq, kq.radius, metric, gamma,
                                k_sq=kq.sq_norm)
