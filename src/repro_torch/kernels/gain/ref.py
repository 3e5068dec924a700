"""Plain PyTorch version of the GREEDY marginal-gain reduction.

gain[o', j] = Σ_r λ_r · relu(cur_r − C_a(x_r, y_{o'}) − H[r, j])

i.e. the total rate-weighted cost reduction of adding candidate object o'
at cache j, given the current per-request serving costs ``cur`` (paper
§3.2). ``H[r, j]`` is the retrieval cost from request r's ingress to
cache j (+inf ⇒ off-path ⇒ zero gain). Counterpart of
``repro.kernels.gain.ref``, with the same C_a (matmul form for l2/l2sq,
clamped at 0; |x − y| summed for l1; d^γ). The reference materializes
the (R, O, J) slack tensor at once; at R = O = 10⁵ that is 120 GB, so
this version sums request blocks of at most ``_BLOCK_ELEMS`` slack
elements, in request order. Kernel D (gain.py) is held against it on
the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.costs import approx_cost

_BLOCK_ELEMS = 1 << 26     # elements of one request block's temporaries


def gain_ref(x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor,
             cur: torch.Tensor, hreq: torch.Tensor, metric: str = "l2",
             gamma: float = 1.0) -> torch.Tensor:
    """x: (R, D) requests; y: (O, D) candidates; lam, cur: (R,);
    hreq: (R, J). Returns (O, J) gains, f32."""
    x, y = x.float(), y.float()
    lam, cur, hreq = lam.float(), cur.float(), hreq.float()
    R, O, J = x.shape[0], y.shape[0], hreq.shape[1]
    per_row = O * max(J, x.shape[1] if metric == "l1" else 1)
    br = max(1, _BLOCK_ELEMS // max(per_row, 1))
    out = torch.zeros((O, J), dtype=torch.float32, device=y.device)
    for s in range(0, R, br):
        ca = approx_cost(x[s:s + br], y, metric, gamma)           # (b, O)
        slack = (cur[s:s + br, None, None] - ca[:, :, None]
                 - hreq[s:s + br, None, :])                      # (b, O, J)
        out += (lam[s:s + br, None, None]
                * slack.clamp_min(0.0)).sum(dim=0)
    return out
