"""Public GREEDY gain entry: ``greedy_gain``.

Counterpart of ``repro.kernels.gain.ops``: maps off-path ``inf`` entries
of H to the finite ``H_SENTINEL`` and transposes the kernel's (J, O)
table to (O, J). For CUDA tensors it launches kernel D (gain.py), which
masks its ragged edges, so the reference's LANE/``br``/``bo`` padding is
gone; ``br`` and ``bo`` are accepted only to mirror the reference's
signature. For CPU tensors it runs the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gain.gain import (DEFAULT_BO, DEFAULT_BR,
                                           H_SENTINEL, gain_cuda)


def greedy_gain(x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor,
                cur: torch.Tensor, hreq: torch.Tensor, metric: str = "l2",
                gamma: float = 1.0, br: int = DEFAULT_BR,
                bo: int = DEFAULT_BO) -> torch.Tensor:
    """(O, J) marginal gains for all candidate approximizers.

    x: (R, D) request embeddings; y: (O, D) candidate objects; lam, cur:
    (R,) rates and current serving costs; hreq: (R, J) ingress→cache
    retrieval costs (+inf allowed: mapped to a finite sentinel).
    """
    del br, bo                      # tiling is the kernel's own
    hreq = hreq.float()
    hreq = torch.where(torch.isfinite(hreq), hreq,
                       torch.full_like(hreq, H_SENTINEL))
    return gain_cuda(x, y, lam, cur, hreq, metric, gamma).T
