"""GREEDY marginal-gain kernel: the wrapper of kernel D.

Kernel D (``simcache_greedy_gain`` in ``kernels/csrc/gains.cu``)
replaces the Pallas TPU kernel ``repro/kernels/gain/gain.py::
_gain_kernel``: the single-ingress precursor of kernel C (kernels/knn/
gains.py), with λ and cur per request and one row of H per request. It
is C's template with I = 1, the H rows staged per request tile beside λ
and cur, C's groups of at most 8 caches a launch (``_j_groups``), and
C's plan (``_gain_plan``): one block owns a candidate tile
and walks every request tile in order, its J sums per candidate and
request chain in registers, no atomics — so on equal H rows its output
is C's, bit for bit. Bound on the card: the 2·R·O·D-flop fp32 C_a tile.
The kernel masks the ragged request and candidate edges, in place of
the reference's zero padding of R, O and D (which preserves distances).

:func:`gain_cuda` launches it for CUDA tensors and runs the plain
version, :func:`~repro_torch.kernels.gain.ref.gain_ref`, for CPU
tensors. ``gain_cuda.launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LIBRARY, check, stream_ptr
from repro_torch.kernels.gain.ref import gain_ref
from repro_torch.kernels.knn.gains import _j_groups, _launch_args
from repro_torch.kernels.knn.knn import _contig_f32, _metric_id

DEFAULT_BR = 256
DEFAULT_BO = 256
H_SENTINEL = 1.0e30      # "off-path" finite stand-in for +inf


def gain_cuda(x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor,
              cur: torch.Tensor, hreq: torch.Tensor, metric: str = "l2",
              gamma: float = 1.0) -> torch.Tensor:
    """Kernel D: the (J, O) gain table. x (R, D), y (O, D); lam, cur
    (R,); hreq (R, J) finite (off-path already at ``H_SENTINEL``)."""
    if not x.is_cuda:
        return gain_ref(x, y, lam, cur, hreq, metric, gamma).T
    dev = x.device
    xs, ys = _contig_f32(x, "x", dev), _contig_f32(y, "y", dev)
    lm = _contig_f32(lam.reshape(-1), "lam", dev)
    cu = _contig_f32(cur.reshape(-1), "cur", dev)
    h = _contig_f32(hreq, "hreq", dev)
    R, D = xs.shape
    O = ys.shape[0]
    J = h.shape[1] if h.dim() == 2 else -1
    if ys.shape[1] != D or lm.shape != (R,) or cu.shape != (R,) \
            or h.shape != (R, J):
        raise ValueError(f"bad gain shapes: x {tuple(xs.shape)}, y "
                         f"{tuple(ys.shape)}, lam {tuple(lm.shape)}, cur "
                         f"{tuple(cu.shape)}, H {tuple(h.shape)}")
    groups = _j_groups(J)
    out = torch.empty((J, O), dtype=torch.float32, device=dev)
    if O == 0:
        return out
    for a, b in groups:                 # one launch per group of caches
        hg = h if len(groups) == 1 else h[:, a:b].contiguous()
        check(LIBRARY.fn("simcache_greedy_gain")(
            xs.data_ptr(), ys.data_ptr(), lm.data_ptr(), cu.data_ptr(),
            hg.data_ptr(), R, O, D, b - a, _metric_id(metric),
            float(gamma), out[a:b].data_ptr(),
            *_launch_args(xs, ys, 1, b - a, True), stream_ptr(xs)),
            "simcache_greedy_gain")
        gain_cuda.launches += 1
    return out


gain_cuda.launches = 0
