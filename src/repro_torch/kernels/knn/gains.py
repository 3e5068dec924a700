"""Batched placement gain oracle for the control plane: kernel C.

GREEDY and LOCALSWAP (paper §3.2–3.3) are driven by the marginal gains

    gain[o', j] = Σ_i Σ_r λ[i, r] · relu(cur[i, r] − C_a(x_r, y_o')
                                          − H[i, j])

over all candidate (object o', cache j) pairs, where ``cur`` is the
current per-(ingress, object) serving cost C(r, A). Counterpart of
``repro.kernels.knn.gains``:

* :func:`gains_cuda` — kernel C (``kernels/csrc/gains.cu``, design notes
  there), replacing the Pallas TPU kernel
  ``repro/kernels/knn/gains.py::_gains_kernel``. A block owns a tile of
  candidates, resident in shared memory, and walks every request tile in
  order (staged by ``cp.async``); each thread keeps an 8-request × 4-
  candidate register tile of one request chain (r mod 4) and its J sums
  per candidate — no atomics, so each sum has one fixed order, the same
  for any tiling of the candidates. Bound on the card: the
  2·R·O·D-flop fp32 C_a tile. :func:`_gain_plan` says whether the
  candidate tile fits resident. A launch holds at most ``J_GROUP`` = 8
  caches; a wider network runs in groups of 8 columns, one launch each
  (:func:`_j_groups`), every column bitwise what a narrower call gives
  it. For CPU tensors it runs the plain version, :func:`_gains_tiles`.
  ``gains_cuda.launches`` counts kernel launches.
* :func:`placement_gains` — the public entry (sentinel mapping and the
  (J, O) → (O, J) transpose), behind every GREEDY seed. With
  ``quantize=True`` it runs :func:`_lb_gains_tiles` instead, torch over
  the int8 images (the reference's is XLA, not Pallas): certified gain
  *upper* bounds, which lazy GREEDY takes as stale seeds.
* :func:`placement_gains_matrix` — plain torch over an explicit C_a
  matrix, for instances that materialize it (``quantize=True`` bounds
  each C_a row from below by its int8 image).
* :func:`sharded_placement_gains` — the oracle over a mesh
  (launch/mesh.py): one :func:`placement_gains` per contiguous chunk of
  the candidates, in turn, concatenated. A candidate's sums never see
  the other candidates, so every column is the unsharded call's.

Off-path +inf entries of H map to the finite ``H_SENTINEL`` (relu clamps
them to zero gain; inf − inf would breed NaNs).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import quant
from repro_torch.kernels.build import LIBRARY, check, stream_ptr
from repro_torch.kernels.knn.knn import _contig_f32, _metric_id
from repro_torch.kernels.knn.ops import mesh_axes_size
from repro_torch.kernels.knn.ref import _dense_ca

DEFAULT_BO = 256
H_SENTINEL = 1.0e30      # finite stand-in for +inf (off-path) retrieval cost
J_GROUP = 8              # caches a launch holds in registers

# the kernels' shape constants (kernels/csrc/gains.cu)
CHAINS = 4                # request chains (r mod 4), combined in order
REQ_TILE = 32             # requests per tile
O_TILE = 128              # candidates per block (one warp per chain)
D_CHUNK = 32              # features per staged chunk
X_STRIDE = D_CHUNK + 4    # request chunk row stride in shared memory
Y_STREAM_STRIDE = D_CHUNK + 4  # streamed candidate chunk row stride
STAGES = 3                # chunks in the cp.async ring
J_WIDTHS = (1, 3, 8)      # J widths the fold is unrolled to
SMEM_LIMIT = 232_448      # dynamic shared memory a block may use (H100)


def _j_width(J: int, y_stream: bool) -> int:
    """The J width a launch of J ≤ ``J_GROUP`` caches runs at (the
    streamed tile only at 8)."""
    return 8 if y_stream else next(w for w in J_WIDTHS if J <= w)


def _j_groups(J: int) -> list[tuple[int, int]]:
    """The cache columns [start, end) of each launch of a J-cache call:
    groups of ``J_GROUP`` in order, the last one ragged.

    Each column's sums run in an order that does not depend on the other
    columns, so every column of a grouped call is bitwise the column of a
    J ≤ 8 call over any slice holding it, and a J ≤ 8 call is one launch
    as before. The cost: every group recomputes the C_a tile, so J 32
    does 4× the product work of J 8 (a kernel that kept the tile across
    groups is later work, ROADMAP P8)."""
    if J < 1:
        raise ValueError(f"the gain kernels need at least one cache, got {J}")
    return [(s, min(J, s + J_GROUP)) for s in range(0, J, J_GROUP)]


def _cand_stride(D: int) -> int:
    """Row stride of the resident candidate tile: D rounded up to 4, then
    an odd number of float4s (conflict-free float4 reads)."""
    d4 = -(-D // 4) * 4
    return d4 + 4 if (d4 // 4) % 2 == 0 else d4


def _smem_bytes(D: int, I: int, j_width: int, per_request_h: bool,
                y_stream: bool) -> int:
    """Dynamic shared memory of one block (kept equal to gains.cu's
    ``layout``): the candidate tile (resident, or one chunk per stage;
    reused by the chain combine), the request ring, λ and cur per stage,
    H (per stage for kernel D, once for C) and the tile's |x|²."""
    ys = (STAGES * O_TILE * Y_STREAM_STRIDE if y_stream
          else O_TILE * _cand_stride(D))
    part = (CHAINS - 1) * j_width * O_TILE
    h = STAGES * REQ_TILE * j_width if per_request_h else I * j_width
    return 4 * (max(ys, part) + STAGES * REQ_TILE * X_STRIDE
                + 2 * STAGES * I * REQ_TILE + -(-h // 4) * 4 + REQ_TILE)


class GainPlan(NamedTuple):
    """How one call runs: whether the candidate tile streams beside the
    requests, the J width, and the block's shared memory."""
    y_stream: bool
    j_width: int
    smem_bytes: int
    O: int

    def tiles(self) -> list[tuple[int, int]]:
        """Each block's candidate range [start, end), in block order."""
        return [(s, min(self.O, s + O_TILE))
                for s in range(0, self.O, O_TILE)]


@functools.lru_cache(maxsize=None)
def _gain_plan(O: int, D: int, I: int, J: int,
               per_request_h: bool) -> GainPlan:
    """The plan of an (O, D, I, J) call. Blocks own whole tiles of
    O_TILE candidates in order and never split the request axis. On an
    H100 this one tile was the fastest at both main-path sizes
    (PERF.md): at R = O = 10⁵ three 66 KB blocks of 128 candidates (12
    warps) share an SM, and at the stream's 20,000 its 157 blocks give
    every SM one. The candidates stay resident in shared memory where
    their rows fit (D ≤ 420 at I = 1), and stream beside the requests
    where they do not."""
    for y_stream in (False, True):
        jw = _j_width(J, y_stream)
        smem = _smem_bytes(D, I, jw, per_request_h, y_stream)
        if smem <= SMEM_LIMIT:
            return GainPlan(y_stream, jw, smem, O)
    raise ValueError(f"the gain kernels stage λ and cur of every ingress "
                     f"per request tile: {I} ingresses do not fit in "
                     f"shared memory")


def _launch_args(x: torch.Tensor, y: torch.Tensor, I: int, J: int,
                 per_request_h: bool) -> tuple[int, int]:
    """(y_stream, vec16) of a call on the card: the plan, and the staging
    path (1: 16-byte copies, for D % 4 == 0 and aligned rows)."""
    O, D = y.shape
    plan = _gain_plan(O, D, I, J, per_request_h)
    vec16 = int(D % 4 == 0 and x.data_ptr() % 16 == 0
                and y.data_ptr() % 16 == 0)
    return int(plan.y_stream), vec16


def _fold_tile(ca_t: torch.Tensor, lam: torch.Tensor, cur: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    """(T, J) gains of one candidate tile given its (R, T) C_a columns."""
    I, J = h.shape
    cols = []
    for j in range(J):
        acc = torch.zeros((ca_t.shape[1],), dtype=torch.float32,
                          device=ca_t.device)
        for i in range(I):
            m = (cur[i, :, None] - h[i, j] - ca_t).clamp_min(0.0)
            acc = acc + lam[i, :] @ m
        cols.append(acc)
    return torch.stack(cols, dim=1)


def _gains_tiles(x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor,
                 cur: torch.Tensor, hreq: torch.Tensor, metric: str,
                 gamma: float, bo: int = DEFAULT_BO) -> torch.Tensor:
    """Plain version of kernel C, blocked over candidate tiles so the
    (R, O) distance matrix never materializes. Returns (O, J) f32."""
    return torch.cat([
        _fold_tile(_dense_ca(x, y[s:s + bo], metric, gamma), lam, cur, hreq)
        for s in range(0, y.shape[0], bo)]) if y.shape[0] else \
        torch.zeros((0, hreq.shape[1]), dtype=torch.float32, device=y.device)


def gains_cuda(x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor,
               cur: torch.Tensor, hreq: torch.Tensor, metric: str = "l2",
               gamma: float = 1.0) -> torch.Tensor:
    """Kernel C: the (J, O) gain table. x (R, D), y (O, D); lam, cur
    (I, R); hreq (I, J) finite (off-path already at ``H_SENTINEL``)."""
    if not x.is_cuda:
        return _gains_tiles(x.float(), y.float(), lam.float(), cur.float(),
                            hreq.float(), metric, gamma).T
    dev = x.device
    xs, ys = _contig_f32(x, "x", dev), _contig_f32(y, "y", dev)
    lm, cu = _contig_f32(lam, "lam", dev), _contig_f32(cur, "cur", dev)
    h = _contig_f32(hreq, "hreq", dev)
    R, D = xs.shape
    O = ys.shape[0]
    I, J = h.shape
    if ys.shape[1] != D or lm.shape != (I, R) or cu.shape != (I, R):
        raise ValueError(f"bad gain shapes: x {tuple(xs.shape)}, y "
                         f"{tuple(ys.shape)}, lam {tuple(lm.shape)}, cur "
                         f"{tuple(cu.shape)}, H {tuple(h.shape)}")
    groups = _j_groups(J)
    out = torch.empty((J, O), dtype=torch.float32, device=dev)
    if O == 0:
        return out
    for a, b in groups:                 # one launch per group of caches
        hg = h if len(groups) == 1 else h[:, a:b].contiguous()
        check(LIBRARY.fn("simcache_gains")(
            xs.data_ptr(), ys.data_ptr(), lm.data_ptr(), cu.data_ptr(),
            hg.data_ptr(), R, O, D, I, b - a, _metric_id(metric),
            float(gamma), out[a:b].data_ptr(),
            *_launch_args(xs, ys, I, b - a, False), stream_ptr(xs)),
            "simcache_gains")
        gains_cuda.launches += 1
    return out


gains_cuda.launches = 0


def _sentinel(hreq: torch.Tensor) -> torch.Tensor:
    hreq = hreq.float()
    return torch.where(torch.isfinite(hreq), hreq,
                       torch.full_like(hreq, H_SENTINEL))


def _lb_gains_tiles(x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor,
                    cur: torch.Tensor, hreq: torch.Tensor, metric: str,
                    gamma: float, bo: int = DEFAULT_BO) -> torch.Tensor:
    """Quantized twin of :func:`_gains_tiles`: per candidate tile the C_a
    block is quant.py's certified lower bound over the int8 images
    (requests quantized once, each candidate tile on the fly). lb ≤ C_a
    elementwise makes every relu slack, hence every gain, an **upper
    bound** on the exact oracle's: the admissible direction lazy GREEDY
    needs (placement/device.py seeds its table with them, stale).
    Returns (O, J) f32."""
    qx, sx = quant.quantize_int8(x)
    xd = quant.dequantize_int8(qx, sx)
    rx = quant.quant_row_radius(sx[:, 0], x.shape[1], metric)
    x_sq = (xd * xd).sum(-1) if metric in ("l2", "l2sq") else None
    tiles = []
    for s in range(0, y.shape[0], bo):
        kq = quant.quantize_rows(y[s:s + bo], metric)
        kd = quant.dequantize_int8(kq.q, kq.scale)
        lb = quant.lb_approx_cost_block(xd, kd, rx, kq.radius, metric,
                                        gamma, q_sq=x_sq, k_sq=kq.sq_norm)
        tiles.append(_fold_tile(lb, lam, cur, hreq))
    if not tiles:
        return torch.zeros((0, hreq.shape[1]), dtype=torch.float32,
                           device=y.device)
    return torch.cat(tiles)


def placement_gains(x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor,
                    cur: torch.Tensor, hreq: torch.Tensor,
                    metric: str = "l2", gamma: float = 1.0,
                    quantize: bool = False) -> torch.Tensor:
    """(O, J) marginal gains of every candidate approximizer (o', j).

    x: (R, D) request-object coords; y: (O, D) candidate coords;
    lam, cur: (I, R) per-(ingress, object) rates and current serving
    costs; hreq: (I, J) ingress→cache retrieval costs (+inf allowed).
    ``quantize=True`` returns certified gain upper bounds over int8
    images (:func:`_lb_gains_tiles`, never kernel C), as the reference's
    ``quantize`` takes its jnp path.
    """
    if quantize:
        return _lb_gains_tiles(x.float(), y.float(), lam.float(),
                               cur.float(), _sentinel(hreq), metric, gamma)
    return gains_cuda(x, y, lam, cur, _sentinel(hreq), metric, gamma).T


def placement_gains_matrix(ca: torch.Tensor, lam: torch.Tensor,
                           cur: torch.Tensor, hreq: torch.Tensor,
                           bo: int = DEFAULT_BO,
                           quantize: bool = False) -> torch.Tensor:
    """Gain oracle over an explicit (R, O) C_a matrix; returns (O, J) f32
    — the small-instance twin of :func:`placement_gains`.
    ``quantize=True`` replaces each C_a row by the lower bound of its
    int8 image, relu(deq − ELEM_ERR·scale) ≤ ca, making the gains
    admissible upper bounds as :func:`placement_gains`'s are."""
    h = _sentinel(hreq)
    lam, cur, ca = lam.float(), cur.float(), ca.float()
    if quantize:
        qc, sc = quant.quantize_int8(ca)
        ca = (quant.dequantize_int8(qc, sc)
              - quant.ELEM_ERR * sc).clamp_min(0.0)
    return torch.cat([_fold_tile(ca[:, s:s + bo], lam, cur, h)
                      for s in range(0, ca.shape[1], bo)])


def sharded_placement_gains(x: torch.Tensor, y: torch.Tensor,
                            lam: torch.Tensor, cur: torch.Tensor,
                            hreq: torch.Tensor, mesh, axes: tuple[str, ...],
                            metric: str = "l2", gamma: float = 1.0,
                            quantize: bool = False) -> torch.Tensor:
    """Sharded gain oracle: one :func:`placement_gains` per candidate
    shard, in turn. The shards are the reference's: ``y`` padded with
    zero rows to a multiple of ``n · DEFAULT_BO`` (n the product of the
    ``axes`` sizes of ``mesh``) and cut into n contiguous balanced chunks
    of S rows. The padding is not built: its gains are cut off at the
    end, so each shard runs on its real rows alone (a view), and a shard
    of padding only runs nothing. Requests, rates and costs are whole in
    every shard. On the card each shard is ⌈J/8⌉ launches of kernel C,
    whose per-candidate sums do not depend on the candidate tiling; on
    the CPU every shard starts on a multiple of ``DEFAULT_BO``, so the
    plain version's candidate tiles are the unsharded call's. Either way
    every column is bitwise the unsharded one. Returns (O, J) f32."""
    n = mesh_axes_size(mesh, tuple(axes))
    n_obj = y.shape[0]
    S = -(-n_obj // (n * DEFAULT_BO)) * DEFAULT_BO  # padding included
    starts = range(0, n_obj, S) if S else [0]    # shards with real rows
    return torch.cat([placement_gains(x, y[a:a + S], lam, cur, hreq,
                                      metric=metric, gamma=gamma,
                                      quantize=quantize) for a in starts])


def duel_virtual_costs(coords: torch.Tensor, ca: torch.Tensor | None,
                       obj, virt_safe: torch.Tensor, h_slots: torch.Tensor,
                       metric: str, gamma: float,
                       has_ca: bool) -> torch.Tensor:
    """(K,) virtual serving cost C_a(x_o, y_v[k]) + h(i, j(k)) of one
    request — NETDUEL's per-step pricing (paper §5), the one-row case of
    the gain oracle's C_a. With a materialized C_a the row gather is the
    host policy's ``ca[o, virt]`` bit for bit; otherwise the row is the
    shape-stable form (core/costs.py) every incremental op uses. The
    plain scan (core/placement/netduel.py) calls it per step; kernel F
    computes the same row in the same IEEE operations."""
    if has_ca:
        cac = ca[obj, virt_safe]
    else:
        from repro_torch.core import costs
        cac = costs.approx_cost_stable(coords[obj].reshape(1, -1),
                                       coords[virt_safe], metric, gamma)[0]
    return cac + h_slots
