"""Problem instance + vectorized evaluation of the paper's objective.

Implements eqs. (1)–(4):

    C(r, A) = min_{α ∈ A ∪ S} C(r, α)          (1)
    C(A)    = Σ_r λ_r C(r, A)                   (2) discrete case
    G(A)    = C(∅) − C(A)                       caching gain (§3.1)

An *allocation* is a flat int64 vector ``slots`` of length
``net.total_slots`` holding object ids (−1 = empty slot); slot ``s``
belongs to cache ``net.slot_layout()[s]``. This fixed layout makes the
matroid constraint (Prop 3.2 / Appendix A) trivially satisfied by
construction and maps 1:1 onto device-resident cache shards.

Requests are the pairs (ingress i, object o) with rate ``dem.lam[i, o]``;
the request space equals the catalog (O_R = O), as in the paper's
experiments.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.catalog import Catalog
from repro_torch.core.demand import Demand
from repro_torch.core.topology import CacheNetwork

INF = np.float32(np.inf)

# past this catalog size the dense (O, O) C_a matrix is never built:
# the host oracle streams row/column blocks and the device twin streams
# distance tiles (kernels/knn/gains.py)
CA_MATERIALIZE_MAX = 16384


@dataclasses.dataclass(frozen=True)
class Instance:
    """A similarity-caching placement problem instance (discrete case).

    ``ca_matrix`` optionally supplies an explicit approximation-cost
    matrix (the paper's first instance, §2); otherwise C_a is derived
    from catalog coordinates (metric^γ).
    """
    net: CacheNetwork
    cat: Catalog
    dem: Demand
    ca_matrix: np.ndarray | None = None

    def __post_init__(self):
        assert self.dem.n_ingress == self.net.n_ingress
        assert self.dem.n_objects == self.cat.n
        if self.ca_matrix is not None:
            assert self.ca_matrix.shape == (self.cat.n, self.cat.n)

    @functools.cached_property
    def ca(self) -> np.ndarray:
        """Full (O, O) approximation-cost matrix (float32, cached)."""
        return self.cat.ca() if self.ca_matrix is None else self.ca_matrix

    @functools.cached_property
    def slot_cache(self) -> np.ndarray:
        return self.net.slot_layout()

    @functools.cached_property
    def lam(self) -> np.ndarray:
        return self.dem.lam

    # ---------------------------------------------------------------- eval
    def slot_costs(self, slots: np.ndarray) -> np.ndarray:
        """(I, O, K) cost of serving request (i, o) with slot s.

        cost[i, o, s] = C_a[o, slots[s]] + H[i, cache(s)]; +inf for empty
        slots and off-path caches.
        """
        K = slots.shape[0]
        ca_cols = np.where(slots[None, :] >= 0,
                           self.ca[:, np.maximum(slots, 0)], INF)   # (O, K)
        h = self.net.H[:, self.slot_cache]                           # (I, K)
        return ca_cols[None, :, :] + h[:, None, :]

    def best_two(self, slots: np.ndarray):
        """Per-request best/second-best over slots ∪ {repository}.

        Returns (best1, arg1, best2): arg1 is the slot index, or −1 when
        the repository is the best server. best2 likewise includes the
        repository as a candidate. Ties break to the *lowest slot index*
        (argmin semantics) — the contract shared bit-for-bit with the
        device twin (``DeviceInstance.best_two``), so host and device
        LOCALSWAP attribute corrections to the same slot.
        """
        c = self.slot_costs(slots)                                   # (I,O,K)
        a1 = np.argmin(c, axis=2)                                    # lowest s
        b1 = np.take_along_axis(c, a1[:, :, None], axis=2)[:, :, 0]
        masked = c.copy()
        np.put_along_axis(masked, a1[:, :, None], INF, axis=2)
        b2 = masked.min(axis=2)
        repo = self.net.h_repo[:, None].astype(np.float32)
        # fold the repository in as the always-available approximizer S
        best1 = np.minimum(b1, repo)
        arg1 = np.where(repo < b1, -1, a1)
        best2 = np.minimum(np.where(repo < b1, b1, b2), repo)
        return best1, arg1, best2

    def request_costs(self, slots: np.ndarray) -> np.ndarray:
        """C(r, A) for every request (I, O) — eq. (1)."""
        best1, _, _ = self.best_two(slots)
        return best1

    def total_cost(self, slots: np.ndarray) -> float:
        """Expected cost C(A) per unit rate — eq. (2)."""
        return float(np.sum(self.lam * self.request_costs(slots)))

    def empty_cost(self) -> float:
        """C(∅): every request served by its repository."""
        return float(np.sum(self.lam * self.net.h_repo[:, None]))

    def caching_gain(self, slots: np.ndarray) -> float:
        """G(A) = C(∅) − C(A) (§3.1); non-negative, monotone, submodular."""
        return self.empty_cost() - self.total_cost(slots)

    # ------------------------------------------------------------- greedy
    def _ca_col(self, obj: int) -> np.ndarray:
        """(O,) column C_a[:, obj] — cached-matrix view or on-the-fly."""
        if self.ca_matrix is not None or "ca" in self.__dict__ \
                or self.cat.n <= CA_MATERIALIZE_MAX:
            return self.ca[:, obj]
        return self.cat.ca(cols=np.array([obj]))[:, 0]

    def add_gain_single(self, cur: np.ndarray, obj: int, cache: int) -> float:
        """Marginal gain of adding approximizer (obj, cache) given current
        per-request costs ``cur`` (I, O):  Σ_r λ_r·relu(cur_r − C(r, α))."""
        newc = self._ca_col(obj)[None, :] + self.net.H[:, cache][:, None]
        return float(np.sum(self.lam * np.maximum(cur - newc, 0.0)))

    def _ca_rows(self, rows: np.ndarray | slice) -> np.ndarray:
        """(len(rows), O) block of C_a — a view of the cached matrix when
        it exists (or is small enough to build), computed on the fly
        otherwise. ``CA_MATERIALIZE_MAX`` keeps the honest-oracle path
        usable at catalog sizes where a dense (O, O) C_a cannot exist."""
        if self.ca_matrix is not None or "ca" in self.__dict__ \
                or self.cat.n <= CA_MATERIALIZE_MAX:
            return self.ca[rows]
        idx = np.arange(self.cat.n)[rows] if isinstance(rows, slice) else rows
        return self.cat.ca(rows=idx)

    def add_gain_all(self, cur: np.ndarray, block: int = 2048) -> np.ndarray:
        """(O, J) marginal gain for every candidate approximizer.

        gain[o', j] = Σ_{i,o} λ[i,o]·relu(cur[i,o] − H[i,j] − C_a[o, o']),
        computed in O-row blocks to bound the (O×O) temporary; each C_a
        row block is fetched once and reused across every (ingress,
        cache) pair (on-the-fly for catalogs past ``CA_MATERIALIZE_MAX``,
        where the dense matrix cannot be cached). This is the host
        differential oracle of the device gain kernel
        (kernels/knn/gains.py; kernels/gain/ref.py is the single-ingress
        jnp flavor).
        """
        O, J = self.cat.n, self.net.n_caches
        gain = np.zeros((O, J), dtype=np.float64)
        for s in range(0, O, block):
            blk = slice(s, s + block)
            ca_blk = self._ca_rows(blk)
            for i in range(self.net.n_ingress):
                for j in range(J):
                    h = self.net.H[i, j]
                    if not np.isfinite(h):
                        continue
                    a = cur[i, blk] - h                           # (b,)
                    m = np.maximum(a[:, None] - ca_blk, 0.0)
                    gain[:, j] += self.lam[i, blk] @ m
        return gain

    def add_gain_delta(self, cur_old: np.ndarray, cur_new: np.ndarray,
                       block: int = 2048) -> np.ndarray:
        """(O, J) change in :meth:`add_gain_all` when per-request costs
        drop from ``cur_old`` to ``cur_new`` (elementwise ≤).

        Only requests whose cost actually changed contribute, so one
        GREEDY pick (which improves the few requests near the new
        approximizer) updates the whole gain table in O(changed·O·J)
        instead of the eager path's full O(O²·J) recompute — the
        vectorized row-update reuse of ``updated_costs`` applied to the
        gain table itself.
        """
        O, J = self.cat.n, self.net.n_caches
        delta = np.zeros((O, J), dtype=np.float64)
        changed = cur_new < cur_old                               # (I, O)
        for i in range(self.net.n_ingress):
            idx = np.nonzero(changed[i])[0]
            if idx.size == 0:
                continue
            for s in range(0, idx.size, block):
                sel = idx[s:s + block]
                ca_blk = self._ca_rows(sel)
                a_new = cur_new[i, sel][:, None]
                a_old = cur_old[i, sel][:, None]
                lam_i = self.lam[i, sel]
                for j in range(J):
                    h = self.net.H[i, j]
                    if not np.isfinite(h):
                        continue
                    m = (np.maximum(a_new - h - ca_blk, 0.0)
                         - np.maximum(a_old - h - ca_blk, 0.0))
                    delta[:, j] += lam_i @ m
        return delta

    def updated_costs(self, cur: np.ndarray, obj: int, cache: int) -> np.ndarray:
        """cur after adding (obj, cache): min(cur, C_a[:,obj] + H[:,cache])."""
        newc = self._ca_col(obj)[None, :] + self.net.H[:, cache][:, None]
        return np.minimum(cur, newc)


# ===================================================================== device
# Device-resident twin of Instance: the control plane's state (per-request
# serving costs, slot layout, C_a access) lives on the card, so
# GREEDY/LOCALSWAP (core/placement/device.py) never round-trip the O(O·J)
# gain grid through host NumPy. Two C_a modes:
#
#   * materialized — the host (O, O) matrix uploaded once (the
#     small-instance fidelity mode, up to 4096 objects by default);
#   * streaming    — distance tiles computed on the fly: the full gain
#     oracle through kernel C (kernels/knn/gains.py), every incremental
#     op through the shape-stable distance form (core/costs.py).

import torch

from repro_torch._device import resolve_device
from repro_torch.core import costs


def _gain_at(coords, ca, lam, cur, H, objs, caches, metric: str,
             gamma: float, has_ca: bool) -> torch.Tensor:
    """(k,) exact marginal gains of candidate pairs (objs[c], caches[c])
    given current costs ``cur`` (I, O) — the batched lazy-greedy refresh.
    Streamed C_a uses the shape-stable form, bitwise consistent with
    :func:`_apply_pick`, so a candidate already folded into ``cur``
    refreshes to an exact-zero gain."""
    if has_ca:
        cac = ca[:, objs]                                      # (O, k)
    else:
        cac = costs.approx_cost_stable(coords, coords[objs], metric, gamma)
    hsel = H[:, caches]                                        # (I, k)
    slack = cur[:, :, None] - cac[None, :, :] - hsel[:, None, :]
    return (lam[:, :, None] * slack.clamp_min(0.0)).sum(dim=(0, 1))


def _ca_column(coords, ca, obj, metric: str, gamma: float,
               has_ca: bool) -> torch.Tensor:
    """(O,) canonical C_a column of one object."""
    if has_ca:
        return ca[:, obj]
    return costs.approx_cost_stable(coords, coords[obj].reshape(1, -1),
                                    metric, gamma)[:, 0]


def _apply_pick(coords, ca, H, cur, obj, cache, metric: str, gamma: float,
                has_ca: bool) -> torch.Tensor:
    """cur ← min(cur, C_a[:, obj] + H[:, cache]) — incremental update."""
    col = _ca_column(coords, ca, obj, metric, gamma, has_ca)
    newc = col[None, :] + H[:, cache][:, None]
    return torch.minimum(cur, newc)


def _best_two_rows_pre(rows, keys, slots, slot_cache, H, metric: str,
                       gamma: float, has_ca: bool):
    """Pre-repo-fold best-two for a block of request rows: (b1, a1, b2,
    a2) over *slots only*, ties to the lowest slot index
    (``torch.argmin`` keeps the first minimum). ``rows`` is a block of C_a
    rows (``has_ca``) or the request coordinates, with ``keys`` the slot
    keys' coordinates (shape-stable C_a, so every incremental op sees the
    same bits for a pair). Rows are independent of each other."""
    if has_ca:
        d = rows[:, slots.clamp_min(0)]                        # (R, K)
    else:
        d = costs.approx_cost_stable(rows, keys, metric, gamma)
    ca_cols = torch.where(slots[None, :] >= 0, d, torch.inf)
    c = ca_cols[None, :, :] + H[:, slot_cache][:, None, :]     # (I, R, K)
    a1 = torch.argmin(c, dim=2)
    b1 = c.gather(2, a1[:, :, None])[:, :, 0]
    masked = c.scatter(2, a1[:, :, None], torch.inf)
    a2 = torch.argmin(masked, dim=2)
    b2 = masked.gather(2, a2[:, :, None])[:, :, 0]
    return b1, a1, b2, a2


def fold_best_two(b1, a1, b2, h_repo):
    """Fold the repository escape (cost h_repo, index −1) into pre-fold
    slot tables → serving tables (best1, arg1, best2)."""
    repo = h_repo[:, None]
    best1 = torch.minimum(b1, repo)
    arg1 = torch.where(repo < b1, -1, a1)
    best2 = torch.minimum(torch.where(repo < b1, b1, b2), repo)
    return best1, arg1, best2


def sharded_best_two_tables(coords, ca, slots, slot_cache, H, mesh,
                            axes: tuple, metric: str, gamma: float,
                            has_ca: bool):
    """Pre-fold (b1, a1, b2, a2) tables with the request axis sharded
    over ``axes`` of ``mesh``: the rows (C_a rows, or the request
    coordinates) cut into the reference's contiguous balanced chunks of
    ⌈R/n⌉ rows, each chunk's tables by the per-row kernel on the whole
    slot keys, in turn, concatenated. The reference's zero padding rows
    are cut off at its end, so they are not built here. Rows are
    independent, so the tables are bitwise the unsharded ones at every
    shard count."""
    from repro_torch.kernels.knn.ops import mesh_axes_size
    n = mesh_axes_size(mesh, tuple(axes))
    rows = ca if has_ca else coords
    n_obj = rows.shape[0]
    keys = None if has_ca else coords[slots.clamp_min(0)]
    S = -(-n_obj // n)
    starts = range(0, n_obj, S) if S else [0]    # shards with real rows
    parts = [_best_two_rows_pre(rows[a:a + S], keys, slots, slot_cache, H,
                                metric, gamma, has_ca) for a in starts]
    return tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(4))


def sharded_best_two(coords, ca, slots, slot_cache, H, h_repo, mesh,
                     axes: tuple, metric: str, gamma: float, has_ca: bool):
    """Serving tables (best1, arg1, best2) with the request axis sharded:
    :func:`sharded_best_two_tables` folded with the repository."""
    b1, a1, b2, _ = sharded_best_two_tables(coords, ca, slots, slot_cache,
                                            H, mesh, axes, metric, gamma,
                                            has_ca)
    return fold_best_two(b1, a1, b2, h_repo)


def default_delta_cap(n_obj: int) -> int:
    """Dirty-row budget of :func:`best_two_delta`; past it the whole
    table is rebuilt."""
    return max(64, n_obj // 16)


def best_two_delta(coords, ca, b1, a1, b2, a2, slots_new, ys, slot_cache,
                   H, metric: str, gamma: float, has_ca: bool, cap: int,
                   mesh=None, axes: tuple = ()):
    """Incremental pre-fold best-two refresh after slot writes.

    ``ys`` is a (P,) ascending vector of the slot indices whose occupant
    changed (padded with K = total slots for unused lanes); ``slots_new``
    the post-write layout. Only rows whose witness (a1 or a2) references
    a changed slot can need more than a two-candidate insertion; those
    dirty rows are recomputed by the full per-row kernel on the canonical
    shape-stable C_a, so the result is bitwise the full rebuild's. With
    more than ``cap`` dirty rows the whole table is rebuilt, request-axis
    sharded (:func:`sharded_best_two_tables`) when ``mesh`` is given; the
    dirty-row recompute is never sharded, as in the reference.
    """
    K = int(slot_cache.shape[0])
    R = b1.shape[1]
    cap = min(cap, R)
    keys_new = None if has_ca else coords[slots_new.clamp_min(0)]
    rows_all = ca if has_ca else coords
    valid_y = ys < K                                           # (P,)
    hit1 = ((a1[:, :, None] == ys[None, None, :]) & valid_y).any(-1)
    hit2 = ((a2[:, :, None] == ys[None, None, :]) & valid_y).any(-1)
    dirty_r = (hit1 | hit2).any(dim=0)                         # (R,)
    if int(dirty_r.sum()) > cap:
        if mesh is not None:
            return sharded_best_two_tables(coords, ca, slots_new,
                                           slot_cache, H, mesh, axes,
                                           metric, gamma, has_ca)
        return _best_two_rows_pre(rows_all, keys_new, slots_new, slot_cache,
                                  H, metric, gamma, has_ca)

    safe_y = ys.clamp_max(K - 1)
    obj = slots_new[safe_y].clamp_min(0)                       # (P,)
    if has_ca:
        cols = ca[:, obj]                                      # (R, P)
    else:
        cols = costs.approx_cost_stable(coords, coords[obj], metric, gamma)
    cols = torch.where(slots_new[safe_y][None, :] >= 0, cols, torch.inf)
    cn_all = cols[None, :, :] + H[:, slot_cache[safe_y]][:, None, :]
    cn_all = torch.where(valid_y[None, None, :], cn_all, torch.inf)

    # two-candidate insertion of each new column in ascending slot order,
    # so ties break to the lowest index exactly like argmin's first
    # minimum; clean rows end exact, dirty rows are overwritten below
    nb1, na1, nb2, na2 = b1, a1, b2, a2
    for j in range(ys.shape[0]):
        cn, yj, vj = cn_all[:, :, j], ys[j], valid_y[j]
        take1 = vj & ((cn < nb1) | ((cn == nb1) & (yj < na1)))
        take2 = (~take1) & vj & ((cn < nb2) | ((cn == nb2) & (yj < na2)))
        nb2 = torch.where(take1, nb1, torch.where(take2, cn, nb2))
        na2 = torch.where(take1, na1, torch.where(take2, yj, na2))
        nb1 = torch.where(take1, cn, nb1)
        na1 = torch.where(take1, yj, na1)

    ridx = torch.nonzero(dirty_r).reshape(-1)
    if ridx.numel():
        sb1, sa1, sb2, sa2 = _best_two_rows_pre(
            rows_all[ridx], keys_new, slots_new, slot_cache, H, metric,
            gamma, has_ca)
        nb1, na1 = nb1.index_copy(1, ridx, sb1), na1.index_copy(1, ridx, sa1)
        nb2, na2 = nb2.index_copy(1, ridx, sb2), na2.index_copy(1, ridx, sa2)
    return nb1, na1, nb2, na2


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceInstance:
    """Device-resident twin of :class:`Instance`.

    Holds the tensors every control-plane op needs (f32 coords, rates,
    retrieval costs, slot layout) plus an optional materialized C_a, and
    exposes the primitives GREEDY/LOCALSWAP are built from: :meth:`gains`
    (full batched oracle, kernel C), :meth:`gain_at` (exact refresh of a
    candidate batch), :meth:`apply_pick` and the best-two tables.
    ``host`` keeps the originating NumPy instance.

    With ``mesh`` and ``axes`` (a launch/mesh.py mesh, the data plane's
    shard axes) resolving to more than one shard, the oracle shards its
    candidate axis and the best-two tables their request axis, each
    shard in turn on this instance's device; every value is bitwise the
    unsharded one.
    """
    host: Instance
    coords: torch.Tensor               # (O, D) f32
    lam: torch.Tensor                  # (I, O) f32
    H: torch.Tensor                    # (I, J) f32, +inf off-path
    h_repo: torch.Tensor               # (I,) f32
    slot_cache: torch.Tensor           # (K,) int64
    ca: torch.Tensor | None            # (O, O) materialized C_a, or None
    metric: str
    gamma: float
    mesh: object = None
    axes: tuple = ()

    @classmethod
    def from_instance(cls, inst: Instance, mesh=None, axes: tuple = (),
                      materialize_ca: bool | None = None,
                      device: str | torch.device | None = None
                      ) -> "DeviceInstance":
        """Upload ``inst`` to ``device`` (CUDA unless named). C_a is
        materialized for explicit matrices and catalogs up to 4096
        objects unless ``materialize_ca`` says otherwise. ``mesh`` and
        ``axes`` shard the control plane (see the class)."""
        dev = resolve_device(device)
        if materialize_ca is None:
            materialize_ca = (inst.ca_matrix is not None
                              or inst.cat.n <= 4096)
        if inst.ca_matrix is not None and not materialize_ca:
            raise ValueError("explicit ca_matrix instances must materialize")
        f32 = dict(dtype=torch.float32, device=dev)
        return cls(
            host=inst,
            coords=torch.as_tensor(np.asarray(inst.cat.coords), **f32),
            lam=torch.as_tensor(np.asarray(inst.lam), **f32),
            H=torch.as_tensor(np.asarray(inst.net.H), **f32),
            h_repo=torch.as_tensor(np.asarray(inst.net.h_repo), **f32),
            slot_cache=torch.as_tensor(inst.slot_cache, dtype=torch.int64,
                                       device=dev),
            ca=(torch.as_tensor(np.asarray(inst.ca), **f32)
                if materialize_ca else None),
            metric=inst.cat.metric, gamma=inst.cat.gamma, mesh=mesh,
            axes=tuple(axes))

    # ----------------------------------------------------------- shapes
    @property
    def device(self) -> torch.device:
        return self.coords.device

    @property
    def n_objects(self) -> int:
        return self.coords.shape[0]

    @property
    def n_caches(self) -> int:
        return self.H.shape[1]

    @property
    def n_shards(self) -> int:
        if self.mesh is None or not self.axes:
            return 1
        from repro_torch.kernels.knn.ops import mesh_axes_size
        return mesh_axes_size(self.mesh, self.axes)

    def _shard_args(self) -> tuple:
        """(mesh, axes) when the instance shards, else (None, ())."""
        if self.n_shards > 1:
            return self.mesh, self.axes
        return None, ()

    def _ca_args(self):
        return self.coords, self.ca, self.metric, self.gamma, \
            self.ca is not None

    # ------------------------------------------------------------- ops
    def initial_costs(self) -> torch.Tensor:
        """C(r, ∅) = h_repo, per (ingress, object) — f32 (I, O)."""
        return self.h_repo[:, None].expand(
            self.lam.shape[0], self.n_objects).clone()

    def gains(self, cur: torch.Tensor,
              quantize: bool = False) -> torch.Tensor:
        """(O, J) marginal gains of every candidate — one oracle call
        (one per candidate shard when the instance shards). With
        ``quantize`` the oracle runs the int8 lower-bound distance pass
        and returns admissible *upper* bounds on every gain: valid lazy
        priorities, not exact values (``device_greedy`` re-scores before
        it accepts)."""
        from repro_torch.kernels.knn import (placement_gains,
                                             placement_gains_matrix,
                                             sharded_placement_gains)
        if self.ca is not None:
            return placement_gains_matrix(self.ca, self.lam, cur, self.H,
                                          quantize=quantize)
        mesh, axes = self._shard_args()
        if mesh is not None:
            return sharded_placement_gains(
                self.coords, self.coords, self.lam, cur, self.H, mesh, axes,
                metric=self.metric, gamma=self.gamma, quantize=quantize)
        return placement_gains(self.coords, self.coords, self.lam, cur,
                               self.H, metric=self.metric, gamma=self.gamma,
                               quantize=quantize)

    def gain_at(self, cur, objs, caches) -> torch.Tensor:
        coords, ca, metric, gamma, has_ca = self._ca_args()
        return _gain_at(coords, ca, self.lam, cur, self.H, objs, caches,
                        metric, gamma, has_ca)

    def apply_pick(self, cur, obj, cache) -> torch.Tensor:
        coords, ca, metric, gamma, has_ca = self._ca_args()
        return _apply_pick(coords, ca, self.H, cur, obj, cache, metric,
                           gamma, has_ca)

    def best_two_tables(self, slots) -> tuple:
        """Pre-fold (b1, a1, b2, a2) tables over the slot axis — the
        carried state of the incremental refresh; request-axis sharded
        when the instance shards."""
        coords, ca, metric, gamma, has_ca = self._ca_args()
        slots = torch.as_tensor(slots, dtype=torch.int64,
                                device=self.device)
        mesh, axes = self._shard_args()
        if mesh is not None:
            return sharded_best_two_tables(coords, ca, slots,
                                           self.slot_cache, self.H, mesh,
                                           axes, metric, gamma, has_ca)
        rows = ca if has_ca else coords
        keys = None if has_ca else coords[slots.clamp_min(0)]
        return _best_two_rows_pre(rows, keys, slots, self.slot_cache,
                                  self.H, metric, gamma, has_ca)

    def best_two(self, slots) -> tuple:
        """best1/arg1/best2 serving tables (repository folded in)."""
        b1, a1, b2, _ = self.best_two_tables(slots)
        return fold_best_two(b1, a1, b2, self.h_repo)

    def best_two_delta(self, b1, a1, b2, a2, slots_new, ys,
                       cap: int | None = None) -> tuple:
        """Incremental pre-fold refresh after writing slots ``ys``;
        bitwise :meth:`best_two_tables` on the new layout (its full
        rebuild sharded when the instance shards)."""
        coords, ca, metric, gamma, has_ca = self._ca_args()
        if cap is None:
            cap = default_delta_cap(self.n_objects)
        i64 = dict(dtype=torch.int64, device=self.device)
        mesh, axes = self._shard_args()
        return best_two_delta(coords, ca, b1, a1, b2, a2,
                              torch.as_tensor(slots_new, **i64),
                              torch.as_tensor(ys, **i64), self.slot_cache,
                              self.H, metric, gamma, has_ca, cap=cap,
                              mesh=mesh, axes=axes)

    def total_cost(self, slots) -> float:
        """C(A) evaluated on the device (f32) — the only total-cost path
        that exists for catalogs past CA_MATERIALIZE_MAX."""
        best1, _, _ = self.best_two(slots)
        return float((self.lam * best1).sum())


def random_slots(inst: Instance, rng: np.random.Generator) -> np.ndarray:
    """Random initial allocation (LocalSwap start state, §3.3)."""
    return rng.integers(0, inst.cat.n, size=inst.net.total_slots,
                        dtype=np.int64)


def empty_slots(inst: Instance) -> np.ndarray:
    return np.full(inst.net.total_slots, -1, dtype=np.int64)
