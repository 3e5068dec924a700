"""LOCALSWAP placement (paper §3.3).

Upon an (emulated) request for object o entering at ingress i, compute
the best decrement in expected cost achievable by replacing one object y
currently stored at some cache *on the forwarding path of i* with o:

    ΔC ≜ min_y C(A ∪ {o@cache(y)} \\ {y}) − C(A)

and perform the swap iff ΔC < 0. Prop 3.3: for long enough request
sequences this converges w.p.1 to a *locally optimal* configuration.

Per-iteration cost is kept at the paper's O(N·O_R) bound via the
best/second-best decomposition:

    ΔC(y) = S_{j(y)} + corr(y)
    S_j      = Σ_r λ_r (min(c_r, a_r(j)) − c_r)        add o at cache j
    corr(y)  = Σ_{r: arg1_r = y} λ_r [min(b2_r, a_r(j(y)))
                                      − min(c_r, a_r(j(y)))]

where c_r = C(r, A), b2_r the second-best server of r, a_r(j) the cost of
serving r with the new (o, j). The correction sums touch each request at
most once, so the whole iteration is O(J·O_R) plus one O(K·O_R) refresh
per accepted swap.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.objective import Instance, random_slots

_EPS = 1e-9


def emulated_stream(inst: Instance, n_iters: int, seed: int,
                    slots0: np.ndarray | None = None,
                    requests: tuple[np.ndarray, np.ndarray] | None = None):
    """(rng, start slots, objs, ings) — the shared stream setup of every
    emulated-request policy (LOCALSWAP, NETDUEL, and their device
    twins). All of them consume the seeded rng in this exact order —
    start allocation first, then the request sample — which is what
    makes host and device trajectories comparable under a single seed.
    """
    rng = np.random.default_rng(seed)
    slots = random_slots(inst, rng) if slots0 is None \
        else np.asarray(slots0).copy()
    if requests is None:
        objs, ings = inst.dem.sample(n_iters, rng)
    else:
        objs, ings = requests
    return rng, slots, objs, ings


@dataclasses.dataclass
class SwapState:
    slots: np.ndarray                  # (K,) object ids, −1 empty
    best1: np.ndarray                  # (I, O) C(r, A)
    arg1: np.ndarray                   # (I, O) best slot or −1 (repository)
    best2: np.ndarray                  # (I, O)
    cost_trace: list = dataclasses.field(default_factory=list)
    n_swaps: int = 0

    @classmethod
    def init(cls, inst: Instance, slots: np.ndarray) -> "SwapState":
        b1, a1, b2 = inst.best_two(slots)
        return cls(slots=slots.copy(), best1=b1, arg1=a1, best2=b2)

    def refresh(self, inst: Instance) -> None:
        self.best1, self.arg1, self.best2 = inst.best_two(self.slots)

    def cost(self, inst: Instance) -> float:
        return float(np.sum(inst.lam * self.best1))


def swap_deltas(inst: Instance, st: SwapState, obj: int,
                ingress: int) -> np.ndarray:
    """ΔC(y) for replacing each slot y with ``obj`` (restricted to caches
    on the forwarding path of ``ingress``); +inf elsewhere. O(J·O_R)."""
    I, O = inst.lam.shape
    K = st.slots.shape[0]
    ca_col = inst.ca[:, obj]                                     # (O,)
    lam = inst.lam
    # a[i, o, j] for the J caches — J is small, keep explicit
    a = ca_col[None, :, None] + inst.net.H[:, None, :]           # (I, O, J)
    min_ca = np.minimum(st.best1[:, :, None], a)                 # (I, O, J)
    S = np.sum(lam[:, :, None] * (min_ca - st.best1[:, :, None]), axis=(0, 1))

    # corrections: requests whose best server is slot y
    delta = np.zeros(K, dtype=np.float64)
    jy = inst.slot_cache                                          # (K,)
    mask = st.arg1 >= 0
    ii, oo = np.nonzero(mask)
    yy = st.arg1[ii, oo]
    j_of_y = jy[yy]
    corr = (np.minimum(st.best2[ii, oo], a[ii, oo, j_of_y])
            - min_ca[ii, oo, j_of_y]) * lam[ii, oo]
    np.add.at(delta, yy, corr)
    delta += S[jy]
    # restrict to caches on the ingress path
    on_path = np.isfinite(inst.net.H[ingress])[jy]
    return np.where(on_path, delta, np.inf)


def _apply_swap(inst: Instance, st: SwapState, y: int, obj: int) -> None:
    st.slots[y] = obj
    st.refresh(inst)
    st.n_swaps += 1


def localswap_step(inst: Instance, st: SwapState, obj: int, ingress: int,
                   tol: float = _EPS) -> bool:
    """One LOCALSWAP iteration; returns True iff a swap occurred."""
    delta = swap_deltas(inst, st, obj, ingress)
    y = int(np.argmin(delta))
    if delta[y] < -tol:
        _apply_swap(inst, st, y, obj)
        return True
    return False


def localswap(inst: Instance, n_iters: int = 20000, seed: int = 0,
              slots0: np.ndarray | None = None,
              requests: tuple[np.ndarray, np.ndarray] | None = None,
              record_every: int = 0, tol: float = _EPS) -> SwapState:
    """Off-line LOCALSWAP driven by emulated requests sampled ∝ λ (§3.3).

    ``requests`` may supply an explicit (object_idx, ingress_idx) stream
    (the *online* mode — e.g. a real trace); otherwise ``n_iters``
    emulated requests are drawn from the instance demand. ``tol`` is the
    swap acceptance threshold (ΔC < −tol), exposed so differential tests
    can run host and device paths at one decision margin.
    """
    _, slots, objs, ings = emulated_stream(inst, n_iters, seed, slots0,
                                           requests)
    st = SwapState.init(inst, slots)
    for t in range(len(objs)):
        localswap_step(inst, st, int(objs[t]), int(ings[t]), tol=tol)
        if record_every and t % record_every == 0:
            st.cost_trace.append(st.cost(inst))
    return st


def localswap_polish(inst: Instance, slots: np.ndarray, max_passes: int = 50,
                     tol: float = _EPS) -> SwapState:
    """Deterministic LOCALSWAP: sweep all requested objects round-robin
    until a full pass makes no swap → certified local optimum.

    Used for (i) the Greedy→LocalSwap cascade of Remark 1, and (ii) tests
    of Prop 3.3's fixed-point property.
    """
    st = SwapState.init(inst, slots)
    active = [(int(o), int(i)) for i, o in zip(*np.nonzero(inst.lam > 0))]
    for _ in range(max_passes):
        swapped = False
        for o, i in active:
            swapped |= localswap_step(inst, st, o, i, tol=tol)
        if not swapped:
            break
    return st


def is_locally_optimal(inst: Instance, slots: np.ndarray,
                       tol: float = 1e-7) -> bool:
    """Brute-force check of the paper's local-optimality definition: no
    single (replace one object in one cache) move lowers C(A)."""
    base = inst.total_cost(slots)
    for y in range(slots.shape[0]):
        for o in range(inst.cat.n):
            trial = slots.copy()
            trial[y] = o
            if inst.total_cost(trial) < base - tol:
                return False
    return True


def constrained_localswap(inst: Instance, allowed: np.ndarray,
                          n_iters: int = 20000, seed: int = 0) -> SwapState:
    """LOCALSWAP with per-slot admission constraints (paper §6.2: leaf
    stores only objects within distance d* of the barycenter, parent only
    beyond). ``allowed[s, o]`` = may object o occupy slot s?"""
    rng = np.random.default_rng(seed)
    # start from a feasible random allocation
    slots = np.empty(inst.net.total_slots, dtype=np.int64)
    for s in range(slots.shape[0]):
        choices = np.nonzero(allowed[s])[0]
        slots[s] = rng.choice(choices) if choices.size else 0
    st = SwapState.init(inst, slots)
    objs, ings = inst.dem.sample(n_iters, rng)
    for t in range(len(objs)):
        o, i = int(objs[t]), int(ings[t])
        delta = swap_deltas(inst, st, o, i)
        delta = np.where(allowed[:, o], delta, np.inf)
        y = int(np.argmin(delta))
        if delta[y] < -_EPS:
            _apply_swap(inst, st, y, o)
    return st
