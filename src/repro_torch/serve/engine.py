"""Serving engine with a similarity-cache front tier (the paper's system,
deployed): batched requests are looked up in the cache network, and
only misses run the model (the "repository").

Counterpart of ``repro.serve.engine`` for this slice of the port:

* the data plane — every served batch is one fused lookup (kernel A,
  ``EngineConfig.fused``), or one KNN launch per level (kernel B) with
  ``fused=False``; ``EngineConfig.prune`` ("lsh" | "kmeans") and
  ``quantize`` put the candidate pre-filter and the int8 first pass in
  front of kernel A, and ``verify`` re-scans what they cannot certify,
  serving exactly what the exact lookup serves; batches are padded to a
  power-of-two bucket (``EngineConfig.bucket``) and the padding is
  masked out of every stat; with ``EngineConfig.sharded`` and an engine
  ``mesh`` (launch/mesh.py) the key axis is cut over the axes that
  :class:`~repro_torch.launch.sharding.LookupShardPolicy` picks, one
  launch of kernel A per shard and a cross-shard reduction, serving
  bitwise what the fused lookup serves;
* the control plane — ``refresh_placement`` re-solves the offline
  problem on the observed demand window: by default the cascade (GREEDY
  seeded by the gain oracle, kernel C, then a LOCALSWAP polish) on a
  streaming ``DeviceInstance`` (``EngineConfig.device_placement``), or
  the NumPy oracles with ``device_placement=False``; with
  ``EngineConfig.warm_start`` a topology that reduces to a §4
  continuous program (the built-in hierarchy, a chain, always does) is
  solved by the continuous-limit pipeline of placement/warmstart.py
  instead (solve, Prop 4.2 band map, a bounded LOCALSWAP polish); a
  sharded engine shards the synchronous solve's oracle and best-two
  tables over the same axes (the same bits), and solves its background
  refreshes unsharded, as the reference does;
* the double buffer — ``request_refresh`` solves in a background thread
  while the active :class:`PlacementBuffer` keeps serving, and
  ``poll_refresh`` installs the result with one swap;
* the online plane — with ``EngineConfig.netduel`` a
  :class:`~repro_torch.core.placement.DuelPlane` (paper §5) observes
  every served batch, priced by the fused lookup's costs at the bucket
  shape (kernel F on the card); a promotion rebuilds the runtime cache
  from the duel's slots (``placement_events`` counts these) and, with
  ``refresh_on_promotion``, starts a background re-solve;
* the on-path strategy plane — with ``EngineConfig.strategy`` a
  :class:`~repro_torch.core.routing.StrategyPlane` (LCE, LCD,
  ProbCache, SIM-LRU, RND-LRU; host NumPy, one LRU walk per request)
  decides every request's server and insertions in place of the
  simcache, on any network, a multi-ingress one included; it runs no
  duel and builds no simcache;
* the refresh gate — with ``EngineConfig.refresh_min_gain`` > 0,
  ``request_refresh`` first prices the demand snapshot with the Che
  surrogate (core/analysis/hitrate.py, on the engine's device) and skips
  the solve when the predicted cost moved less than the gate since the
  last installed solve (``ServeStats.refresh_skipped`` /
  ``refresh_triggered``);
* ``calibrate`` — times the repository prefill, sets the h costs in
  milliseconds and re-installs the held allocation at those costs.

The repository is the dense decoder of repro_torch.models, its prefill
attention on kernel E when the engine's ``cfg.use_flash_attention`` is
set.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import demand as demand_api
from repro_torch.core.analysis import surrogate_cost
from repro_torch.core.catalog import Catalog
from repro_torch.core.objective import DeviceInstance, Instance
from repro_torch.core.placement import (DuelPlane, device_greedy,
                                        device_greedy_then_localswap,
                                        device_localswap, greedy,
                                        greedy_then_localswap, localswap,
                                        warmstart)
from repro_torch.core.routing import StrategyPlane
from repro_torch.core.simcache import SimCacheNetwork
from repro_torch.core.topology import CacheNetwork, tpu_hierarchy
from repro_torch.launch.sharding import LookupShardPolicy
from repro_torch.models import model as model_api


def bucket_size(n: int, lo: int = 8) -> int:
    """Smallest power-of-two bucket ≥ max(n, lo) — the shape every
    serving entry point sees under ``EngineConfig.bucket``."""
    m = max(int(lo), 1)
    while m < n:
        m <<= 1
    return m


def _pad_rows(x, m: int):
    """Pad axis 0 up to m rows by repeating row 0 (an always-valid
    filler). Results for padding rows are discarded by the caller — per
    row outputs are independent, so the first n rows are the unpadded
    run's."""
    n = x.shape[0]
    if m <= n:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[:1].expand(m - n, *x.shape[1:])])
    return np.concatenate([x, np.repeat(x[:1], m - n, axis=0)])


@dataclasses.dataclass
class EngineConfig:
    k_device: int = 64            # level-0 slots
    k_pod: int = 128
    k_global: int = 256
    h_ici: float = 0.1            # placeholder until calibrate()
    h_dcn: float = 1.0
    h_model: float = 10.0         # repository = run the model
    gamma: float = 1.0
    metric: str = "l2"
    algo: str = "cascade"         # greedy | localswap | cascade
    fused: bool = True            # single fused lookup kernel per batch
    sharded: bool = False         # sharded keys (needs an engine mesh)
    prune: str | None = None      # "lsh" | "kmeans" candidate pre-filter
    verify: bool = False          # exact re-scan past the pruning bound
    quantize: bool = False        # int8 lower-bound first pass + exact
    #                               rescore of the top candidates
    #                               (composes with prune; with
    #                               verify=True bit-identical to exact)
    device_placement: bool = True  # device-resident placement control plane
    swap_tol: float = 1e-3        # device LOCALSWAP accept margin
    netduel: bool = False         # §5 online duels on the device, per batch
    duel_window: int = 512        # duel length in requests
    duel_delta: float = 0.05      # relative promotion margin δ
    duel_arm_prob: float = 0.25   # per-request arming probability
    duel_seed: int = 0            # arming-randomness seed
    bucket: bool = True           # power-of-two batch bucketing
    min_bucket: int = 8           # smallest bucket (tiny batches coalesce)
    refresh_on_promotion: bool = False  # duel churn → background re-solve
    refresh_min_gain: float = 0.0  # analytic refresh gate: skip a
    #                               requested solve when the Che
    #                               surrogate's predicted cost moved less
    #                               than this since the last installed
    #                               solve (cost units; 0 = gate off)
    warm_start: bool = False      # §4 continuous-limit warm start on
    #                               every refresh whose topology reduces
    warm_polish_iters: int = 512  # LOCALSWAP polish window after it
    #                               (0 = the analytic placement alone)
    strategy: str | None = None   # on-path routing strategy
    #                               (core/routing.py: lce | lcd |
    #                               probcache | sim-lru | rnd-lru) in
    #                               place of the offline placement — the
    #                               λ-unaware plane, on any network
    strategy_threshold: float | None = None  # C_a admission threshold θ
    strategy_seed: int = 0        # probcache / rnd-lru coin seed


# retained batch-latency window: percentiles over the newest
# LATENCY_WINDOW batches (a bounded ring, O(1) memory on long runs)
LATENCY_WINDOW = 65536


@dataclasses.dataclass
class ServeStats:
    n_requests: int = 0
    n_hits: int = 0
    total_cost: float = 0.0
    total_approx_cost: float = 0.0
    model_calls: int = 0
    # refresh-gate outcomes (EngineConfig.refresh_min_gain): requests the
    # surrogate skipped, and requests it let through to a solve
    refresh_skipped: int = 0
    refresh_triggered: int = 0
    batch_latencies_ms: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW))

    @property
    def hit_rate(self) -> float:
        return self.n_hits / max(self.n_requests, 1)

    @property
    def mean_cost(self) -> float:
        return self.total_cost / max(self.n_requests, 1)

    def latency_percentile(self, q: float) -> float:
        if not self.batch_latencies_ms:
            return 0.0
        return float(np.percentile(self.batch_latencies_ms, q))

    @property
    def p50_ms(self) -> float:
        return self.latency_percentile(50)

    @property
    def p95_ms(self) -> float:
        return self.latency_percentile(95)

    @property
    def p99_ms(self) -> float:
        return self.latency_percentile(99)


class PlacementBuffer:
    """The active data plane, versioned: the runtime cache network plus
    the allocation it was built from. The engine builds the next state
    and swaps it in with one assignment and a version bump, so a lookup
    always runs against a complete placement."""

    def __init__(self):
        self.simcache: SimCacheNetwork | None = None
        self.slots: np.ndarray | None = None
        self.slot_cache: np.ndarray | None = None
        self.version: int = 0

    def install(self, simcache: SimCacheNetwork, slots: np.ndarray,
                slot_cache: np.ndarray) -> None:
        self.simcache = simcache
        self.slots = slots
        self.slot_cache = slot_cache
        self.version += 1


class SimCacheEngine:
    """Batched serving for a decoder LM behind a similarity-cache network,
    on ``device`` (CUDA unless named). ``mesh`` (launch/mesh.py) is the
    shard mesh of ``EngineConfig.sharded``; its shards run in turn on
    ``device``."""

    def __init__(self, cfg: ArchConfig, params, ecfg: EngineConfig,
                 catalog_coords: np.ndarray,
                 net: CacheNetwork | None = None,
                 device: str | torch.device | None = None,
                 mesh=None):
        self.device = resolve_device(device)
        if ecfg.sharded and mesh is None:
            raise ValueError("EngineConfig.sharded requires a mesh")
        # key-axis shard policy of the sharded data plane: resolved once
        # from the mesh, reused on every placement install
        self.mesh = mesh
        self.lookup_shards = (LookupShardPolicy.create(mesh,
                                                       prune=ecfg.prune)
                              if mesh is not None else None)
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.coords = np.asarray(catalog_coords, np.float32)
        self._coords_dev = torch.as_tensor(self.coords, device=self.device)
        self.custom_net = net is not None
        self.net = net if net is not None else tpu_hierarchy(
            ecfg.k_device, ecfg.k_pod, ecfg.k_global,
            ecfg.h_ici, ecfg.h_dcn, ecfg.h_model)
        # per-(ingress, object) empirical demand
        self.counts = np.zeros((self.net.n_ingress, self.coords.shape[0]),
                               dtype=np.float64)
        # on-path strategy plane: when configured it is the serving
        # decision maker and the offline simcache is never built
        self.routing: StrategyPlane | None = None
        if ecfg.strategy is not None:
            self.routing = StrategyPlane(
                self.net, self.coords, metric=ecfg.metric,
                gamma=ecfg.gamma, strategy=ecfg.strategy,
                threshold=ecfg.strategy_threshold, seed=ecfg.strategy_seed)
        self.responses: dict[int, np.ndarray] = {}        # payload store
        self.stats = ServeStats()
        self._prefill = model_api.make_prefill(cfg)
        self.placement = PlacementBuffer()                # active data plane
        # background refresh: the worker thread solves, the serving
        # thread swaps; _pending crosses under _refresh_lock
        self._refresh_lock = threading.Lock()
        self._refresh_thread: threading.Thread | None = None
        self._pending: tuple | None = None
        self._in_flight = False
        self.refresh_count = 0            # completed installs (sync+async)
        self.swap_count = 0               # async swaps
        self.swap_stall_s = 0.0           # total serving-thread swap time
        self.max_swap_stall_s = 0.0
        self.last_swap_stall_s = 0.0      # most recent swap only: what a
        #                                   driver run's window maxes over
        self.last_predicted_cost: float | None = None
        self.solve_timings: dict = {}     # seconds of the last solve
        self.duel: DuelPlane | None = None                # online §5 plane
        self.placement_events = 0                         # duel churn count
        # the surrogate's cost at the demand snapshot of the last
        # installed solve: the refresh gate's baseline (None until a
        # gated engine installs one)
        self._surrogate_baseline: float | None = None

    # -------------------------------------------------- data-plane state
    @property
    def simcache(self) -> SimCacheNetwork | None:
        """The active runtime network (the double buffer's live half)."""
        return self.placement.simcache

    @property
    def placement_version(self) -> int:
        return self.placement.version

    @property
    def refresh_in_flight(self) -> bool:
        return self._in_flight

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------- calibration
    def calibrate(self, sample_prompt, n: int = 3) -> float:
        """Measure the repository cost (one prefill batch) in ms and set
        h_model; ICI/DCN levels get fixed fractions. Rebuilds the
        topology *and* re-installs the held allocation against the
        measured costs (a simcache built before calibration prices the
        old h costs)."""
        if self.custom_net:
            raise ValueError(
                "calibrate() rescales the built-in hierarchy levels; a "
                "custom CacheNetwork carries its own cost unit")
        batch = {"tokens": self._tokens(sample_prompt)}
        self._prefill(self.params, batch)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(n):
            self._prefill(self.params, batch)
        self._sync()
        ms = (time.perf_counter() - t0) / n * 1e3
        self.ecfg.h_model = ms
        self.ecfg.h_ici = ms * 0.01
        self.ecfg.h_dcn = ms * 0.1
        self.net = tpu_hierarchy(self.ecfg.k_device, self.ecfg.k_pod,
                                 self.ecfg.k_global, self.ecfg.h_ici,
                                 self.ecfg.h_dcn, self.ecfg.h_model)
        if self.placement.slots is not None:
            self._rebuild_simcache(self.placement.slots,
                                   self.placement.slot_cache)
            if self.duel is not None:
                # the armed duel priced the old cost units
                self._arm_duel(self.observed_instance(),
                               self.placement.slots)
        return ms

    # ----------------------------------------------------- control plane
    def observed_instance(self) -> Instance:
        """Empirical demand window as a placement instance: counts
        normalized in f64 with *no* floor (never-requested objects keep
        an exact-zero rate); a cold engine falls back to uniform."""
        total = self.counts.sum()
        if total <= 0.0:
            lam = np.full_like(self.counts, 1.0 / self.counts.size)
        else:
            lam = self.counts / total
        dem = demand_api.Demand(lam=lam)
        cat = Catalog(coords=self.coords, metric=self.ecfg.metric,
                      gamma=self.ecfg.gamma)
        return Instance(net=self.net, cat=cat, dem=dem)

    def _control_shard_args(self, shard: bool = True) -> dict:
        """``mesh`` and ``axes`` of the control plane's DeviceInstance:
        the data plane's on a sharded engine (the instance runs unsharded
        when they resolve to one shard), none otherwise or with
        ``shard=False``."""
        if not (shard and self.ecfg.sharded):
            return {}
        return dict(mesh=self.mesh, axes=self.lookup_shards.axes)

    def _solve(self, inst: Instance, algo: str, device: bool,
               shard: bool = True) -> tuple[np.ndarray, float]:
        """Run the offline solver on one observed instance; returns the
        (clamped) allocation and the predicted C(A). ``device`` picks the
        device control plane (a streaming ``DeviceInstance``) over the
        NumPy oracles. Records its phases' seconds in
        ``solve_timings``.

        ``shard=False`` solves unsharded even on a sharded engine; the
        background refresh does so, as the reference's does (there a
        sharded solve on the worker thread could race the serving
        thread's collectives). The sharded oracle and tables are bitwise
        the unsharded ones, so the allocation is the same either way.

        With ``EngineConfig.warm_start`` on and a topology that reduces
        to a §4 continuous program, the continuous-limit pipeline
        replaces ``algo`` (deterministic, so background refreshes stay
        replayable); its stages go into ``solve_timings`` as
        ``warm_solve_s``, ``warm_map_s``, ``warm_polish_s`` and
        ``warm_swaps``. Irreducible topologies fall back to ``algo``."""
        timings: dict = {}
        t0 = time.perf_counter()
        warm_red = warmstart.classify_topology(
            inst.net, gamma=inst.cat.gamma) if self.ecfg.warm_start else None
        if device:
            dinst = DeviceInstance.from_instance(
                inst, materialize_ca=False, device=self.device,
                **self._control_shard_args(shard))
        if warm_red is not None:
            rep = warmstart.warm_start(
                inst, reduction=warm_red, device=device,
                dinst=dinst if device else None, torch_device=self.device,
                polish_iters=self.ecfg.warm_polish_iters,
                tol=self.ecfg.swap_tol)
            slots = rep.slots
            timings.update(warm_solve_s=rep.solve_s, warm_map_s=rep.map_s,
                           warm_polish_s=rep.polish_s,
                           warm_swaps=rep.n_swaps)
        elif device:
            if algo == "greedy":
                slots = device_greedy(dinst)
            elif algo == "localswap":
                slots = device_localswap(dinst, n_iters=4000,
                                         tol=self.ecfg.swap_tol).slots_np
            else:
                slots = device_greedy_then_localswap(
                    dinst, max_passes=8, tol=self.ecfg.swap_tol,
                    timings=timings).slots_np
        elif algo == "greedy":
            slots = greedy(inst)
        elif algo == "localswap":
            slots = localswap(inst, n_iters=4000).slots
        else:
            slots = greedy_then_localswap(inst, max_passes=8).slots
        slots = np.where(slots < 0, 0, slots)
        pred = dinst.total_cost(slots) if device else inst.total_cost(slots)
        timings["solve_s"] = time.perf_counter() - t0
        self.solve_timings = timings
        return slots, pred

    def _arm_duel(self, inst: Instance, slots: np.ndarray) -> None:
        """(Re-)arm the online §5 plane: the duel state lives on the
        device and persists across serve() batches (reset on every
        offline install); on a sharded engine its table rebuilds shard
        the request axis over the data plane's axes."""
        duel_dinst = DeviceInstance.from_instance(
            inst, materialize_ca=False, device=self.device,
            **self._control_shard_args())
        self.duel = DuelPlane(
            duel_dinst, slots, window=self.ecfg.duel_window,
            delta=self.ecfg.duel_delta,
            arm_prob=self.ecfg.duel_arm_prob, seed=self.ecfg.duel_seed)

    def _install(self, slots: np.ndarray, inst: Instance) -> None:
        """Install a solved allocation into the active buffer: rebuild
        the runtime network, re-arm the duel plane (runs on the serving
        thread — this *is* the swap)."""
        self._rebuild_simcache(slots, inst.slot_cache)
        if self.ecfg.netduel:
            self._arm_duel(inst, slots)
        self.refresh_count += 1

    def refresh_placement(self, algo: str | None = None,
                          device: bool | None = None) -> float:
        """Re-solve offline placement on the observed demand window and
        rebuild the runtime cache; returns the predicted C(A). ``device``
        (a bool) follows ``EngineConfig.device_placement`` when None.
        Synchronous: serving waits for the solve."""
        algo = algo or self.ecfg.algo
        if device is None:
            device = self.ecfg.device_placement
        inst = self.observed_instance()
        slots, pred = self._solve(inst, algo, device)
        self._install(slots, inst)
        self.last_predicted_cost = pred
        if self.ecfg.refresh_min_gain > 0.0:
            self._surrogate_baseline = self._surrogate(inst)
        return pred

    def _surrogate(self, inst: Instance) -> float:
        """The refresh gate's price of a demand snapshot: the Che
        surrogate's per-request cost on the engine's device."""
        return surrogate_cost(inst.net, np.asarray(inst.dem.lam, np.float64),
                              device=self.device)

    # ------------------------------------------- double-buffered refresh
    def request_refresh(self, algo: str | None = None,
                        device: bool | None = None) -> bool:
        """Start a background re-solve against a snapshot of the observed
        demand; the active buffer keeps serving. Returns False (and does
        nothing) if a refresh is already in flight. Install the result
        with :meth:`poll_refresh`.

        With ``EngineConfig.refresh_min_gain > 0`` the snapshot is first
        priced by the Che surrogate: if the predicted per-request cost
        moved less than the gate since the snapshot of the last
        installed solve, no solve starts (returns False,
        ``ServeStats.refresh_skipped`` += 1); otherwise
        ``refresh_triggered`` += 1 and the solve starts."""
        if self._in_flight:
            return False
        algo = algo or self.ecfg.algo
        if device is None:
            device = self.ecfg.device_placement
        inst = self.observed_instance()       # snapshot: lam is a copy
        surrogate_now: float | None = None
        if self.ecfg.refresh_min_gain > 0.0:
            surrogate_now = self._surrogate(inst)
            base = self._surrogate_baseline
            if base is not None and \
                    abs(surrogate_now - base) < self.ecfg.refresh_min_gain:
                self.stats.refresh_skipped += 1
                return False
            self.stats.refresh_triggered += 1
        self._in_flight = True

        def work():
            try:
                # unsharded, as the reference's background solve
                slots, pred = self._solve(inst, algo, device, shard=False)
                with self._refresh_lock:
                    self._pending = (slots, inst, pred, surrogate_now)
            except BaseException:
                self._in_flight = False       # never wedge the flag
                raise

        self._refresh_thread = threading.Thread(
            target=work, name="placement-refresh", daemon=True)
        self._refresh_thread.start()
        return True

    def wait_refresh(self, timeout: float | None = None) -> bool:
        """Block until the in-flight solve finishes (the solve, not the
        swap). True if nothing is running or it completed in time."""
        t = self._refresh_thread
        if t is None or not t.is_alive():
            return True
        t.join(timeout)
        return not t.is_alive()

    def poll_refresh(self) -> bool:
        """Install a finished background solve, if any: the swap. The
        serving thread stalls only for the rebuild, timed into
        ``swap_stall_s``/``max_swap_stall_s``. True iff a swap
        happened."""
        with self._refresh_lock:
            pend, self._pending = self._pending, None
        if pend is None:
            return False
        slots, inst, pred, surrogate_now = pend
        t0 = time.perf_counter()
        self._install(slots, inst)
        stall = time.perf_counter() - t0
        self.swap_stall_s += stall
        self.max_swap_stall_s = max(self.max_swap_stall_s, stall)
        self.last_swap_stall_s = stall
        self.swap_count += 1
        self.last_predicted_cost = pred
        if surrogate_now is not None:
            # the installed solve's snapshot becomes the gate baseline
            self._surrogate_baseline = surrogate_now
        self._in_flight = False
        return True

    def _rebuild_simcache(self, slots: np.ndarray,
                          slot_cache: np.ndarray | None = None) -> None:
        """(Re)build the runtime lookup network from an allocation and
        install it into the placement buffer (version += 1) — shared by
        the offline install, the duel's promotion churn and the
        calibration rebuild."""
        if self.net.n_ingress > 1:
            raise ValueError(
                "the fused simcache serves one ingress row of H; a "
                "multi-ingress CacheNetwork needs the on-path strategy "
                "plane (EngineConfig.strategy) instead")
        if slot_cache is None:
            slot_cache = self.net.slot_layout()
        if self.custom_net:
            hs = [float(h) for h in np.asarray(self.net.H[0], np.float64)]
            h_repo = float(self.net.h_repo[0])
        else:
            # the exact f64 config values (the net stores H in f32)
            hs = [0.0, self.ecfg.h_ici, self.ecfg.h_dcn]
            h_repo = self.ecfg.h_model
        pol = self.lookup_shards
        simcache = SimCacheNetwork.from_placement(
            self.coords, slots, slot_cache, hs, h_repo,
            metric=self.ecfg.metric, gamma=self.ecfg.gamma,
            fused=self.ecfg.fused, device=self.device,
            sharded=self.ecfg.sharded, mesh=self.mesh,
            shard_axes=pol.axes if pol else None,
            candidate_policy=pol.candidate_policy() if pol else None)
        self.placement.install(simcache, np.asarray(slots), slot_cache)

    # --------------------------------------------------------- data plane
    def _tokens(self, prompts) -> torch.Tensor:
        return torch.as_tensor(prompts).to(self.device, torch.int64)

    def serve(self, request_ids: np.ndarray, prompts,
              ingress_ids: np.ndarray | None = None
              ) -> tuple[list, ServeStats]:
        """Serve a batch. request_ids index the catalog (their embeddings
        are the lookup keys); prompts (B, S) are the token batch for
        misses. ``ingress_ids`` says where each request entered (None →
        ingress 0). With ``EngineConfig.bucket`` the lookup, the duel
        observation and the miss-prefill run at the batch's power-of-two
        bucket shape, padding masked out of every stat and of the duel
        trajectory."""
        t_batch0 = time.perf_counter()
        request_ids = np.asarray(request_ids)
        n = len(request_ids)
        if ingress_ids is None:
            ingress_ids = np.zeros(n, dtype=np.int64)
        else:
            ingress_ids = np.asarray(ingress_ids, dtype=np.int64)
        # np.add.at, not fancy-indexed +=: a batch with the same object
        # twice must count twice
        np.add.at(self.counts, (ingress_ids, request_ids), 1.0)
        self.stats.n_requests += n
        out: list = [None] * n
        bucket = self.ecfg.bucket

        route_dec = None
        if self.routing is not None:
            # on-path strategy plane: a per-request LRU walk over the
            # ingress's forwarding path picks the server and the
            # insertions — no simcache, no duel
            route_dec = self.routing.serve(request_ids, ingress_ids)
            self.stats.total_cost += float(route_dec.cost.sum())
            self.stats.total_approx_cost += float(
                route_dec.approx_cost.sum())
            self.stats.n_hits += int(route_dec.hit.sum())
            miss_idx = np.nonzero(~route_dec.hit)[0]
        elif self.simcache is None:
            miss_idx = np.arange(n)
        else:
            q = self._coords_dev[torch.as_tensor(request_ids,
                                                 device=self.device)]
            if bucket:
                q = _pad_rows(q, bucket_size(n, self.ecfg.min_bucket))
            res = self.simcache.lookup(q, prune=self.ecfg.prune,
                                       verify=self.ecfg.verify,
                                       quantize=self.ecfg.quantize)
            # slice the valid prefix before any accounting
            hits = res.hit[:n].cpu().numpy()
            payloads = res.payload[:n].cpu().numpy()
            self.stats.total_cost += float(res.cost[:n].double().sum())
            self.stats.total_approx_cost += float(
                res.approx_cost[:n].double().sum())
            for i in np.nonzero(hits)[0]:
                out[i] = self.responses.get(int(payloads[i]))
            self.stats.n_hits += int(hits.sum())
            miss_idx = np.nonzero(~hits)[0]
            if self.duel is not None:
                # online control plane: observe the batch in one scan,
                # priced by the costs the lookup just computed — at the
                # bucket shape, padded steps masked to no-ops
                ids_b = _pad_rows(request_ids, res.cost.shape[0])
                if self.duel.observe(ids_b, b1_ext=res.cost,
                                     n_valid=n if bucket else None):
                    self._rebuild_simcache(self.duel.slots_np)
                    self.placement_events += 1
                    if self.ecfg.refresh_on_promotion:
                        # duel churn = demand drifted: start the
                        # background re-solve (a no-op if one runs)
                        self.request_refresh()

        if len(miss_idx):
            # repository: run the model on the miss sub-batch (padded to
            # its own bucket)
            tokens = self._tokens(prompts)
            sel = tokens[torch.as_tensor(miss_idx, device=self.device)]
            if bucket:
                sel = _pad_rows(sel, bucket_size(len(miss_idx),
                                                 self.ecfg.min_bucket))
            logits, _ = self._prefill(self.params, {"tokens": sel})
            resp = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
            self.stats.model_calls += 1
            if self.routing is None and self.simcache is None:
                # cold engine without a strategy plane: repository cost
                # per miss (the strategy plane priced its misses)
                self.stats.total_cost += self.ecfg.h_model * len(miss_idx)
            for j, i in enumerate(miss_idx):
                rid = int(request_ids[i])
                self.responses[rid] = resp[j:j + 1]
                out[i] = resp[j:j + 1]
        if route_dec is not None:
            # fill hits after the miss prefill: a request can hit a key
            # that an earlier miss of this batch just inserted, whose
            # response exists only once the model ran
            for i in np.nonzero(route_dec.hit)[0]:
                out[i] = self.responses.get(int(route_dec.payload[i]))
        self.stats.batch_latencies_ms.append(
            (time.perf_counter() - t_batch0) * 1e3)
        return out, self.stats
