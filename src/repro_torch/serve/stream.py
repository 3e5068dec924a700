"""Async multi-stream serving driver: many concurrent request streams,
bucketed batches, and a double-buffered placement refresh that never
blocks the request path for more than one atomic swap.

This is the event-driven session layer in front of ``SimCacheEngine``
(modeled on the Icarus ``execution/network.py`` session model: requests
are events on a virtual clock, the network processes them in arrival
order). Each :class:`StreamSpec` is one logical user population — its
own demand distribution (e.g. a Zipf permutation per tenant), its own
Poisson arrival rate, its own rng — and the :class:`StreamDriver`
multiplexes all of them into a single serving loop:

* a heap of per-stream next-arrival events yields requests in global
  virtual-time order (streams with higher rates contribute
  proportionally more arrivals — no round-robin artifacts);
* consecutive arrivals coalesce into a batch until either ``max_batch``
  requests are pending or the batch has been open for ``batch_window``
  virtual time units — so batch sizes *vary with arrival statistics*,
  which is exactly the mixed-batch-size workload that batch bucketing
  (``EngineConfig.bucket``) exists for;
* every dispatched batch is served through the engine's bucketed path,
  then the driver polls the double-buffered control plane
  (``engine.poll_refresh()``): a background solve that finished since
  the last batch is swapped in atomically *between* batches, and the
  swap stall is the only serving-thread cost of a placement refresh;
* refreshes are triggered on a fixed cadence (``refresh_every``
  batches) and, with ``EngineConfig.refresh_on_promotion``, by the
  engine itself on NETDUEL promotion churn.

:class:`DriverStats` aggregates the numbers the serving bench records:
sustained requests/s, p50/p95/p99 batch latency, refresh/swap counts,
swap stall totals, NETDUEL placement events, and the placement-version
trajectory.

Counterpart of ``repro.serve.stream``: arrivals, object ids and ingress
ids come from the same per-stream numpy generators, so a port driver
and a reference driver on the same specs form byte-equal batches; the
prompts are drawn with numpy and handed to the engine's device as an
int tensor.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import time

import numpy as np
import torch

from repro_torch.core.demand import Demand
from repro_torch.serve.engine import LATENCY_WINDOW, SimCacheEngine


@dataclasses.dataclass
class StreamSpec:
    """One logical request stream: a demand distribution plus a Poisson
    arrival rate (requests per unit of virtual time)."""
    demand: Demand
    rate: float = 1.0
    seed: int = 0
    name: str = ""


class RequestStream:
    """Poisson arrival process over one stream's demand. Draws are taken
    lazily but from a dedicated generator per stream, so a multi-stream
    trace is reproducible regardless of interleaving."""

    def __init__(self, spec: StreamSpec, index: int):
        if spec.rate <= 0.0:
            raise ValueError(f"stream {index}: rate must be > 0")
        self.spec = spec
        self.index = index
        self.rng = np.random.default_rng(spec.seed)
        self.t = float(self.rng.exponential(1.0 / spec.rate))
        self.n_emitted = 0

    def pop(self) -> tuple[float, int, int]:
        """(arrival_time, object_id, ingress_id) of the current arrival;
        advances the stream to its next one."""
        obj, ing = self.spec.demand.sample(1, self.rng)
        t = self.t
        self.t += float(self.rng.exponential(1.0 / self.spec.rate))
        self.n_emitted += 1
        return t, int(obj[0]), int(ing[0])


@dataclasses.dataclass
class DriverStats:
    """What one driver run measured (the serving-bench row schema)."""
    n_requests: int = 0
    n_batches: int = 0
    wall_s: float = 0.0
    batch_sizes: list = dataclasses.field(default_factory=list)
    # bounded ring (same window as ServeStats): percentiles over the
    # newest LATENCY_WINDOW batches, O(1) memory on long runs
    batch_latencies_ms: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW))
    versions: list = dataclasses.field(default_factory=list)
    refreshes_started: int = 0
    swaps: int = 0
    swap_stall_s: float = 0.0
    max_swap_stall_s: float = 0.0   # max over THIS run's swaps only
    placement_events: int = 0       # NETDUEL promotion rebuilds this run

    @property
    def requests_per_s(self) -> float:
        return self.n_requests / self.wall_s if self.wall_s > 0 else 0.0

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

    @property
    def distinct_batch_sizes(self) -> int:
        return len(set(self.batch_sizes))


class StreamDriver:
    """Multiplex N request streams into the engine's bucketed batch path,
    refreshing placement through the double buffer between batches."""

    def __init__(self, engine: SimCacheEngine,
                 streams: list[StreamSpec],
                 max_batch: int = 256,
                 batch_window: float = 1.0,
                 prompt_len: int = 8,
                 refresh_every: int = 0,
                 prompt_seed: int = 0):
        if not streams:
            raise ValueError("need at least one stream")
        self.engine = engine
        self.streams = [RequestStream(s, i) for i, s in enumerate(streams)]
        self.max_batch = int(max_batch)
        self.batch_window = float(batch_window)
        self.prompt_len = int(prompt_len)
        self.refresh_every = int(refresh_every)
        self._prompt_rng = np.random.default_rng(prompt_seed)
        # event heap: (next_arrival_time, stream_index) — the virtual
        # clock that serializes all streams into one arrival order
        self._heap = [(s.t, s.index) for s in self.streams]
        heapq.heapify(self._heap)
        self._batches_run = 0

    # ------------------------------------------------------ batch forming
    def _next_batch(self, n_left: int) -> tuple[np.ndarray, np.ndarray]:
        """Pop arrivals in virtual-time order until the batch closes:
        ``max_batch`` pending, the batch open longer than
        ``batch_window`` virtual time, or the run budget exhausted.
        Returns (object_ids, ingress_ids) — the ingress each request
        entered at rides along to the engine's demand accounting."""
        ids: list[int] = []
        ings: list[int] = []
        t_open: float | None = None
        cap = min(self.max_batch, n_left)
        while len(ids) < cap:
            t_next = self._heap[0][0]
            if t_open is not None and t_next - t_open > self.batch_window:
                break
            _, si = heapq.heappop(self._heap)
            stream = self.streams[si]
            t_arr, obj, ing = stream.pop()
            if t_open is None:
                t_open = t_arr
            ids.append(obj)
            ings.append(ing)
            heapq.heappush(self._heap, (stream.t, si))
        return (np.asarray(ids, dtype=np.int64),
                np.asarray(ings, dtype=np.int64))

    def _prompts(self, n: int) -> torch.Tensor:
        vocab = self.engine.cfg.vocab
        return torch.as_tensor(self._prompt_rng.integers(
            0, vocab, (n, self.prompt_len)).astype(np.int32),
            device=self.engine.device)

    # -------------------------------------------------------------- run
    def run(self, n_requests: int) -> DriverStats:
        """Serve ~``n_requests`` requests (to batch granularity); returns
        the aggregated driver stats. Callable repeatedly — streams, the
        virtual clock, and the engine all continue where they left off
        (so a caller can swap demand phases between calls)."""
        eng = self.engine
        st = DriverStats()
        swaps0 = eng.swap_count
        stall0 = eng.swap_stall_s
        events0 = eng.placement_events
        t_run0 = time.perf_counter()
        while st.n_requests < n_requests:
            ids, ings = self._next_batch(n_requests - st.n_requests)
            eng.serve(ids, self._prompts(len(ids)), ingress_ids=ings)
            self._batches_run += 1
            st.n_batches += 1
            st.n_requests += len(ids)
            st.batch_sizes.append(len(ids))
            st.batch_latencies_ms.append(
                eng.stats.batch_latencies_ms[-1])
            # cadence trigger: start a background re-solve every k
            # batches (the engine triggers its own on promotion churn
            # when refresh_on_promotion is set)
            if self.refresh_every and \
                    self._batches_run % self.refresh_every == 0:
                if eng.request_refresh():
                    st.refreshes_started += 1
            # the atomic swap point: a finished background solve is
            # installed between batches, never mid-lookup
            if eng.poll_refresh():
                # per-run stall window: max over the swaps *this* run
                # performed, not the engine's all-time high-water mark
                # (which a later run would report as its own stall)
                st.max_swap_stall_s = max(st.max_swap_stall_s,
                                          eng.last_swap_stall_s)
            st.versions.append(eng.placement.version)
        st.wall_s = time.perf_counter() - t_run0
        st.swaps = eng.swap_count - swaps0
        st.swap_stall_s = eng.swap_stall_s - stall0
        st.placement_events = eng.placement_events - events0
        return st

    def drain_refresh(self) -> bool:
        """Finish any in-flight background solve and swap it in (used at
        phase boundaries / end of run so no solve is left dangling)."""
        self.engine.wait_refresh()
        return self.engine.poll_refresh()
