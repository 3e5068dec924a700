"""Straggler mitigation: hedged dispatch.

Counterpart of ``repro.ft.straggler`` (pure Python, no device). A
request sent to a slow replica is re-issued ("hedged") to a backup after
a deadline; the first completion wins. Replicas are callables returning
(result, simulated latency in s): simulated ones with injectable latency
(:func:`simulated_replica`), or RPCs to model replicas on a cluster.

The similarity-cache tier adds a cheaper mitigation of its own: when
even the hedge would miss the deadline, the engine can serve the best
cached approximizer instead, trading approximation cost C_a for tail
latency (``approx_fallback``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass
class HedgeStats:
    n_primary: int = 0
    n_hedged: int = 0
    n_fallback: int = 0
    total_latency: float = 0.0


class HedgedDispatcher:
    """Sequential simulation of hedged dispatch (deterministic).

    The dispatcher "waits" on the primary until ``hedge_after_s`` of
    simulated time, then consults the backup and takes whichever
    finishes first in simulated time; past ``deadline_s`` it serves
    ``approx_fallback(request)`` where one is given.
    """

    def __init__(self, replicas: list[Callable], hedge_after_s: float,
                 deadline_s: float | None = None,
                 approx_fallback: Callable | None = None):
        if len(replicas) < 2:
            raise ValueError("hedged dispatch needs a primary and a backup")
        self.replicas = replicas
        self.hedge_after = hedge_after_s
        self.deadline = deadline_s
        self.fallback = approx_fallback
        self.stats = HedgeStats()

    def __call__(self, request):
        r0, lat0 = self.replicas[0](request)
        if lat0 <= self.hedge_after:
            self.stats.n_primary += 1
            self.stats.total_latency += lat0
            return r0, lat0
        r1, lat1 = self.replicas[1](request)
        hedged_lat = self.hedge_after + lat1
        best, lat = (r0, lat0) if lat0 <= hedged_lat else (r1, hedged_lat)
        if self.deadline is not None and lat > self.deadline \
                and self.fallback is not None:
            fb, _ = self.fallback(request)
            self.stats.n_fallback += 1
            self.stats.total_latency += self.deadline
            return fb, self.deadline
        self.stats.n_hedged += 1
        self.stats.total_latency += lat
        return best, lat


def simulated_replica(base_latency: float, slow_every: int = 0,
                      slow_factor: float = 10.0) -> Callable:
    """A deterministic replica: every ``slow_every``-th call straggles by
    ``slow_factor``."""
    state = {"n": 0}

    def call(request):
        state["n"] += 1
        lat = base_latency
        if slow_every and state["n"] % slow_every == 0:
            lat *= slow_factor
        return ("ok", request), lat
    return call
