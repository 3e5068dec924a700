"""Specialization counters for the port's entry points.

Counterpart of ``repro.tracecount``, with the same API (``bump``,
``get``, ``reset``, ``snapshot``). The reference bumps a counter inside
a jitted body, so it counts *traces*: one per new jit cache entry (a
new input shape, dtype or static-argument combination). PyTorch runs
eagerly and has no trace, so the port's counterpart of a trace is the
first call of a wrapper with a new *signature* — the shapes, dtypes and
static arguments that would key a ``jax.jit`` cache entry. A wrapper
keeps the signatures it has seen (see :class:`Signatures`) and bumps
its counter once for each new one. The counters therefore measure what
batch bucketing is meant to bound: how many distinct shapes a serving
workload forces through the fused lookup.
"""
from __future__ import annotations

import collections
import threading

COUNTS: collections.Counter = collections.Counter()


def bump(name: str) -> None:
    """Record one new specialization of ``name``."""
    COUNTS[name] += 1


def get(name: str) -> int:
    return COUNTS[name]


def reset() -> None:
    COUNTS.clear()


class snapshot:
    """Context manager: ``with snapshot() as s: ...; s.delta("name")``
    gives new specializations since entry without resetting the global
    counters."""

    def __enter__(self) -> "snapshot":
        self._at_entry = dict(COUNTS)
        return self

    def __exit__(self, *exc) -> None:
        pass

    def delta(self, name: str) -> int:
        return COUNTS[name] - self._at_entry.get(name, 0)


class Signatures:
    """The signatures one entry point has seen, process-wide like a jit
    cache: ``seen(key)`` bumps ``name`` the first time ``key`` appears.
    ``reset()`` clears the counts, not the signatures, as clearing the
    reference's counters leaves its jit cache warm."""

    def __init__(self, name: str):
        self.name = name
        self._keys: set = set()
        self._lock = threading.Lock()

    def seen(self, key) -> None:
        with self._lock:
            if key in self._keys:
                return
            self._keys.add(key)
        bump(self.name)
