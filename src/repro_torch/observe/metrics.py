"""Process-local metrics: counters, gauges and histograms for the engine.
Counterpart of ``repro.observe.metrics``, copied (the port imports nothing
of ``repro``), with the dispatch counter named for the port's backend:

``engine.cuda_dispatches``          counter — contractions dispatched to
                                    the Hopper kernels, once each
``tune.cache_hits`` / ``_misses``   counters — tune-cache resolution
``tune.candidates_measured``        counter — autotune measurements run
``tune.search_time_us``             histogram — wall time of each search
``distributed.sweep_collective_bytes`` histogram — a distributed CP sweep's
                                    collective bytes, one observation a
                                    sweep (counted at the collective
                                    wrappers; the reference's is HLO's,
                                    once a driver call)
``trace.events_dropped``            counter — ring-buffer evictions

The contraction counter is not the kernel wrappers' ``launches``
attributes: a contraction on ``cuda`` is one dispatch, which launches its
kernel and, where the kernel's grid splits the contraction, a
``splitk_reduce`` too. The wrappers count launches; the registry counts
contractions, as the reference counts them for Pallas.

Reads are snapshot-based: bracket a region with

    before = registry().snapshot()
    ...work...
    delta = registry().delta(before)     # {"engine.cuda_dispatches": 3}
"""

from __future__ import annotations

import threading
from types import MappingProxyType
from typing import Mapping

#: Canonical metric names (importable so call sites cannot typo them).
CUDA_DISPATCHES = "engine.cuda_dispatches"
TUNE_CACHE_HITS = "tune.cache_hits"
TUNE_CACHE_MISSES = "tune.cache_misses"
TUNE_CANDIDATES = "tune.candidates_measured"
TUNE_SEARCH_TIME_US = "tune.search_time_us"
SWEEP_COLLECTIVE_BYTES = "distributed.sweep_collective_bytes"
TRACE_EVENTS_DROPPED = "trace.events_dropped"


class MetricsRegistry:
    """Counters, gauges and histograms behind one lock.

    Counters are monotone (``inc``), gauges are last-write-wins
    (``set_gauge``), histograms keep the raw observations (``observe``;
    summarized on export: the series are short, one entry a search). All
    methods are thread-safe and cheap enough to stay on when nothing reads
    them."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, list[float]] = {}

    # -- writes --------------------------------------------------------------
    def inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._hists.setdefault(name, []).append(value)

    # -- reads ---------------------------------------------------------------
    def counter(self, name: str) -> float:
        """Current value of one counter (0 if never incremented)."""
        with self._lock:
            return self._counters.get(name, 0)

    def gauge(self, name: str) -> float | None:
        with self._lock:
            return self._gauges.get(name)

    def histogram(self, name: str) -> tuple[float, ...]:
        """The raw observations recorded under ``name`` (a copy)."""
        with self._lock:
            return tuple(self._hists.get(name, ()))

    def snapshot(self) -> Mapping[str, float]:
        """An immutable point-in-time view of every counter: two
        measurements each hold their own, so neither clobbers the other."""
        with self._lock:
            return MappingProxyType(dict(self._counters))

    def delta(self, before: Mapping[str, float]) -> dict[str, float]:
        """Counter increments since ``before`` (a :meth:`snapshot`);
        names that did not move are omitted."""
        now = self.snapshot()
        out: dict[str, float] = {}
        for name, value in now.items():
            d = value - before.get(name, 0)
            if d:
                out[name] = d
        return out

    def to_dict(self) -> dict:
        """Everything, histograms summarized."""
        with self._lock:
            hists = {
                name: {
                    "count": len(vals),
                    "sum": sum(vals),
                    "min": min(vals) if vals else None,
                    "max": max(vals) if vals else None,
                }
                for name, vals in self._hists.items()
            }
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": hists,
            }

    def reset(self) -> None:
        """Clear everything. For test isolation only: measurements bracket
        with :meth:`snapshot`/:meth:`delta` instead."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry every layer writes to."""
    return _REGISTRY
