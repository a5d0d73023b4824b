"""repro_torch.observe: tracing, metrics and bound-aware auditing.
Counterpart of ``repro.observe``.

* :class:`~.trace.Trace` — context-manager span recorder (ring buffer,
  JSONL export, ``torch.profiler.record_function`` ranges), gated by
  ``ExecutionContext.observe`` and the trace's ``capture`` policy.
* :class:`~.metrics.MetricsRegistry` (via :func:`~.metrics.registry`) —
  process-local counters, gauges and histograms: the contractions
  dispatched to the Hopper kernels, the tune cache's hits and misses, the
  tuner's measurements and search times; read with snapshot deltas.
* :mod:`~.bounds_audit` — measured bytes, modeled words and the lower
  bound of one engine call (the paper's claim as a runtime metric), the
  bytes counted at operation boundaries.
* ``python -m repro_torch.observe.report`` — a markdown dispatch table
  with model, measured and bound columns from a JSONL trace.
"""

from .bounds_audit import AuditRow, audit_mttkrp, audit_multi_ttm
from .metrics import MetricsRegistry, registry
from .trace import (
    SPAN_SCHEMA,
    Trace,
    current_trace,
    load_trace,
    record_event,
    should_record,
    summarize_events,
)

__all__ = [
    "Trace",
    "MetricsRegistry",
    "registry",
    "AuditRow",
    "audit_mttkrp",
    "audit_multi_ttm",
    "SPAN_SCHEMA",
    "current_trace",
    "load_trace",
    "record_event",
    "should_record",
    "summarize_events",
]
