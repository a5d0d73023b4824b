"""Structured tracing: span events for every engine dispatch. Counterpart
of ``repro.observe.trace``.

A :class:`Trace` is a context manager that captures span events (one dict
an engine dispatch, driver iteration, served bucket or request, or tuner
search) into an in-memory ring buffer, exports them as JSONL, and wraps
each observed dispatch in a ``torch.profiler.record_function`` range (an
NVTX range too when the operands are on CUDA), so the profiler attributes
the dispatch's device kernels to it::

    ctx = repro_torch.ExecutionContext.create(observe=True)
    with repro_torch.Trace(path="run.jsonl") as t:
        repro_torch.cp_als(x, rank=8, ctx=ctx)
    t.events                    # the recorded span dicts
    # run.jsonl: one JSON object a line, schema repro_torch.observe.Span/1

Every event carries ``schema``, ``seq``, ``time_s`` and ``kind``, then
fields of its kind. Dispatch events (``mttkrp``, ``contract_partial``,
``multi_ttm``, ``fused_pair``) record the resolved backend, the plan that
ran (the tune cache's codec), the model plan's words (Eq 10, or
``MultiTTMPlan.model_words``), the sequential lower bound (clamped at 0),
the dtype policy and the dispatch's host time; on ``cuda`` also the bytes
the kernel's own model gives for the plan that ran
(``kernel_modeled_bytes``).

Gating, the zero-overhead contract
----------------------------------
Nothing is recorded unless a ``Trace`` is active. While one is active,
``capture="all"`` (the default) records every engine call and
``capture="observed"`` only the calls whose ``ExecutionContext.observe``
is True. Where the reference records nothing while its operands are JAX
tracers, this port records nothing while the current CUDA stream is
capturing a graph, under ``torch.compiler.is_compiling()``, or when an
operand is a meta or fake tensor: a span taken there would record a
capture's host time as a dispatch.

``wall_time_us`` is the host's time for the dispatch, as in the reference
(JAX dispatches asynchronously too): a span never synchronizes the device.
"""

from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Iterable

import torch

from .metrics import TRACE_EVENTS_DROPPED, registry

SPAN_SCHEMA = "repro_torch.observe.Span/1"

#: Keys every event carries, in emission order (kind-specific fields follow).
BASE_FIELDS = ("schema", "seq", "time_s", "kind")

_ACTIVE: list["Trace"] = []


class Trace:
    """Record engine span events while active; export them as JSONL.

    ``capacity`` bounds the in-memory ring buffer (the oldest events are
    evicted, counted under ``trace.events_dropped``); ``path`` exports the
    buffer as JSONL on a clean exit; ``capture`` is ``"all"`` (every engine
    call) or ``"observed"`` (only ``ExecutionContext.observe=True`` calls);
    ``annotate`` wraps observed dispatches in profiler ranges."""

    def __init__(
        self,
        capacity: int = 4096,
        *,
        path: str | None = None,
        capture: str = "all",
        annotate: bool = True,
    ) -> None:
        if capture not in ("all", "observed"):
            raise ValueError(
                f"capture must be 'all' (every engine call records while this trace is "
                f"active) or 'observed' (only ExecutionContext.observe=True calls), "
                f"got {capture!r}"
            )
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.path = path
        self.capture = capture
        self.annotate = annotate
        self._buf: deque[dict] = deque(maxlen=self.capacity)
        self._seq = 0

    # -- context management --------------------------------------------------
    def __enter__(self) -> "Trace":
        _ACTIVE.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _ACTIVE.remove(self)
        if self.path is not None and exc_type is None:
            self.export(self.path)

    # -- recording -----------------------------------------------------------
    def record(self, kind: str, **fields: Any) -> dict:
        """Append one span event (ring-buffered) and return it."""
        if len(self._buf) == self._buf.maxlen:
            registry().inc(TRACE_EVENTS_DROPPED)
        event = {"schema": SPAN_SCHEMA, "seq": self._seq, "time_s": time.time(), "kind": kind}
        event.update(fields)
        self._seq += 1
        self._buf.append(event)
        return event

    @property
    def events(self) -> list[dict]:
        """The buffered span events, oldest first (a copy)."""
        return list(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    # -- export --------------------------------------------------------------
    def export(self, path: str) -> int:
        """Write the buffer as JSONL (one event a line); returns the number
        of events written."""
        events = self.events
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e, sort_keys=True) + "\n")
        return len(events)


def current_trace() -> Trace | None:
    """The innermost active :class:`Trace`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def load_trace(path: str) -> list[dict]:
    """Read a JSONL trace file back into its list of span events."""
    out: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ---------------------------------------------------------------------------
# The wiring helpers the engine layers call
# ---------------------------------------------------------------------------

def _not_concrete(*arrays: Any) -> bool:
    """True while nothing may be recorded: a CUDA graph being captured on
    the current stream, a ``torch.compile`` trace, or a meta or fake
    operand (the port's counterparts of the reference's JAX tracers)."""
    if torch.compiler.is_compiling():
        return True
    if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
        return True
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(a, torch.Tensor) and (a.is_meta or isinstance(a, FakeTensor))
               for a in arrays)


def should_record(ctx_observe: bool, *arrays: Any) -> bool:
    """One cheap gate for every wiring site: is a trace active, does its
    capture policy admit this call, and are the operands concrete?"""
    t = current_trace()
    if t is None:
        return False
    if t.capture == "observed" and not ctx_observe:
        return False
    return not _not_concrete(*arrays)


def record_event(kind: str, **fields: Any) -> dict | None:
    """Record into the active trace (no-op without one)."""
    t = current_trace()
    if t is None:
        return None
    return t.record(kind, **fields)


@contextmanager
def annotated(name: str, *arrays: Any):
    """``torch.profiler.record_function(name)`` around one observed
    dispatch, and an NVTX range when an operand is on CUDA; entered only
    when the active trace asks for annotations (and never ungated, see
    :func:`should_record`)."""
    t = current_trace()
    if t is None or not t.annotate:
        yield
        return
    with torch.profiler.record_function(name):
        if any(isinstance(a, torch.Tensor) and a.is_cuda for a in arrays):
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def summarize_events(events: Iterable[dict]) -> dict:
    """Aggregate a span-event stream: event count, total modeled words,
    total measured bytes (when any event carries them), total lower-bound
    words, and the measured-bytes / modeled-bytes ratio when both sides
    are known."""
    n = 0
    modeled_words = 0.0
    modeled_bytes = 0.0
    measured_bytes = 0.0
    lower_bound_words = 0.0
    have_measured = False
    for e in events:
        n += 1
        mw = e.get("modeled_words")
        if mw is not None:
            modeled_words += float(mw)
            modeled_bytes += float(mw) * float(e.get("itemsize", 4))
        lb = e.get("lower_bound_words")
        if lb is not None:
            lower_bound_words += float(lb)
        mb = e.get("measured_bytes")
        if mb is not None:
            measured_bytes += float(mb)
            have_measured = True
    return {
        "events": n,
        "modeled_words": modeled_words,
        "lower_bound_words": lower_bound_words,
        "measured_bytes": measured_bytes if have_measured else None,
        "optimality_ratio": (
            measured_bytes / modeled_bytes if have_measured and modeled_bytes > 0 else None
        ),
    }
