"""The port's observability layer against the reference, on the CPU (the
counterpart of ``tests/test_observe.py``): the span schema and its JSONL
round trip, the ring buffer, the capture gate, the metrics registry and the
tune counters, the trace triples, the bounds audit, ``summarize_events``
and the report CLI; then the port's own cases: the gate's three refusals,
observe on or off giving the same results and the same aten operations,
the op-boundary byte count, and the spans of every schedule.

Inputs are made with numpy from a seed and go through both packages: the
reference on ``einsum`` (and on ``pallas`` in interpret mode for the
dispatch counter, as ``tests/test_observe.py`` runs it), the port on
``einsum`` and on ``cuda`` with CPU tensors (the kernels' plain versions,
which report the launches the card would make). Both contexts get the same
explicit ``memory=``, a 64-word budget, so the lower bounds are positive.
``modeled_words`` and ``lower_bound_words`` are pure functions of the
shapes and the memory: they must equal the reference's exactly, event by
event. Outputs agree within 1e-5 of their largest magnitude.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.observe import Trace as JTrace
from repro.observe import audit_mttkrp as j_audit_mttkrp
from repro.observe import audit_multi_ttm as j_audit_multi_ttm
from repro_torch import ExecutionContext, observe
from repro_torch.engine.plan import (
    Memory,
    MTTKRPKernelPlan,
    choose_blocks,
    choose_mttkrp_kernel_blocks,
    choose_multi_ttm_kernel_blocks,
    keep_first,
)
from repro_torch.core.bounds import seq_lb_memory
from repro_torch.observe import (
    SPAN_SCHEMA,
    Trace,
    audit_mttkrp,
    audit_multi_ttm,
    current_trace,
    load_trace,
    registry,
    summarize_events,
)
from repro_torch.observe.bounds_audit import OpBoundaries
from repro_torch.observe.metrics import (
    CUDA_DISPATCHES,
    TUNE_CACHE_HITS,
    TUNE_CACHE_MISSES,
    TUNE_CANDIDATES,
    TUNE_SEARCH_TIME_US,
    MetricsRegistry,
)
from repro_torch.observe.report import main as report_main
from repro_torch.observe.trace import BASE_FIELDS, should_record
from repro_torch.tune.cache import plan_from_dict

from _torch_parity import close, data, problem

DIMS, RANK = (12, 10, 8), 3  # the pinned 3-way problem
BUDGET = 256  # bytes: 64 fp32 words, small enough for positive lower bounds
DISPATCH = ("mttkrp", "contract_partial", "multi_ttm", "fused_pair")


def _mem():
    return Memory(BUDGET, 1, 1, 4)


def _ctx(backend="einsum", **kw):
    return ExecutionContext.create(backend, device="cpu", **{"memory": _mem(), **kw})


def _jctx(backend="einsum", **kw):
    return repro.ExecutionContext.create(
        backend=backend, **{"memory": repro.Memory(BUDGET, 1, 1, 4), **kw})


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _problem(dims=DIMS, seed=0):
    x, fs = data(dims, RANK, seed)
    return _t(x), [_t(f) for f in fs]


def _triples(events, kinds=("mttkrp", "contract_partial", "multi_ttm")):
    return [(e["kind"], e["modeled_words"], e["lower_bound_words"], e["memory_words"],
             e["itemsize"]) for e in events if e["kind"] in kinds]


# ---------------------------------------------------------------------------
# Trace: recording, ring buffer, schema round trip, validation
# ---------------------------------------------------------------------------

def test_nothing_recorded_without_an_active_trace():
    x, fs = _problem()
    assert current_trace() is None
    repro_torch.mttkrp(x, fs, 0, ctx=_ctx(observe=True))
    assert current_trace() is None


@pytest.mark.parametrize("backend", ["einsum", "blocked_host", "cuda"])
def test_span_schema_and_jsonl_round_trip(tmp_path, backend):
    x, fs = _problem()
    p = tmp_path / "trace.jsonl"
    with Trace(path=str(p)) as tr:
        repro_torch.mttkrp(x, fs, 1, ctx=_ctx(backend, observe=True))
        assert current_trace() is tr
    (e,) = tr.events
    assert list(e)[:len(BASE_FIELDS)] == list(BASE_FIELDS)
    assert e["schema"] == SPAN_SCHEMA == "repro_torch.observe.Span/1"
    assert (e["kind"], e["shape"], e["rank"], e["mode"], e["backend"]) == (
        "mttkrp", list(DIMS), RANK, 1, backend)
    assert e["modeled_words"] > 0 and e["lower_bound_words"] >= 0 and e["wall_time_us"] > 0
    assert "compute_dtype" in e and "out_dtype" in e
    assert ("kernel_modeled_bytes" in e) == (backend == "cuda")
    assert (e["plan"] is not None) == (backend == "cuda")
    assert load_trace(str(p)) == tr.events  # events are pure JSON


def test_span_fields_follow_the_reference_in_order():
    x, fs = _problem()
    with Trace() as tr:
        repro_torch.mttkrp(x, fs, 0, ctx=_ctx("cuda"))
        repro_torch.multi_ttm(x, [f[:, :2] for f in fs], 1, ctx=_ctx("cuda"))
    with JTrace() as jt:
        repro.mttkrp(jnp.asarray(x.numpy()), [jnp.asarray(f.numpy()) for f in fs], 0,
                     ctx=_jctx("pallas", interpret=True))
        repro.multi_ttm(jnp.asarray(x.numpy()), [jnp.asarray(f.numpy()[:, :2]) for f in fs], 1,
                        ctx=_jctx("pallas", interpret=True))
    for got, want in zip(tr.events, jt.events):
        # the reference's keys, in its order, then the port's kernel_modeled_bytes
        assert list(got) == list(want) + ["kernel_modeled_bytes"]


def test_trace_ring_buffer_evicts_and_counts():
    before = registry().counter("trace.events_dropped")
    with Trace(capacity=2) as tr:
        for i in range(5):
            tr.record("synthetic", i=i)
    assert len(tr) == 2
    assert [e["i"] for e in tr.events] == [3, 4]  # oldest evicted
    assert registry().counter("trace.events_dropped") == before + 3


@pytest.mark.parametrize("kw,match", [({"capture": "everything"}, "capture"),
                                      ({"capacity": 0}, "capacity")])
def test_trace_validates_arguments(kw, match):
    with pytest.raises(ValueError, match=match):
        Trace(**kw)
    with pytest.raises(ValueError, match=match):
        JTrace(**kw)


# ---------------------------------------------------------------------------
# The gate: capture policy, and the port's three refusals
# ---------------------------------------------------------------------------

def test_capture_observed_requires_the_context_to_opt_in():
    x, fs = _problem()
    with Trace(capture="observed") as tr:
        repro_torch.mttkrp(x, fs, 0, ctx=_ctx(observe=False))
        assert len(tr) == 0
        repro_torch.mttkrp(x, fs, 0, ctx=_ctx(observe=True))
        assert len(tr) == 1


def _compiling(monkeypatch):
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    return torch.ones(3)


def _capturing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    return torch.ones(3)


def _meta(monkeypatch):
    return torch.ones(3, device="meta")


def _fake(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode().from_tensor(torch.ones(3))


@pytest.mark.parametrize("make", [_compiling, _capturing, _meta, _fake],
                         ids=["compiling", "graph_capture", "meta", "fake"])
def test_the_gate_refuses_what_is_not_a_concrete_dispatch(monkeypatch, make):
    concrete = torch.ones(3)
    with Trace():
        assert should_record(True, concrete)
        operand = make(monkeypatch)
        assert not should_record(True, operand)
    assert not should_record(True, concrete)  # no trace active


@pytest.mark.parametrize("backend", ["einsum", "blocked_host", "cuda"])
@pytest.mark.parametrize("schedule", ["per_mode", "fused", "dimtree"])
def test_observe_changes_neither_results_nor_aten_operations(backend, schedule):
    """The zero-overhead contract: a traced run gives the same bits and
    runs the same aten operations as an untraced one."""
    x, init = problem(DIMS, RANK, 1)
    runs = []
    for traced in (False, True):
        ctx = _ctx(backend, observe=traced)
        with OpBoundaries() as ops, (Trace() if traced else _Nothing()):
            res = repro_torch.cp_als(_t(x), RANK, 2, init_factors=[_t(f) for f in init],
                                     sweep=schedule, ctx=ctx)
        # the profiler ranges a trace opens are no aten operation
        runs.append((res, [o for o in ops.ops if o.startswith("aten.")]))
    (a, ops_a), (b, ops_b) = runs
    assert a.fits == b.fits and ops_a == ops_b
    for fa, fb in zip(a.factors, b.factors):
        assert torch.equal(fa, fb)


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


# ---------------------------------------------------------------------------
# ExecutionContext.observe
# ---------------------------------------------------------------------------

def test_observe_round_trips_defaults_off_and_is_hashed():
    ctx = _ctx(observe=True)
    back = ExecutionContext.from_json(ctx.to_json())
    assert back == ctx and back.observe is True
    assert _ctx().observe is False and hash(_ctx()) != hash(ctx)
    d = json.loads(_ctx().to_json())
    d.pop("observe")  # JSON from before the field still loads
    assert ExecutionContext.from_dict(d).observe is False
    assert ctx.to_dict()["observe"] is _jctx(observe=True).to_dict()["observe"] is True


# ---------------------------------------------------------------------------
# MetricsRegistry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,per_call", [("einsum", 0), ("blocked_host", 0), ("cuda", 1)])
def test_registry_counts_dispatches_per_backend(backend, per_call):
    """One dispatch a contraction on ``cuda``, none on the host backends,
    as the reference counts Pallas (``engine.pallas_dispatches``)."""
    x, fs = _problem()
    before = registry().snapshot()
    for mode in range(len(DIMS)):
        repro_torch.mttkrp(x, fs, mode, ctx=_ctx(backend))
    assert registry().delta(before).get(CUDA_DISPATCHES, 0) == per_call * len(DIMS)
    jbackend = "pallas" if backend == "cuda" else backend
    jbefore = repro.observe.registry().snapshot()
    for mode in range(len(DIMS)):
        repro.mttkrp(jnp.asarray(x.numpy()), [jnp.asarray(f.numpy()) for f in fs], mode,
                     ctx=_jctx(jbackend, interpret=True))
    assert repro.observe.registry().delta(jbefore).get("engine.pallas_dispatches", 0) \
        == per_call * len(DIMS)


def test_snapshots_do_not_interfere():
    reg = MetricsRegistry()
    snap_a = reg.snapshot()
    reg.inc("k")
    snap_b = reg.snapshot()
    reg.inc("k")
    assert reg.delta(snap_a) == {"k": 2}
    assert reg.delta(snap_b) == {"k": 1}
    assert snap_a.get("k", 0) == 0


def test_registry_histograms_and_to_dict():
    for reg in (MetricsRegistry(), repro.observe.MetricsRegistry()):
        reg.inc("c", 2)
        reg.set_gauge("g", 7.5)
        reg.observe("h", 1.0)
        reg.observe("h", 3.0)
        assert reg.histogram("h") == (1.0, 3.0)
        d = reg.to_dict()
        assert d == {"counters": {"c": 2}, "gauges": {"g": 7.5},
                     "histograms": {"h": {"count": 2, "sum": 4.0, "min": 1.0, "max": 3.0}}}


def test_canonical_names_keep_the_reference_strings():
    from repro.observe import metrics as jm
    from repro_torch.observe import metrics as tm

    for name in ("TUNE_CACHE_HITS", "TUNE_CACHE_MISSES", "TUNE_CANDIDATES",
                 "TUNE_SEARCH_TIME_US", "TRACE_EVENTS_DROPPED"):
        assert getattr(tm, name) == getattr(jm, name)
    assert tm.CUDA_DISPATCHES == "engine.cuda_dispatches"


def test_tune_counters(tmp_path, monkeypatch):
    """A resolution's miss, a search's measurements, search time and span,
    and a hit on the replay, each counted once where the reference counts."""
    from repro_torch.tune import search
    from repro_torch.tune.cache import isolated_cache

    x, fs = _problem()
    with isolated_cache():
        before = registry().snapshot()
        r = search.resolve(DIMS, RANK, 0, torch.float32, device="cpu")
        assert not r.cache_hit
        delta = registry().delta(before)
        assert delta.get(TUNE_CACHE_MISSES, 0) == 1 and TUNE_CACHE_HITS not in delta
        hist = len(registry().histogram(TUNE_SEARCH_TIME_US))
        before = registry().snapshot()
        with Trace() as tr:
            res = search.tune_mttkrp(x, fs, 0, reps=1, warmup=0)
        timed = sum(m.walltime_us == m.walltime_us for m in res.measurements)
        assert registry().delta(before).get(TUNE_CANDIDATES, 0) == timed > 0
        assert len(registry().histogram(TUNE_SEARCH_TIME_US)) == hist + 1
        (ev,) = [e for e in tr.events if e["kind"] == "tune_search"]
        assert (ev["candidates"], ev["timed"], ev["winner"]) == (
            len(res.measurements), timed, res.winner.label)
        before = registry().snapshot()
        assert search.resolve(DIMS, RANK, 0, torch.float32, device="cpu").cache_hit
        assert registry().delta(before) == {TUNE_CACHE_HITS: 1}


# ---------------------------------------------------------------------------
# The trace triples against the reference
# ---------------------------------------------------------------------------

def _pair_edge(e) -> bool:
    """A reference span of the two edges the fused pair kernel replaces."""
    n = len(DIMS)
    return e["kind"] == "contract_partial" and e["drop"] in ([n - 1], list(range(1, n - 1)))


@pytest.mark.parametrize("schedule", ["per_mode", "fused", "dimtree"])
@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_cp_als_trace_triples_equal_the_reference(tmp_path, schedule, backend):
    """Every dispatch's ``modeled_words`` and ``lower_bound_words`` equal
    the reference's event by event (the reference on einsum; on the port's
    ``cuda`` the fused pair is one event where the reference has two
    ``contract_partial`` edges), with lower bound <= modeled words; the
    iteration events carry the run's fits."""
    x, init = problem(DIMS, RANK, 2)
    p = tmp_path / "cp.jsonl"
    with Trace(path=str(p)):
        res = repro_torch.cp_als(_t(x), RANK, 2, init_factors=[_t(f) for f in init],
                                 sweep=schedule, ctx=_ctx(backend, observe=True))
    with JTrace() as jt:
        ref = repro.cp_als(jnp.asarray(x), RANK, 2, init_factors=[jnp.asarray(f) for f in init],
                           sweep=schedule, ctx=_jctx(observe=True))
    events = load_trace(str(p))
    want = [e for e in jt.events if not (backend == "cuda" and schedule == "fused"
                                         and _pair_edge(e))]
    assert _triples(events) == _triples(want)
    mem = _mem()
    for e in events:
        if e["kind"] == "mttkrp":
            canon = keep_first(DIMS, e["mode"])
            assert e["modeled_words"] == choose_blocks(canon, RANK, 4, memory=mem).eq10_words(
                canon, RANK)
            assert e["lower_bound_words"] == max(seq_lb_memory(DIMS, RANK, 64), 0.0)
        if "modeled_words" in e:
            assert e["lower_bound_words"] <= e["modeled_words"]
    iters = [e for e in events if e["kind"] == "cp_als_iter"]
    assert [e["fit"] for e in iters] == res.fits and [e["it"] for e in iters] == [0, 1]
    assert iters[0]["fit_delta"] is None and len(iters[1]["weights"]) == RANK
    jiters = [e for e in jt.events if e["kind"] == "cp_als_iter"]
    np.testing.assert_allclose([e["fit"] for e in iters], [e["fit"] for e in jiters],
                               atol=1e-5)
    assert [e["schedule"] for e in iters] == [e["schedule"] for e in jiters]
    np.testing.assert_allclose(res.fits, ref.fits, atol=1e-5)


@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_tucker_trace_triples_equal_the_reference(backend):
    x, _ = data(DIMS, RANK, 3)
    with Trace() as tr:
        res = repro_torch.tucker_hooi(_t(x), (2, 3, 2), 2, ctx=_ctx(backend, observe=True))
    with JTrace() as jt:
        ref = repro.tucker_hooi(jnp.asarray(x), (2, 3, 2), 2, ctx=_jctx(observe=True))
    assert _triples(tr.events) == _triples(jt.events)
    kinds = [e["kind"] for e in tr.events]
    assert kinds.count("multi_ttm") == 2 * len(DIMS) and kinds.count("tucker_iter") == 2
    assert [e["fit"] for e in tr.events if e["kind"] == "tucker_iter"] == res.fits
    np.testing.assert_allclose(res.fits, ref.fits, atol=1e-5)
    for e in tr.events:
        if e["kind"] == "multi_ttm":
            assert e["lower_bound_words"] <= e["modeled_words"]
            assert e["ranks"] == [r for k, r in enumerate((2, 3, 2)) if k != e["keep"]]


@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_batched_trace_triples_equal_the_reference(backend):
    rng = np.random.default_rng(4)
    xb = rng.standard_normal((3,) + DIMS, dtype=np.float32)
    inits = [rng.standard_normal((3, d, RANK), dtype=np.float32) for d in DIMS]
    with Trace() as tr:
        cp = repro_torch.cp_als_batched(_t(xb), RANK, 2, init_factors=[_t(f) for f in inits],
                                        ctx=_ctx(backend))
        repro_torch.tucker_hooi_batched(_t(xb), (2, 2, 2), 1, ctx=_ctx(backend))
    with JTrace() as jt:
        repro.cp_als_batched(jnp.asarray(xb), RANK, 2,
                             init_factors=[jnp.asarray(f) for f in inits], ctx=_jctx())
        repro.tucker_hooi_batched(jnp.asarray(xb), (2, 2, 2), 1, ctx=_jctx())
    assert _triples(tr.events) == _triples(jt.events)
    for kind in ("mttkrp", "multi_ttm", "cp_als_batched_iter", "tucker_batched_iter"):
        got = [e for e in tr.events if e["kind"] == kind]
        want = [e for e in jt.events if e["kind"] == kind]
        assert len(got) == len(want) > 0
        assert all(e["batch"] == 3 for e in got)
    iters = [e for e in tr.events if e["kind"] == "cp_als_batched_iter"]
    assert iters[-1]["fits"] == cp.fits.tolist() and len(iters[-1]["converged"]) == 3


def test_dimtree_sweep_event_equals_the_reference():
    from repro.engine.tree import all_mode_mttkrp as j_all_mode
    from repro_torch.engine.tree import all_mode_mttkrp

    x, fs = _problem()
    with Trace() as tr:
        got = all_mode_mttkrp(x, fs, ctx=_ctx())
    with JTrace() as jt:
        want = j_all_mode(jnp.asarray(x.numpy()), [jnp.asarray(f.numpy()) for f in fs],
                          ctx=_jctx())
    strip = ("seq", "time_s", "schema")

    def sweep(events):
        (e,) = [e for e in events if e["kind"] == "dimtree_sweep"]
        return {k: v for k, v in e.items() if k not in strip}

    assert sweep(tr.events) == sweep(jt.events)
    assert _triples(tr.events) == _triples(jt.events)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("schedule,per_iter", [
    ("per_mode", {"mttkrp": 3}),
    ("fused", {"fused_pair": 1, "contract_partial": 1, "mttkrp": 1}),
    ("dimtree", {"contract_partial": 4}),
])
def test_cuda_spans_of_every_schedule_carry_the_launched_plan(schedule, per_iter):
    """On ``cuda`` every dispatch event carries the kernel plan its wrapper
    launched (on a CPU tensor, the plan the card would launch), read back
    through ``plan_from_dict``, and ``kernel_modeled_bytes``; the registry
    counts one dispatch an event."""
    from repro_torch.tune.search import kernel_plan_bytes

    x, init = problem(DIMS, RANK, 5)
    before = registry().snapshot()
    with Trace() as tr:
        repro_torch.cp_als(_t(x), RANK, 3, init_factors=[_t(f) for f in init], sweep=schedule,
                           ctx=_ctx("cuda"))
    dispatches = [e for e in tr.events if e["kind"] in DISPATCH]
    counts = {k: sum(e["kind"] == k for e in dispatches) for k in per_iter}
    assert counts == {k: 3 * n for k, n in per_iter.items()}
    assert len(dispatches) == 3 * sum(per_iter.values())
    assert registry().delta(before).get(CUDA_DISPATCHES, 0) == len(dispatches)
    for e in dispatches:
        assert e["backend"] == "cuda" and e["kernel_modeled_bytes"] > 0
        plan = plan_from_dict(e["plan"])
        if e["kind"] == "mttkrp":
            canon = keep_first(DIMS, e["mode"])
            assert plan == choose_mttkrp_kernel_blocks(canon, RANK, 4)
            assert e["kernel_modeled_bytes"] == kernel_plan_bytes(plan, canon, RANK, 4)
        elif e["kind"] == "fused_pair":
            assert isinstance(plan, MTTKRPKernelPlan) and e["shape"] == list(DIMS)
        else:
            assert e["has_rank"] == (type(plan).__name__ == "PartialKernelPlan")


def test_multi_ttm_span_plan_is_the_kernel_plan():
    x, fs = _problem()
    mats = [f[:, :2] for f in fs]
    with Trace() as tr:
        for keep in (None, 0, 1, 2):
            repro_torch.multi_ttm(x, mats, keep, ctx=_ctx("cuda"))
    for e, keep in zip(tr.events, (None, 0, 1, 2)):
        canon = keep_first(DIMS, 0 if keep is None else keep)
        ranks = (2, 2) if keep is not None else (2, 2)
        assert plan_from_dict(e["plan"]) == choose_multi_ttm_kernel_blocks(canon, ranks, 4)


# ---------------------------------------------------------------------------
# The bounds audit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["einsum", "cuda"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_audit_mttkrp_model_and_bound_equal_the_reference(backend, mode):
    x, fs = _problem()
    with Trace() as tr:
        row = audit_mttkrp(x, fs, mode, ctx=_ctx(backend))
    jrow = j_audit_mttkrp(jnp.asarray(x.numpy()), [jnp.asarray(f.numpy()) for f in fs], mode,
                          ctx=_jctx())
    assert (row.name, row.itemsize, row.modeled_words, row.lower_bound_words) == (
        jrow.name, jrow.itemsize, jrow.modeled_words, jrow.lower_bound_words)
    once = x.nbytes + sum(f.nbytes for k, f in enumerate(fs) if k != mode) + DIMS[mode] * RANK * 4
    assert row.measured_bytes >= once and row.measured_bytes >= row.lower_bound_bytes
    assert row.measured_by == "op_boundaries" and row.model_over_bound >= 1.0
    d = row.to_dict()
    assert d["modeled_bytes"] == row.modeled_words * row.itemsize
    assert set(jrow.to_dict()) | {"measured_by"} == set(d)
    (ev,) = [e for e in tr.events if e["kind"] == "bounds_audit"]
    assert ev["measured_bytes"] == row.measured_bytes and ev["measured_by"] == "op_boundaries"


@pytest.mark.parametrize("keep", [None, 0, 1, 2])
@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_audit_multi_ttm_model_and_bound_equal_the_reference(backend, keep):
    x, fs = _problem()
    mats = [f[:, :2] for f in fs]
    row = audit_multi_ttm(x, mats, keep, ctx=_ctx(backend))
    jrow = j_audit_multi_ttm(jnp.asarray(x.numpy()), [jnp.asarray(m.numpy()) for m in mats],
                             keep, ctx=_jctx())
    assert (row.name, row.modeled_words, row.lower_bound_words) == (
        jrow.name, jrow.modeled_words, jrow.lower_bound_words)
    assert row.measured_bytes >= x.nbytes + sum(m.nbytes for k, m in enumerate(mats) if k != keep)


def test_audit_counts_the_transpose_in_front_of_the_kernel():
    """On ``cuda`` mode 0 reaches the kernel with no copy; mode 1 pays one
    transpose, X read and written once, in aten bytes: the rest is the
    kernels' own report (the same on the CPU as on the card)."""
    x, fs = _problem()
    counted = {}
    for mode in (0, 1):
        with OpBoundaries() as ops:
            repro_torch.mttkrp(x, fs, mode, ctx=_ctx("cuda"))
        counted[mode] = (ops.aten_bytes, [k.name for k in ops.kernels])
    assert counted[0][0] == 0 and counted[1][0] == 2 * x.nbytes
    assert counted[0][1][0] == counted[1][1][0] == "mttkrp3"


def test_a_view_moves_nothing_and_a_copy_twice_the_tensor():
    x = torch.randn(6, 5, 4)
    with OpBoundaries() as ops:
        v = x.permute(2, 0, 1)
    assert ops.aten_bytes == 0 and ops.ops
    with OpBoundaries() as ops:
        v.contiguous()
    assert ops.aten_bytes == 2 * x.nbytes
    with OpBoundaries() as ops:
        torch.empty(100)
        v.reshape(120)  # a materializing reshape is a copy
    assert ops.aten_bytes == 2 * x.nbytes
    y = torch.empty(6, 5, 4)
    with OpBoundaries() as ops:
        y.copy_(x)  # reads x, writes y
    assert ops.aten_bytes == 2 * x.nbytes


@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_the_count_ratio_to_the_reference_at_the_pinned_problem(backend):
    """The reference's HLO fusion-boundary bytes (its einsum MTTKRP) and
    the port's op-boundary bytes of the same MTTKRP both count the operands
    and the output at least once; on the pinned problem they stay within a
    factor of 4 of each other (docs/PORT.md gives the readings)."""
    x, fs = _problem()
    for mode in range(len(DIMS)):
        row = audit_mttkrp(x, fs, mode, ctx=_ctx(backend))
        jrow = j_audit_mttkrp(jnp.asarray(x.numpy()), [jnp.asarray(f.numpy()) for f in fs],
                              mode, ctx=_jctx())
        assert 0.25 <= row.measured_bytes / jrow.measured_bytes <= 4.0


# ---------------------------------------------------------------------------
# summarize_events and the report CLI
# ---------------------------------------------------------------------------

def test_summarize_events_totals():
    events = [
        {"kind": "mttkrp", "modeled_words": 100, "itemsize": 4, "lower_bound_words": 10},
        {"kind": "bounds_audit", "modeled_words": 50, "itemsize": 4, "lower_bound_words": 0,
         "measured_bytes": 300.0},
    ]
    s = summarize_events(events)
    assert s == repro.observe.summarize_events(events)
    assert (s["events"], s["modeled_words"], s["lower_bound_words"], s["measured_bytes"]) == (
        2, 150.0, 10.0, 300.0)
    assert s["optimality_ratio"] == pytest.approx(300.0 / 600.0)
    empty = summarize_events([])
    assert empty["measured_bytes"] is None and empty["optimality_ratio"] is None


def test_report_cli_renders_the_reference_table(tmp_path, capsys):
    from repro.observe.report import main as j_report_main

    x, fs = _problem()
    p = tmp_path / "trace.jsonl"
    with Trace(path=str(p)):
        repro_torch.mttkrp(x, fs, 0, ctx=_ctx("cuda", observe=True))
        audit_mttkrp(x, fs, 0, ctx=_ctx("cuda"))
    assert report_main([str(p)]) == 0
    out = capsys.readouterr().out
    assert "| kind |" in out and "mttkrp" in out and "bounds_audit" in out
    assert j_report_main([str(p)]) == 0  # the reference reads the port's trace
    assert capsys.readouterr().out == out


def test_report_cli_empty_trace_fails(tmp_path):
    p = tmp_path / "empty.jsonl"
    p.write_text("")
    assert report_main([str(p)]) == 1
    assert report_main([str(tmp_path / "missing.jsonl")]) == 2


def test_report_cli_flags_excess_traffic(tmp_path, capsys):
    p = tmp_path / "hot.jsonl"
    e = {"schema": SPAN_SCHEMA, "seq": 0, "time_s": 0.0, "kind": "bounds_audit",
         "itemsize": 4, "modeled_words": 10, "lower_bound_words": 0, "measured_bytes": 400.0}
    p.write_text(json.dumps(e) + "\n")
    assert report_main([str(p)]) == 0
    assert "!" in capsys.readouterr().out
    assert report_main([str(p), "--strict"]) == 1
    assert report_main([str(p), "--strict", "--flag-factor", "20"]) == 0
    assert report_main([str(p), "--kinds", "mttkrp"]) == 1


def test_report_keeps_the_reference_kinds():
    from repro.observe.report import DISPATCH_KINDS as J_KINDS
    from repro_torch.observe.report import DISPATCH_KINDS

    assert DISPATCH_KINDS == J_KINDS and "static_verify" in DISPATCH_KINDS


def test_exports_match_the_reference():
    assert repro_torch.Trace is Trace and "Trace" in repro_torch.__all__
    assert observe.__all__ == repro.observe.__all__
