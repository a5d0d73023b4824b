"""The port's tuning slice against the reference, on the CPU (the
counterpart of ``tests/test_tune.py``): the plan cache, the searches and
their bookkeeping, ``backend="auto"`` at every engine entry, ``sweep="auto"``
and the calibration.

Each input is made with numpy from a seed and goes through both packages,
each with its own throwaway cache file (``REPRO_TUNE_CACHE`` for the
reference, ``REPRO_TORCH_TUNE_CACHE`` for the port). On CPU tensors the
port's ``cuda`` candidates run the kernels' plain versions, so these tests
check the search's bookkeeping; which plan wins is the card's to decide
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 12). Outputs agree
within 1e-5 of their largest magnitude (``_torch_parity.close``), CP fits
within 1e-5 a step and factors within 1e-4 (``assert_same_cp``), Tucker fits
within 1e-5.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.engine.tree import all_mode_mttkrp as j_all_mode
from repro.tune import cache as jcache
from repro.tune.calibrate import calibrate as j_calibrate
from repro_torch.engine.context import ExecutionContext, PlanDecision, ProblemSpec
from repro_torch.engine.plan import (
    BlockPlan,
    Memory,
    MTTKRPKernelPlan,
    MultiTTMKernelPlan,
    MultiTTMPlan,
    PartialKernelPlan,
    SMEM_PER_CTA_MAX,
    choose_mttkrp_kernel_blocks,
    choose_multi_ttm_kernel_blocks,
    mttkrp_kernel_smem_bytes,
    multi_ttm_kernel_smem_bytes,
    mttkrp_kernel_grid,
)
from repro_torch.engine.tree import all_mode_mttkrp
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import partial as partial_mod
from repro_torch.observe.metrics import TUNE_CACHE_HITS, TUNE_CACHE_MISSES, registry
from repro_torch.tune import cache as tcache
from repro_torch.tune import search
from repro_torch.tune.calibrate import (
    DEFAULT_CASES,
    blocked_mttkrp_bytes,
    calibrate,
    calibration_report,
    load_calibration,
)

from _torch_parity import assert_same_cp, close, data, problem


def _cache_counts(before) -> dict:
    """The tune cache's hits and misses since ``before`` (a registry snapshot)."""
    delta = registry().delta(before)
    return {"hit": delta.get(TUNE_CACHE_HITS, 0), "miss": delta.get(TUNE_CACHE_MISSES, 0)}

KINDS = ("mttkrp", "partial", "multi_ttm", "sweep", "serve")


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """A throwaway cache file for each package; returns the port's path."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "ref.json"))
    path = str(tmp_path / "port.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", path)
    return path


def _ctx(backend="auto", **kw):
    return ExecutionContext.create(backend, device="cpu", **kw)


def _jctx(backend="auto", **kw):
    return repro.ExecutionContext.create(backend=backend, **kw)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _prefix(key):
    """A key up to its platform and version fields."""
    return key.rsplit("|", 2)[0]


# ---------------------------------------------------------------------------
# the cache: keys, plans, files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("memory", ["tpu_vmem", "abstract"])
def test_cache_key_equals_the_reference_up_to_platform(kind, dtype, memory):
    rank = (3, 4, 2) if kind == "multi_ttm" else 5
    tmem = Memory.tpu_vmem(itemsize=2) if memory == "tpu_vmem" else Memory.abstract(4096)
    jmem = repro.Memory.tpu_vmem(itemsize=2) if memory == "tpu_vmem" \
        else repro.Memory.abstract(4096)
    got = tcache.cache_key((16, 12, 8), rank, 1, getattr(torch, dtype), tmem, kind=kind,
                           device="cpu")
    want = jcache.cache_key((16, 12, 8), rank, 1, getattr(jnp, dtype), jmem, kind=kind)
    assert _prefix(got) == _prefix(want)
    assert got.endswith(f"|platform=cpu|torch={torch.__version__}")
    assert f"|dtype={dtype}|" in got
    # a dtype given by name writes the same key
    assert tcache.cache_key((16, 12, 8), rank, 1, dtype, tmem, kind=kind, device="cpu") == got


def test_cache_key_changes_with_every_field():
    mem = Memory.h100_smem()
    base = tcache.cache_key((16, 12, 8), 4, 0, torch.float32, mem, device="cpu")
    others = [
        tcache.cache_key((16, 12, 8), 4, 0, torch.float32, Memory.h100_smem(1 << 16),
                         device="cpu"),
        tcache.cache_key((16, 12, 8), 4, 0, torch.bfloat16, mem, device="cpu"),
        tcache.cache_key((16, 12, 8), 4, 0, torch.float32, mem, kind="partial", device="cpu"),
        tcache.cache_key((16, 12, 8), 5, 0, torch.float32, mem, device="cpu"),
        tcache.cache_key((16, 12, 8), 4, 1, torch.float32, mem, device="cpu"),
        tcache.cache_key((16, 12, 9), 4, 0, torch.float32, mem, device="cpu"),
    ]
    assert len({base, *others}) == 7


PLANS = [
    BlockPlan(24, (8, 120), 40, x_has_rank=True),
    MultiTTMPlan(8, (16, 4), (3, 2)),
    MTTKRPKernelPlan(128, 64, 64, 2),
    MultiTTMKernelPlan(192, 32, 16, 3),
    PartialKernelPlan("contract", 8, 4, 8, 33),
]


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: type(p).__name__)
def test_plan_round_trips_as_its_type(plan):
    d = tcache.plan_to_dict(plan)
    assert d["type"] == type(plan).__name__
    back = tcache.plan_from_dict(json.loads(json.dumps(d)))
    assert back == plan and type(back) is type(plan)


@pytest.mark.parametrize("plan", [repro.BlockPlan(24, (8, 120), 40, x_has_rank=True),
                                  repro.MultiTTMPlan(8, (16, 4), (3, 2))],
                         ids=["BlockPlan", "MultiTTMPlan"])
def test_plan_from_dict_reads_the_reference_form(plan):
    back = tcache.plan_from_dict(jcache.plan_to_dict(plan))
    assert back.__dict__ == plan.__dict__
    assert type(back).__name__ == type(plan).__name__


def test_plan_from_dict_refuses_unknown_types():
    with pytest.raises(ValueError, match="unknown plan type"):
        tcache.plan_from_dict({"type": "NopePlan", "block_i": 1})
    with pytest.raises(TypeError, match="not a plan"):
        tcache.plan_to_dict(object())


def test_cache_persists_and_replays_through_a_fresh_instance(tmp_path):
    path = str(tmp_path / "c.json")
    plan = MTTKRPKernelPlan(64, 32, 32, 3)
    key = tcache.cache_key((16, 12, 8), 4, 0, torch.float32, Memory.h100_smem(), device="cpu")
    tcache.PlanCache(path).put(key, tcache.CacheEntry("cuda", tcache.plan_to_dict(plan),
                                                      variant="generic", score=12.5,
                                                      walltime_us=12.5))
    entry = tcache.PlanCache(path).get(key)
    assert entry.backend == "cuda" and entry.variant == "generic"
    assert entry.to_plan() == plan
    raw = json.load(open(path))
    assert raw["schema"] == tcache.SCHEMA_VERSION and raw["torch"] == torch.__version__
    c = tcache.PlanCache(path)
    c.put_calibration({"bandwidth_bytes_per_us": 1.0})
    assert tcache.PlanCache(path).get_calibration() == {"bandwidth_bytes_per_us": 1.0}
    c.invalidate(key)
    assert tcache.PlanCache(path).get(key) is None
    c.clear()
    assert len(tcache.PlanCache(path)) == 0


def test_cache_schema_version_invalidates(tmp_path):
    path = str(tmp_path / "c.json")
    tcache.PlanCache(path).put("k", tcache.CacheEntry("einsum"))
    raw = json.load(open(path))
    raw["schema"] = tcache.SCHEMA_VERSION + 1
    json.dump(raw, open(path, "w"))
    c2 = tcache.PlanCache(path)
    assert c2.get("k") is None and len(c2) == 0  # the whole file goes
    c2.put("k2", tcache.CacheEntry("einsum"))
    assert tcache.PlanCache(path).get("k2") is not None


@pytest.mark.parametrize("content", [b"not json{{{", b"", b'{"schema": 1, "entries": 42}',
                                     b"[1, 2, 3]", b'{"schema": 1, "entries": {"k": 7}}'])
def test_cache_corrupted_file_recovers(tmp_path, content):
    path = str(tmp_path / "c.json")
    with open(path, "wb") as f:
        f.write(content)
    c = tcache.PlanCache(path)
    assert len(c) == 0  # never raises
    c.put("k", tcache.CacheEntry("einsum"))
    assert tcache.PlanCache(path).get("k").backend == "einsum"


def test_corrupted_cache_falls_back_to_the_miss(caches):
    with open(caches, "w") as f:
        f.write("garbage")
    x, fs = data((8, 7, 6), 3, 1)
    close(repro_torch.mttkrp(_t(x), [_t(f) for f in fs], 0, ctx=_ctx()),
          repro.mttkrp(_j(x), [_j(f) for f in fs], 0, ctx=_jctx("einsum")))


def test_isolated_cache_redirects_and_restores(monkeypatch):
    monkeypatch.setenv(tcache.ENV_CACHE_PATH, "/nonexistent/keep.json")
    with tcache.isolated_cache() as tmp:
        assert tcache.resolve_cache_path() == tmp
        assert tcache.default_cache().path == tmp
    assert tcache.resolve_cache_path() == "/nonexistent/keep.json"
    monkeypatch.delenv(tcache.ENV_CACHE_PATH)
    assert tcache.resolve_cache_path().endswith("repro-mttkrp-torch/plans.json")
    assert tcache.resolve_cache_path() != jcache.resolve_cache_path(None).replace(
        "REPRO_TUNE_CACHE", "")


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------

def test_candidates_cover_executors_and_variants():
    cands = search.generate_candidates((16, 12, 8), 4, Memory.h100_smem())
    assert {c.backend for c in cands} == {"einsum", "blocked_host", "cuda"}
    assert {c.variant for c in cands if c.backend == "cuda"} == {"specialized", "generic"}
    plans = [c.plan for c in cands if c.backend == "cuda"]
    assert plans[0] == choose_mttkrp_kernel_blocks((16, 12, 8), 4)  # the chooser's first
    assert len(set(plans)) == 8
    assert {c.variant for c in search.generate_candidates((8, 8, 8, 8), 4, Memory.h100_smem())
            if c.backend == "cuda"} == {"generic"}


@pytest.mark.parametrize("shape,rank,itemsize", [((1000, 1000, 1000), 64, 4),
                                                 ((180, 180, 180, 180), 32, 4),
                                                 ((256, 256, 256), 32, 2)])
@pytest.mark.parametrize("kernel", ["mttkrp", "pair"])
def test_ring_candidates_are_the_chooser_and_feasible_neighbours(shape, rank, itemsize,
                                                                 kernel):
    plans = search.candidate_plans(shape, rank, itemsize, kernel=kernel)
    assert 1 < len(plans) <= 8 and len(set(plans)) == len(plans)
    assert plans[0].block_r == plans[-1].block_r
    for p in plans:
        p.check(itemsize)
        assert p.block_i in (64, 128) and p.block_k * itemsize in (64, 128, 256)
        assert mttkrp_kernel_smem_bytes(p, itemsize, len(shape) - 1) <= SMEM_PER_CTA_MAX


def test_multi_ttm_candidates():
    canon, ranks = (1000, 1000, 1000), (32, 32)
    plans = search.multi_ttm_candidate_plans(canon, ranks)
    assert plans[0] == choose_multi_ttm_kernel_blocks(canon, ranks)
    assert {p.block_m for p in plans} <= {64, 128, 192} and len(plans) <= 8
    for p in plans:
        assert multi_ttm_kernel_smem_bytes(p, 4, ranks) <= SMEM_PER_CTA_MAX


def test_partial_candidates_start_with_the_wrappers_plan():
    node = torch.randn(20, 18, 16)
    view = node.permute(1, 0, 2)
    fs = [torch.randn(20, 16)]
    plans = search.partial_candidate_plans(view, fs)
    assert plans[0] == partial_mod.default_plan(view, fs)
    assert {p.layout for p in plans} == {"rows", "contract"} and len(plans) <= 8
    for p in plans:
        p.check(16, 4)


def test_kernel_plan_bytes_counts_the_input_once():
    plan = MTTKRPKernelPlan(128, 64, 64, 4)
    rows, _, splits = mttkrp_kernel_grid((1000, 1000, 1000), 64, plan)
    got = search.kernel_plan_bytes(plan, (1000, 1000, 1000), 64)
    # X once; B's rows a chunk and A's row a j, once a row tile; the
    # workspace written once a split, then reduced
    out = 1000 * 64 * 4
    assert got == 4e9 + rows * (1000 * 1000 + 1000) * 64 * 4 + 3 * out * splits
    wider = search.kernel_plan_bytes(MTTKRPKernelPlan(64, 64, 64, 4), (1000, 1000, 1000), 64)
    assert wider > got  # twice the row tiles stream the factors twice as often


# ---------------------------------------------------------------------------
# search, tune, resolve
# ---------------------------------------------------------------------------

def _tp(dims=(16, 12, 8), rank=4, seed=0):
    x, fs = data(dims, rank, seed)
    return _t(x), [_t(f) for f in fs]


@pytest.mark.parametrize("metric", ["walltime", "traffic"])
def test_search_winner_is_the_fastest_measured(caches, metric):
    x, fs = _tp()
    res = search.search(x, fs, 0, metric=metric, reps=1, warmup=0)
    finite = [m for m in res.measurements if m.ok and math.isfinite(m.walltime_us)]
    assert res.winner == min(finite, key=lambda m: m.walltime_us).candidate
    assert all(m.ok for m in res.measurements)
    for m in res.measurements:
        if metric == "traffic" and m.candidate.backend == "cuda":
            assert m.score == float(m.modeled_bytes)
        elif math.isfinite(m.walltime_us):
            assert m.score == m.walltime_us
    if metric == "traffic":  # one kernel plan timed, the rest modeled
        assert sum(math.isfinite(m.walltime_us) for m in res.measurements
                   if m.candidate.backend == "cuda") == 1


def test_a_wrong_candidate_loses_and_is_recorded():
    x, fs = _tp()
    bad = search.Candidate("cuda", plan=MTTKRPKernelPlan(64, 16, 16, 2))  # fine here ...
    ref = repro_torch.mttkrp(x, fs, 0, ctx=_ctx("einsum"))
    m = search.measure_candidate(x, fs, 0, bad, reference=ref * 2, reps=1, warmup=0)
    assert not m.ok and "maxerr" in m.error  # ... but held against a wrong oracle
    m = search.measure_candidate(x, fs, 0, search.Candidate("cuda", variant="nope"),
                                 reference=ref, reps=1, warmup=0)
    assert not m.ok and "ValueError" in m.error


@pytest.mark.parametrize("op", ["mttkrp", "mttkrp_partial_canonical", "multi_ttm_canonical"])
def test_a_kernel_that_fails_to_launch_raises_out_of_the_tuner(caches, monkeypatch, op):
    """Only a wrong answer or a refused plan loses: a kernel that fails to
    launch (here its CPU stand-in) raises, and nothing is persisted."""
    def broken(*a, **kw):
        raise RuntimeError(f"{op}: CUDA error 700 at launch")

    monkeypatch.setattr(kernel_ops, op, broken)
    x, fs = _tp()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        if op == "mttkrp":
            search.tune_mttkrp(x, fs, 0, reps=1, warmup=0)
        elif op == "mttkrp_partial_canonical":
            node = _t(np.random.default_rng(5).standard_normal((16, 12, 4), dtype=np.float32))
            search.tune_partial(node, fs, (0, 1), (1,), True, reps=1, warmup=0)
        else:
            search.tune_multi_ttm(x, [f[:, :3] for f in fs], 0, reps=1, warmup=0)
    assert len(tcache.PlanCache(caches)) == 0


def test_resolve_on_a_miss_and_after_a_tune(caches):
    x, fs = _tp()
    before = registry().snapshot()
    r = search.resolve((16, 12, 8), 4, 0, torch.float32, device="cpu")
    assert (r.backend, r.plan, r.cache_hit) == ("einsum", None, False)
    assert _cache_counts(before) == {"hit": 0, "miss": 1}
    res = search.tune_mttkrp(x, fs, 0, reps=1, warmup=0)
    assert not res.cache_hit and res.key == r.key
    r = search.resolve((16, 12, 8), 4, 0, torch.float32, device="cpu")
    assert r.cache_hit and _cache_counts(before) == {"hit": 1, "miss": 1}
    assert (r.backend, r.plan, r.variant, r.block) == (
        res.winner.backend, res.winner.plan, res.winner.variant, res.winner.block)
    again = search.tune_mttkrp(x, fs, 0)
    assert again.cache_hit and again.winner == res.winner
    entry = tcache.PlanCache(caches).get(r.key)  # a fresh instance reads the file
    assert entry.backend == res.winner.backend and entry.to_plan() == res.winner.plan


@pytest.mark.parametrize("entry,match", [
    (tcache.CacheEntry("cuda", tcache.plan_to_dict(MTTKRPKernelPlan(96, 16, 16, 2))),
     "refused"),
    (tcache.CacheEntry("cuda", tcache.plan_to_dict(MTTKRPKernelPlan(64, 16, 16, 5))),
     "refused"),
    (tcache.CacheEntry("cuda", tcache.plan_to_dict(MultiTTMKernelPlan(64, 16, 16, 2))),
     "MTTKRPKernelPlan"),
    (tcache.CacheEntry("cuda", tcache.plan_to_dict(BlockPlan(8, (8, 8), 4))),
     "MTTKRPKernelPlan"),
    (tcache.CacheEntry("pallas"), "not one of"),
    (tcache.CacheEntry("auto"), "not one of"),
])
def test_a_hand_edited_entry_is_refused(caches, entry, match):
    key = tcache.cache_key((16, 12, 8), 4, 0, torch.float32, Memory.h100_smem(), device="cpu")
    tcache.default_cache().put(key, entry)
    # a plan of another type gets the wrappers' TypeError, the rest ValueError
    error = TypeError if match == "MTTKRPKernelPlan" else ValueError
    with pytest.raises(error, match=match):
        search.resolve((16, 12, 8), 4, 0, torch.float32, device="cpu")
    x, fs = _tp()
    with pytest.raises(error, match=match):
        repro_torch.mttkrp(x, fs, 0, ctx=_ctx())


def test_a_cached_partial_plan_is_checked_against_the_rank(caches):
    canon = (16, 12)
    key = tcache.cache_key(canon, 6, 0, torch.float32, Memory.h100_smem(), kind="partial",
                           device="cpu")
    tcache.default_cache().put(key, tcache.CacheEntry("cuda", tcache.plan_to_dict(
        PartialKernelPlan("contract", 8, 4, 8, 1))))  # 4-wide loads cannot divide R=6
    with pytest.raises(ValueError, match="refused"):
        search.resolve(canon, 6, 0, torch.float32, kind="partial", x_has_rank=True,
                       device="cpu")


@pytest.mark.parametrize("keep", [None, 0, 2])
def test_resolve_multi_ttm_on_a_miss_and_after_a_tune(caches, keep):
    x, _ = data((12, 10, 8), 1, 3)
    mats = [_t(m) for m in data((12, 10, 8), 3, 4)[1]]
    ranks = tuple(3 for k in range(3) if k != keep)
    canon = (x.shape[0 if keep is None else keep],) + tuple(
        s for k, s in enumerate(x.shape) if k != (0 if keep is None else keep))
    keep_key = -1 if keep is None else keep
    r = search.resolve_multi_ttm(canon, ranks, keep_key, torch.float32, device="cpu")
    assert (r.backend, r.cache_hit) == ("einsum", False)
    res = search.tune_multi_ttm(_t(x), mats, keep, reps=1, warmup=0)
    assert {m.candidate.backend for m in res.measurements} == {"einsum", "blocked_host", "cuda"}
    r = search.resolve_multi_ttm(canon, ranks, keep_key, torch.float32, device="cpu")
    assert r.cache_hit and (r.backend, r.plan, r.block) == (
        res.winner.backend, res.winner.plan, res.winner.block)
    assert search.tune_multi_ttm(_t(x), mats, keep).cache_hit


@pytest.mark.parametrize("modes,drop,has_rank", [((0, 1, 2), (1, 2), False),
                                                 ((0, 1, 2), (2,), False),
                                                 ((0, 1), (1,), True),
                                                 ((0, 1, 2), (0, 2), True)])
def test_tune_partial_persists_and_replays(caches, modes, drop, has_rank):
    dims = (12, 10, 8)
    rng = np.random.default_rng(5)
    shape = tuple(dims[m] for m in modes) + ((4,) if has_rank else ())
    node = _t(rng.standard_normal(shape, dtype=np.float32))
    fs = [_t(rng.standard_normal((d, 4), dtype=np.float32)) for d in dims]
    res = search.tune_partial(node, fs, modes, drop, has_rank, reps=1, warmup=0)
    assert not res.cache_hit and res.key.startswith("partial|")
    kinds = {type(m.candidate.plan) for m in res.measurements if m.candidate.plan is not None}
    assert kinds == {PartialKernelPlan if has_rank else MTTKRPKernelPlan}
    again = search.tune_partial(node, fs, modes, drop, has_rank)
    assert again.cache_hit and again.winner == res.winner
    out = repro_torch.contract_partial(node, fs, modes, drop, has_rank, ctx=_ctx())
    close(out, repro_torch.contract_partial(node, fs, modes, drop, has_rank,
                                            ctx=_ctx("einsum")).numpy())


def test_resolve_sweep_on_a_miss_and_after_a_tune(caches):
    assert search.resolve_sweep((8, 7, 6), 3, torch.float32, device="cpu").variant == "fused"
    assert search.resolve_sweep((8, 7), 3, torch.float32, device="cpu").variant == "per_mode"
    x, _ = data((8, 7, 6), 1, 2)
    res = search.tune_sweep(_t(x), 3, reps=1, warmup=0)
    assert [m.candidate.variant for m in res.measurements] == ["per_mode", "fused"]
    assert all(m.score == float(m.modeled_bytes) for m in res.measurements)  # traffic
    r = search.resolve_sweep((8, 7, 6), 3, torch.float32, device="cpu")
    assert r.cache_hit and r.variant == res.winner.variant
    assert search.tune_sweep(_t(x), 3).cache_hit


# ---------------------------------------------------------------------------
# backend="auto" and sweep="auto" against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(10, 9, 8), (6, 5, 4, 3), (9, 7)])
def test_auto_mttkrp_matches_the_reference(caches, dims):
    x, fs = data(dims, 3, 6)
    for mode in range(len(dims)):
        close(repro_torch.mttkrp(_t(x), [_t(f) for f in fs], mode, ctx=_ctx()),
              repro.mttkrp(_j(x), [_j(f) for f in fs], mode, ctx=_jctx()))


@pytest.mark.parametrize("modes,drop,has_rank", [((0, 1, 2), (1, 2), False),
                                                 ((0, 1), (1,), True),
                                                 ((0, 1, 2), (0,), True)])
def test_auto_contract_partial_matches_the_reference(caches, modes, drop, has_rank):
    dims = (10, 9, 8)
    rng = np.random.default_rng(7)
    node = rng.standard_normal(tuple(dims[m] for m in modes) + ((3,) if has_rank else ()),
                               dtype=np.float32)
    fs = [rng.standard_normal((d, 3), dtype=np.float32) for d in dims]
    close(repro_torch.contract_partial(_t(node), [_t(f) for f in fs], modes, drop, has_rank,
                                       ctx=_ctx()),
          repro.contract_partial(_j(node), [_j(f) for f in fs], modes, drop, has_rank,
                                 ctx=_jctx()))


@pytest.mark.parametrize("keep", [None, 0, 1, 2])
def test_auto_multi_ttm_matches_the_reference(caches, keep):
    x, _ = data((10, 9, 8), 1, 8)
    mats = data((10, 9, 8), 3, 9)[1]
    ms = [None if k == keep else m for k, m in enumerate(mats)]
    close(repro_torch.multi_ttm(_t(x), [_t(m) for m in ms], keep, ctx=_ctx()),
          repro.multi_ttm(_j(x), [_j(m) for m in ms], keep, ctx=_jctx()))


@pytest.mark.parametrize("dims", [(10, 9, 8), (6, 5, 4, 3)])
def test_auto_dimension_tree_matches_the_reference(caches, dims):
    x, fs = data(dims, 3, 10)
    got = all_mode_mttkrp(_t(x), [_t(f) for f in fs], ctx=_ctx())
    want = j_all_mode(_j(x), [_j(f) for f in fs], ctx=_jctx())
    for g, w in zip(got, want):
        close(g, w)


def test_auto_batched_calls_resolve_once_and_match_the_reference(caches):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 8, 7, 6), dtype=np.float32)
    fs = [rng.standard_normal((3, d, 2), dtype=np.float32) for d in (8, 7, 6)]
    before = registry().snapshot()
    got = repro_torch.mttkrp(_t(x), [_t(f) for f in fs], 1, ctx=_ctx())
    assert _cache_counts(before) == {"hit": 0, "miss": 1}  # one lookup for the batch
    close(got, repro.mttkrp(_j(x), [_j(f) for f in fs], 1, ctx=_jctx()))
    mats = [f[..., :2] for f in fs]
    close(repro_torch.multi_ttm(_t(x), [_t(m) for m in mats], None, ctx=_ctx()),
          repro.multi_ttm(_j(x), [_j(m) for m in mats], None, ctx=_jctx()))


@pytest.mark.parametrize("sweep", ["per_mode", "fused", "dimtree", "auto"])
def test_auto_cp_als_matches_the_reference(caches, sweep):
    x, init = problem((9, 8, 7), 3, 12)
    port = repro_torch.cp_als(_t(x), 3, 4, sweep=sweep, ctx=_ctx(),
                              init_factors=[_t(f) for f in init])
    ref = repro.cp_als(_j(x), 3, 4, sweep=sweep, ctx=_jctx(),
                       init_factors=[_j(f) for f in init])
    assert_same_cp(port, ref)


@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_sweep_auto_runs_the_resolved_schedule(caches, backend):
    x, init = problem((9, 8, 7), 3, 13)
    kw = dict(init_factors=[_t(f) for f in init], ctx=_ctx(backend))
    auto = repro_torch.cp_als(_t(x), 3, 4, sweep="auto", **kw)
    assert auto.fits == repro_torch.cp_als(_t(x), 3, 4, sweep="fused", **kw).fits
    ref = repro.cp_als(_j(x), 3, 4, sweep="auto", ctx=_jctx("einsum"),
                       init_factors=[_j(f) for f in init])
    assert_same_cp(auto, ref)


def test_tune_true_searches_once_and_replays(caches):
    x, init = problem((9, 8, 7), 3, 14)
    kw = dict(init_factors=[_t(f) for f in init], sweep="dimtree")
    tuned = repro_torch.cp_als(_t(x), 3, 3, ctx=_ctx(tune=True), **kw)
    keys = tcache.PlanCache(caches).keys()
    assert any(k.startswith("partial|") for k in keys)
    before = registry().snapshot()
    replay = repro_torch.cp_als(_t(x), 3, 3, ctx=_ctx(), **kw)
    counts = _cache_counts(before)
    assert counts["miss"] == 0 and counts["hit"] > 0
    np.testing.assert_allclose(replay.fits, tuned.fits, rtol=0, atol=1e-6)
    ref = repro.cp_als(_j(x), 3, 3, ctx=_jctx("einsum"), use_dimension_tree=True,
                       init_factors=[_j(f) for f in init])
    assert_same_cp(replay, ref)
    swept = repro_torch.cp_als(_t(x), 3, 2, ctx=_ctx(tune=True), sweep="auto",
                               init_factors=[_t(f) for f in init])
    assert any(k.startswith("sweep|") for k in tcache.PlanCache(caches).keys())
    assert len(swept.fits) == 2


def test_auto_tucker_matches_the_reference(caches):
    x, _ = data((10, 9, 8), 1, 15)
    port = repro_torch.tucker_hooi(_t(x), (3, 3, 2), 3, ctx=_ctx())
    ref = repro.tucker_hooi(_j(x), (3, 3, 2), 3, ctx=_jctx())
    np.testing.assert_allclose(port.fits, list(ref.fits), rtol=0, atol=1e-5)
    pinned = ExecutionContext.for_problem((10, 9, 8), (3, 3, 2), backend="auto", device="cpu")
    assert [d.mode for d in pinned.decisions] == [-1, 0, 1, 2]
    again = repro_torch.tucker_hooi(_t(x), (3, 3, 2), 3, ctx=pinned)
    np.testing.assert_allclose(again.fits, port.fits, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the context
# ---------------------------------------------------------------------------

def test_for_problem_pins_decisions_and_round_trips(caches):
    ctx = ExecutionContext.for_problem((10, 9, 8), 3, backend="auto", device="cpu")
    assert ctx.problem == ProblemSpec((10, 9, 8), 3, "float32")
    assert [(d.mode, d.backend) for d in ctx.decisions] == [(0, "einsum"), (1, "einsum"),
                                                            (2, "einsum")]
    assert ExecutionContext.from_json(ctx.to_json()) == ctx
    assert ctx.decision_for((10, 9, 8), 3, 1, torch.float32).mode == 1
    assert ctx.decision_for((10, 9, 8), 3, 1, torch.bfloat16) is None
    assert ctx.decision_for((10, 9, 9), 3, 1) is None
    jctx = repro.ExecutionContext.for_problem((10, 9, 8), 3, backend="auto")
    assert [d.mode for d in jctx.decisions] == [d.mode for d in ctx.decisions]
    # tune=True pins nothing: the search needs data
    assert ExecutionContext.for_problem((10, 9, 8), 3, backend="auto", tune=True,
                                        device="cpu").decisions == ()
    x, fs = data((10, 9, 8), 3, 16)
    close(repro_torch.mttkrp(_t(x), [_t(f) for f in fs], 2, ctx=ctx),
          repro.mttkrp(_j(x), [_j(f) for f in fs], 2, ctx=jctx))


def test_plan_decisions_are_concrete():
    with pytest.raises(ValueError, match="concrete executor"):
        PlanDecision(0, "auto")
    d = PlanDecision(1, "cuda", MTTKRPKernelPlan(64, 16, 16, 2), "generic", None, True)
    assert PlanDecision.from_dict(json.loads(json.dumps(d.to_dict()))) == d
    with pytest.raises(ValueError, match="problem spec"):
        ExecutionContext(backend="auto", device="cpu", decisions=(d,))


@pytest.mark.parametrize("kw,match", [
    ({"backend": "einsum", "tune": True}, "requires backend='auto'"),
    # observe=True is accepted since the observability slice (match None)
    pytest.param({"backend": "auto", "observe": True}, None, id="kw1-observability slice"),
    ({"compilation_cache": 7}, "directory path"),
])
def test_the_new_options_are_validated(kw, match):
    if match is None:
        ctx = ExecutionContext.create(**{"device": "cpu", **kw})
        assert ctx.observe and ExecutionContext.from_json(ctx.to_json()) == ctx
        return
    with pytest.raises(ValueError, match=match):
        ExecutionContext.create(**{"device": "cpu", **kw})


def test_compilation_cache_round_trips_and_builds_nothing_on_the_cpu(tmp_path):
    ctx = _ctx("cuda", compilation_cache=str(tmp_path / "cc"), cache_path="p.json")
    assert ExecutionContext.from_json(ctx.to_json()) == ctx
    d = ctx.to_dict()
    d.pop("compilation_cache")
    assert ExecutionContext.from_dict(d).compilation_cache is None
    assert ctx.ensure_compilation_cache() is None  # a CPU context builds nothing
    assert not (tmp_path / "cc").exists()
    assert _ctx("cuda").ensure_compilation_cache() is None


def test_the_cuda_default_still_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExecutionContext.create("auto")


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def test_calibrate_requires_three_shapes(caches):
    with pytest.raises(ValueError, match="at least 3"):
        calibrate([((8, 8, 8), 2)], persist=False, device="cpu")
    assert len(DEFAULT_CASES) >= 3


def test_calibration_reports_model_against_measured(caches):
    cases = (((24, 20, 16), 4), ((32, 24, 16), 8), ((20, 16, 12, 8), 4))
    cal = calibrate(cases, reps=1, device="cpu")
    assert len(cal.rows) == 3 and cal.backend == "cpu"
    for (dims, rank), r in zip(cases, cal.rows):
        assert r.model_bytes > 0 and r.measured_bytes == blocked_mttkrp_bytes(
            dims, rank, 0, r.block)
        assert math.isfinite(r.traffic_rel_err) and math.isfinite(r.predicted_us)
    report = calibration_report(cal)
    assert report.count("\n") == 4 and "traffic_err" in report
    loaded = load_calibration(tcache.PlanCache(caches))
    assert loaded.bandwidth_bytes_per_us == cal.bandwidth_bytes_per_us
    assert len(loaded.rows) == 3
    jcal = j_calibrate(cases, reps=1, persist=False)
    assert [(r.shape, r.block, r.model_bytes) for r in cal.rows] == [
        (r.shape, r.block, r.model_bytes) for r in jcal.rows]


def test_blocked_bytes_count_the_padding_copies():
    # 10 is not a multiple of 4: X and both other factors are padded
    got = blocked_mttkrp_bytes((10, 8, 8), 2, 0, 4)
    xp, x = 12 * 8 * 8 * 4, 10 * 8 * 8 * 4
    assert got == xp + x + xp + 2 * 8 * 2 * 4 + 12 * 2 * 4
    assert blocked_mttkrp_bytes((8, 8, 8), 2, 0, 4) == 8 ** 3 * 4 + 2 * 8 * 2 * 4 + 8 * 2 * 4


def test_jax_is_untouched_by_the_port_cache(caches):
    x, fs = _tp()
    search.tune_mttkrp(x, fs, 0, reps=1, warmup=0)
    assert len(jcache.default_cache()) == 0
    assert jax.default_backend() == "cpu"


def test_tune_cache_consulted_once_a_batched_call(caches):
    """The port of the reference's amortization test
    (``tests/test_batched.py``): a batched call resolves once, on the
    element's key, where a loop resolves once an element; a tuned entry for
    that key is one hit for the whole batch."""
    batch, dims, rank = 4, (6, 5, 4), 3
    rng = np.random.default_rng(10)
    x = _t(rng.standard_normal((batch, *dims), dtype=np.float32))
    fs = [_t(rng.standard_normal((batch, d, rank), dtype=np.float32)) for d in dims]
    ctx = _ctx()
    before = registry().snapshot()
    repro_torch.mttkrp(x, fs, 0, ctx=ctx)
    assert _cache_counts(before) == {"hit": 0, "miss": 1}
    for b in range(batch):
        repro_torch.mttkrp(x[b], [f[b] for f in fs], 0, ctx=ctx)
    assert _cache_counts(before) == {"hit": 0, "miss": 1 + batch}
    key = tcache.cache_key(dims, rank, 0, x.dtype, Memory.h100_smem(), device="cpu")
    tcache.default_cache().put(key, tcache.CacheEntry(backend="einsum"), persist=False)
    repro_torch.mttkrp(x, fs, 0, ctx=ctx)
    assert _cache_counts(before) == {"hit": 1, "miss": 1 + batch}
