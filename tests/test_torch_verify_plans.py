"""The port's plan verifier against the reference's (``repro.verify.plans``)
and its kernel-plan rules, and the ``python -m repro_torch.verify`` CLI.

* ``verify_plans()`` is clean on the port's lattice, as the reference's is
  on its own;
* every plan the planners emit over the lattice equals the reference's
  field by field, under every memory (the port's ``Memory.h100_smem`` is
  handed to the reference as the same descriptor);
* each check, fed the same seeded bad plans in both packages, gives the
  same findings (rule, subject, detail);
* each kernel-plan rule fires on a plan built to break it, and the
  kernel-plan lattice is clean;
* the CLI's exit codes: 0 clean, 1 a finding, 2 bad usage or an analyzer
  that is not ported.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from repro_torch.engine.plan import (
    SMEM_BUDGET,
    SMEM_PER_CTA_MAX,
    BlockPlan,
    Memory,
    MTTKRPKernelPlan,
    MultiTTMKernelPlan,
    MultiTTMPlan,
    PartialKernelPlan,
)
from repro_torch.verify import Finding
from repro_torch.verify import plans as port

MEMORY_IDS = [f"{m.lane}-{m.sublane}-{m.budget_bytes}-{m.itemsize}"
              for m in port.DEFAULT_MEMORIES]


def _ref_memory(m: Memory):
    from repro.engine.plan import Memory as RefMemory

    return RefMemory(m.budget_bytes, m.lane, m.sublane, m.itemsize)


def _triples(findings):
    return [(f.analyzer, f.rule, f.subject, f.detail) for f in findings]


def test_verify_plans_is_clean_as_the_reference_is():
    from repro.verify.plans import verify_plans as ref_verify_plans

    assert port.verify_plans() == []
    assert ref_verify_plans() == []


def test_the_port_lattice_adds_the_h100_memory():
    from repro.verify import plans as ref

    assert port.DEFAULT_MEMORIES[:2] == (Memory.h100_smem(itemsize=4),
                                         Memory.h100_smem(itemsize=2))
    assert [_ref_memory(m) for m in port.DEFAULT_MEMORIES[2:]] == list(ref.DEFAULT_MEMORIES)
    assert port.DEFAULT_SHAPES == ref.DEFAULT_SHAPES and port.DEFAULT_RANKS == ref.DEFAULT_RANKS


@pytest.mark.parametrize("memory", port.DEFAULT_MEMORIES, ids=MEMORY_IDS)
def test_lattice_plans_equal_the_reference(memory):
    from repro.engine import plan as ref

    from repro_torch.engine import plan as mine

    rmem = _ref_memory(memory)
    item = memory.itemsize
    for shape in port.DEFAULT_SHAPES:
        for rank in port.DEFAULT_RANKS:
            for kw in ({}, {"x_has_rank": True}):
                assert dataclasses.asdict(mine.choose_blocks(shape, rank, item, memory=memory,
                                                             **kw)) == \
                    dataclasses.asdict(ref.choose_blocks(shape, rank, item, memory=rmem, **kw))
            assert dataclasses.asdict(mine.choose_sweep_blocks(shape, rank, item,
                                                               memory=memory)) == \
                dataclasses.asdict(ref.choose_sweep_blocks(shape, rank, item, memory=rmem))
        assert mine.best_uniform_block(shape, memory) == ref.best_uniform_block(shape, rmem)
        tranks = port._tucker_ranks(shape)
        assert dataclasses.asdict(mine.choose_multi_ttm_blocks(shape, tranks, item,
                                                               memory=memory)) == \
            dataclasses.asdict(ref.choose_multi_ttm_blocks(shape, tranks, item, memory=rmem))


def _bad_block_plans(seed: int, ndim: int, n: int = 12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sizes = [int(v) for v in rng.choice([0, 1, 3, 8, 64, 1000, 8192], size=ndim + 1)]
        out.append((sizes[0], tuple(sizes[1:ndim]), sizes[ndim], bool(rng.integers(2))))
    return out


@pytest.mark.parametrize("memory", port.DEFAULT_MEMORIES, ids=MEMORY_IDS)
@pytest.mark.parametrize("shape", [(8192, 8192, 8192), (24, 10, 12), (16, 8, 6, 4)])
def test_block_and_sweep_checks_find_what_the_reference_finds(memory, shape):
    from repro.engine.plan import BlockPlan as RefBlockPlan
    from repro.verify import plans as ref

    rmem = _ref_memory(memory)
    for bi, bc, br, xr in _bad_block_plans(len(shape) * 7 + memory.itemsize, len(shape)):
        for rank in (2, 64, 4096):
            got = port.check_block_plan(BlockPlan(bi, bc, br, xr), shape, rank, memory)
            want = ref.check_block_plan(RefBlockPlan(bi, bc, br, xr), shape, rank, rmem)
            assert _triples(got) == _triples(want)
            if min((bi, br) + bc) >= 1:
                got = port.check_sweep_plan(BlockPlan(bi, bc, br), shape, rank, memory)
                want = ref.check_sweep_plan(RefBlockPlan(bi, bc, br), shape, rank, rmem)
                assert _triples(got) == _triples(want)


@pytest.mark.parametrize("memory", port.DEFAULT_MEMORIES, ids=MEMORY_IDS)
def test_multi_ttm_check_finds_what_the_reference_finds(memory):
    from repro.engine.plan import MultiTTMPlan as RefPlan
    from repro.verify import plans as ref

    rmem = _ref_memory(memory)
    shape, ranks = (8192, 8192, 8192), (64, 64)
    for bi, bc, br, _ in _bad_block_plans(5 + memory.itemsize, 3):
        for tranks in (ranks, (br, 2)):
            got = port.check_multi_ttm_plan(MultiTTMPlan(bi, bc, tranks), shape, tranks, memory)
            want = ref.check_multi_ttm_plan(RefPlan(bi, bc, tranks), shape, tranks, rmem)
            assert _triples(got) == _triples(want)


@pytest.mark.parametrize("memory", port.DEFAULT_MEMORIES + (Memory(1001, 1, 1, 3),),
                         ids=MEMORY_IDS + ["odd"])
def test_itemsize_check_finds_what_the_reference_finds(memory):
    from repro.verify import plans as ref

    assert _triples(port.check_memory_itemsize(memory)) == \
        _triples(ref.check_memory_itemsize(_ref_memory(memory)))


def test_batched_check_finds_what_the_reference_finds():
    """The same known-bad chooser (the rank tile scaled with B) in both."""
    from repro.engine import plan as ref_plan
    from repro.verify import plans as ref

    from repro_torch.engine import plan as mine

    def bad(choose):
        def chooser(b, shape, rank, itemsize, memory=None):
            base = choose(shape, rank, itemsize, memory=memory)
            return base if b == 1 else dataclasses.replace(base, block_r=base.block_r * b)
        return chooser

    mem = port.DEFAULT_MEMORIES[0]
    kw = {"shapes": [(16, 14, 12), (64, 64, 64)], "ranks": [4, 16], "batch_sizes": (1, 2, 4)}
    got = port.check_batched_plans(memories=[mem], chooser=bad(mine.choose_blocks), **kw)
    want = ref.check_batched_plans(memories=[_ref_memory(mem)],
                                   chooser=bad(ref_plan.choose_blocks), **kw)
    assert got and _triples(got) == _triples(want)
    assert port.check_batched_plans() == []


# --------------------------------------------------------------------------
# the kernel plans
# --------------------------------------------------------------------------

def _rules(findings):
    return {f.rule for f in findings}


def test_kernel_plan_lattice_is_clean():
    cases = port.default_kernel_cases()
    assert port.check_kernel_plans() == []
    kernels = {c.kernel for c in cases}
    assert kernels == set(port.KERNELS)
    assert {c.itemsize for c in cases} == {2, 4}
    assert any(len(c.shape) == 2 and c.kernel != "partial" for c in cases)
    assert any(c.batch > 1 for c in cases)


def test_the_lattice_holds_the_port_cells():
    from repro_torch.verify.plans import KernelCase

    cases = set(port.default_kernel_cases())
    for itemsize in (4, 2):
        assert KernelCase("mttkrp", (1000, 1000, 1000), 64, itemsize) in cases
        assert KernelCase("mttkrp", (180, 180, 180, 180), 32, itemsize) in cases
        assert KernelCase("multi_ttm", (1000, 1000, 1000), (32, 32), itemsize) in cases
        assert KernelCase("multi_ttm", (1000, 1000, 1000), (16, 16), itemsize) in cases
        nodes = {(len(c.shape), c.rank) for c in cases if c.kernel == "partial"}
        assert {(2, 64), (3, 32)} <= nodes  # k = 1 at 1000^3, k = 2 at 180^4


MTTKRP = port.KernelCase("mttkrp", (1000, 1000, 1000), 64)


@pytest.mark.parametrize("case,plan,rule", [
    (MTTKRP, MTTKRPKernelPlan(96, 16, 64, 2), "kernel-plan-refused"),
    (MTTKRP, MTTKRPKernelPlan(128, 64, 128, 4), "kernel-smem-over-cta"),
    (MTTKRP, MTTKRPKernelPlan(128, 64, 64, 4), "kernel-smem-over-budget"),
    (port.KernelCase("multi_ttm", (1000, 1000, 1000), (32, 32)),
     MultiTTMKernelPlan(192, 64, 128, 4), "kernel-smem-over-cta"),
    (port.KernelCase("partial", (1000, 1000), 64, 4, 1, (64000, 64)),
     PartialKernelPlan("rows", 256, 4, 8, 1), "kernel-plan-refused"),
    (port.KernelCase("partial", (1000, 1000), 64, 4, 1, (64000, 64)),
     PartialKernelPlan("contract", 8, 4, 8, 70000), "kernel-plan-refused"),
    (port.KernelCase("mttkrp", (256, 256, 256), 32, 4, 70000), MTTKRPKernelPlan(128, 64, 32, 2),
     "kernel-grid-limit"),
])
def test_kernel_rule_fires_on_a_plan_built_to_break_it(case, plan, rule):
    assert rule in _rules(port.check_kernel_plan(case, plan))


def test_over_budget_is_not_charged_when_no_plan_fits_the_budget():
    """At ranks (16, 16, 128) in fp32 even the smallest Multi-TTM plan's
    output tile overflows the two-CTA budget: a property of the problem,
    not a finding; the chooser then plans against one CTA's limit."""
    case = port.KernelCase("multi_ttm", (180, 180, 180, 180), (16, 16, 128))
    plan = MultiTTMKernelPlan(64, 8, 128, 2)
    smem = port.kernel_smem_bytes(case, plan)
    assert SMEM_BUDGET < smem <= SMEM_PER_CTA_MAX
    assert port.check_kernel_plan(case, plan) == []
    assert port.check_kernel_plans([case]) == []


@pytest.mark.parametrize("change,rule", [
    ({"grid": (7, 1, 33)}, "kernel-grid-cover"),    # 7 x 128 rows < 1000
    ({"grid": (9, 1, 33)}, "kernel-grid-cover"),    # a whole tile of slack
    ({"grid": (8, 2, 33)}, "kernel-grid-cover"),    # two rank tiles for R = 64
    ({"splits": 0}, "kernel-splits"),
    ({"splits": 16001}, "kernel-splits"),           # more splits than chunks
    ({"launch": (8, 70000, 1)}, "kernel-grid-limit"),
])
def test_launch_rule_fires_on_a_grid_built_to_break_it(change, rule):
    plan = port.choose_kernel_plan(MTTKRP)
    launch = {**port.kernel_launch(MTTKRP, plan), **change}
    assert _rules(port.check_kernel_plan(MTTKRP, plan, launch)) == {rule}


def test_a_chooser_that_raises_is_a_finding():
    case = port.KernelCase("multi_ttm", (1000, 1000, 1000, 1000), (128, 128, 128))
    (finding,) = port.check_kernel_plans([case])
    assert finding.rule == "kernel-no-plan" and finding.analyzer == "plans"


def test_finding_matches_the_reference_finding():
    from repro.verify import Finding as RefFinding

    args = ("plans", "eq9-infeasible", "BlockPlan[...]", "too big")
    assert Finding(*args).to_dict() == RefFinding(*args).to_dict()
    assert str(Finding(*args)) == str(RefFinding(*args))


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def default_run(tmp_path_factory):
    """``python -m repro_torch.verify --trace-out FILE``: its exit code,
    output and trace, run once for the module."""
    import contextlib
    import io

    from repro_torch.verify.__main__ import main

    path = str(tmp_path_factory.mktemp("verify") / "v.jsonl")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--trace-out", path])
    return rc, out.getvalue(), path


def test_cli_exits_0_on_the_clean_tree(default_run):
    rc, out, _ = default_run
    assert rc == 0
    assert "verify: 0 finding(s) across plans, kernels, lint, comm, dtypes" in out
    assert "not ported" not in out


@pytest.fixture
def ran(monkeypatch):
    """Every analyzer replaced by a recorder of its name (the CLI imports
    each at call time), each clean."""
    from repro_torch.verify import comm, dtypes, kernels, lint, plans

    seen: list[str] = []

    def clean(name, pair=True):
        def fn(*a, **k):
            seen.append(name)
            return ([], []) if pair else []
        return fn

    monkeypatch.setattr(plans, "verify_plans", clean("plans", pair=False))
    monkeypatch.setattr(plans, "kernel_plan_verdicts", lambda *a, **k: ([], []))
    monkeypatch.setattr(kernels, "verify_kernels", clean("kernels"))
    monkeypatch.setattr(lint, "lint_tree", clean("lint", pair=False))
    monkeypatch.setattr(comm, "verify_comm", clean("comm"))
    monkeypatch.setattr(dtypes, "verify_dtypes", clean("dtypes"))
    return seen


@pytest.mark.parametrize("argv,want", [
    (["--only", "kernels"], ["kernels"]),
    (["--only", "plans,lint"], ["plans", "lint"]),
    (["--comm"], ["comm"]),
    (["--dtypes"], ["dtypes"]),
    (["--only", "lint", "--comm"], ["lint", "comm"]),
    (["--comm", "--dtypes"], ["comm", "dtypes"]),
    (["--only", "kernels,plans", "--dtypes", "--comm"], ["plans", "kernels", "comm", "dtypes"]),
    ([], ["plans", "kernels", "lint", "comm", "dtypes"]),
])
def test_cli_runs_just_the_analyzers_it_selects(argv, want, ran, capsys):
    from repro_torch.verify.__main__ import main

    assert main(argv) == 0
    assert ran == want  # in the reference's order, each once
    assert "verify: 0 finding(s)" in capsys.readouterr().out


def test_cli_rules_prints_the_lint_catalog(capsys):
    from repro_torch.verify.__main__ import main
    from repro_torch.verify.lint import RULES

    assert main(["--rules"]) == 0
    out = capsys.readouterr().out
    assert all(r.code in out for r in RULES) and out.startswith("| code |")


def test_cli_refuses_an_unknown_analyzer(capsys):
    from repro_torch.verify.__main__ import main

    assert main(["--only", "bogus"]) == 2
    assert "unknown analyzer" in capsys.readouterr().err


def test_run_reports_every_analyzer(ran):
    from repro_torch.verify.__main__ import ANALYZERS, run

    assert ANALYZERS == ("plans", "kernels", "lint", "comm", "dtypes")
    assert run() == ([], [])
    assert ran == list(ANALYZERS)


def test_cli_exits_1_on_a_finding(monkeypatch, capsys):
    from repro_torch.verify import plans
    from repro_torch.verify.__main__ import main

    bad = Finding("plans", "eq9-infeasible", "BlockPlan[x]", "seeded")
    monkeypatch.setattr(plans, "verify_plans", lambda: [bad])
    assert main(["--only", "plans"]) == 1
    assert "[plans:eq9-infeasible] BlockPlan[x]: seeded" in capsys.readouterr().out


def test_cli_trace_out_is_tabled_by_the_report(default_run, capsys):
    from repro_torch.observe.report import main as report
    from repro_torch.verify.comm import verify_comm
    from repro_torch.verify.dtypes import verify_dtypes
    from repro_torch.verify.kernels import kernel_cases

    _, _, path = default_run
    events = [json.loads(line) for line in open(path)]
    assert all(e["kind"] == "static_verify" for e in events)
    summary = events[-1]
    assert summary["name"] == "summary" and summary["findings"] == 0
    assert summary["analyzers"] == ["plans", "kernels", "lint", "comm", "dtypes"]
    assert "not_ported" not in summary
    assert summary["kernel_plans_checked"] == len(port.default_kernel_cases())
    assert summary["kernel_plans_agreeing"] == summary["kernel_plans_checked"]
    assert summary["kernels_checked"] == summary["kernels_agreeing"] == len(kernel_cases())
    assert summary["comm_points"] == len(verify_comm()[1])
    assert summary["dtype_programs"] == len(verify_dtypes()[1]) == 6
    assert len(events) - 1 == (summary["kernel_plans_checked"] + summary["kernels_checked"]
                               + summary["comm_points"] + summary["dtype_programs"])
    capsys.readouterr()
    assert report([path, "--kinds", "static_verify"]) == 0
    out = capsys.readouterr().out
    assert "| static_verify |" in out
    # the comm points' byte columns: 144 bytes at Alg 3's (8, 8, 8) rank 4 on (2, 2, 2)
    assert "| static_verify | 8x8x8 r=4 g=2x2x2 | - | 36 | 32 | 144 | 1.00 |" in out
