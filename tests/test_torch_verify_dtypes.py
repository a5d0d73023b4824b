"""The dtype-flow analyzer (``repro_torch.verify.dtypes``) against the
reference's.

A ``TorchDispatchMode`` records every accumulating aten op of the six
programs (``mttkrp`` and ``multi_ttm(keep=0)`` under
``compute_dtype="bfloat16"`` on einsum, blocked_host and cuda, the last on
CPU tensors taking the wrappers' plain versions); none consumes a narrow
operand into a narrow result, and no Hopper kernel launches. The
accumulation counts are the port's: one contraction a MTTKRP and two a
Multi-TTM on every backend (the reference's jaxprs count two for each
einsum and blocked_host program and one for each Pallas one). A bf16-in, bf16-out ``mm`` fires
``narrow-accumulator``; on the card each launch must write float32.
"""

import pytest
import torch

from repro.verify.dtypes import verify_dtypes as ref_verify_dtypes
from repro_torch.kernels import mttkrp3 as mttkrp3_mod
from repro_torch.observe.collect import Launch
from repro_torch.verify import dtypes as vd
from repro_torch.verify import kernels as vk

#: The port's accumulations a program (see the module docstring).
ACCUMULATIONS = {"mttkrp": 1, "multi_ttm": 2}


@pytest.fixture(scope="module")
def verified():
    before = vk.wrapper_launches()
    findings, verdicts = vd.verify_dtypes()
    return findings, verdicts, before, vk.wrapper_launches()


def test_the_six_programs_are_clean(verified):
    findings, verdicts, _, _ = verified
    assert findings == []
    assert [v["name"] for v in verdicts] == [
        f"{p}/{b}" for b in ("einsum", "blocked_host", "cuda") for p in ("mttkrp", "multi_ttm")]
    for v in verdicts:
        assert v["agrees"] and v["narrow_accumulations"] == 0 and v["compute_dtype"] == "bfloat16"
        assert v["accumulations"] == ACCUMULATIONS[v["name"].split("/")[0]], v


def test_nothing_launches(verified):
    _, verdicts, before, after = verified
    assert before == after
    assert all(v["kernel_launches"] == 0 for v in verdicts)


def test_the_reference_programs_are_the_ports():
    ref_findings, ref_verdicts = ref_verify_dtypes()
    assert ref_findings == []
    names = [v["name"].replace("/pallas", "/cuda") for v in ref_verdicts]
    port = [v["name"] for v in vd.verify_dtypes()[1]]
    assert sorted(names) == sorted(port)
    keys = {"analyzer", "name", "compute_dtype", "accumulations", "narrow_accumulations",
            "agrees", "findings"}
    assert all(keys <= set(v) for v in vd.verify_dtypes()[1])
    assert all(keys <= set(v) for v in ref_verdicts)


def test_a_bf16_mm_is_a_narrow_accumulator():
    a = torch.ones((4, 4), dtype=torch.bfloat16)
    _, sites = vd.accumulation_sites(lambda p, q: p @ q, a, a)
    assert sites == [{"prim": "mm", "in": ["bfloat16", "bfloat16"], "out": ["bfloat16"]}]
    found = vd.check_accumulation(sites, "fixture")
    assert [f.rule for f in found] == ["narrow-accumulator"] and found[0].analyzer == "dtypes"
    # the policy's spelling: narrow operands, a wide accumulation
    _, sites = vd.accumulation_sites(lambda p, q: p.float() @ q.float(), a, a)
    assert vd.check_accumulation(sites, "fixture") == []


@pytest.mark.parametrize("fn,prim", [
    (lambda a: torch.einsum("ij,jk->ik", a, a), "bmm"),
    (lambda a: torch.tensordot(a, a, dims=([1], [0])), "mm"),
    (lambda a: a.sum(0), "sum"),
    (lambda a: torch.linalg.solve(a + 4 * torch.eye(4), a), "_linalg_solve_ex"),
    (lambda a: torch.addmm(a, a, a), "addmm"),
])
def test_the_recorder_sees_what_einsum_and_tensordot_become(fn, prim):
    a = torch.rand((4, 4))
    _, sites = vd.accumulation_sites(fn, a)
    assert prim in {s["prim"] for s in sites}
    assert all(s["out"] == ["float32"] or "float32" in s["out"] for s in sites)


def test_a_launch_writing_bf16_is_a_narrow_accumulator():
    launches = [Launch("mttkrp3", None, 8, 4, "float32"),
                Launch("multi_ttm_keep", None, 8, 4, "bfloat16"),
                Launch("ssd_intra", None, 8, 4, "bfloat16")]  # writes X's dtype by design
    found = vd.check_launches(launches, "fixture")
    assert [f.rule for f in found] == ["narrow-accumulator"]
    assert "multi_ttm_keep" in found[0].detail


def test_a_launch_during_the_analysis_is_a_finding(monkeypatch):
    real = vd._run_program

    def launching(*a, **kw):
        monkeypatch.setattr(mttkrp3_mod.mttkrp3, "launches", mttkrp3_mod.mttkrp3.launches + 1)
        return real(*a, **kw)

    monkeypatch.setattr(vd, "_run_program", launching)
    findings, _ = vd.verify_dtypes()
    assert [f.rule for f in findings] == ["kernel-executed"]
