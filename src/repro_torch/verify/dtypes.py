"""Dtype-flow analyzer: prove the mixed-precision policy on every backend.
Counterpart of ``repro.verify.dtypes``.

The ``compute_dtype`` policy (``engine/execute.py:_cast_compute``)
promises: operands may stream in a narrow type (bf16), but every
accumulation stays fp32. The reference proves it on jaxprs, where nothing
executes. The port has no abstract tracer, and the context takes no
``meta`` device, so its recorder watches the aten ops of a run instead: a
``TorchDispatchMode`` that records every accumulating op (``mm``,
``bmm``, ``addmm``, ``baddbmm``, ``dot``, ``mv``, ``sum``, the
``linalg`` solves; ``einsum`` and ``tensordot`` arrive as these) with its
input and output dtypes. Any such op that consumes a narrow operand must
produce a wide result (``narrow-accumulator``).

The programs are the reference's: ``mttkrp`` and ``multi_ttm(keep=0)``
through :mod:`repro_torch.engine.execute` under
``compute_dtype="bfloat16"`` at ``(8, 8, 8)``, rank 4, ranks ``(4, 3,
2)``, on ``einsum`` and ``blocked_host``, and the same two on
``backend="cuda"``. On CPU tensors the ``cuda`` backend's wrappers take
their plain versions, which compute what the kernels do; so on the CPU the
analyzer's "nothing executes" is "no Hopper kernel launches"
(``kernel-executed``). On the card (``verify_dtypes(device="cuda")``) the
kernels launch: a ``ctypes`` launch passes no dispatcher, so the recorder
reads the launches the wrappers report to :mod:`repro_torch.observe.collect`
and requires each to write a float32 buffer.
"""

from __future__ import annotations

from typing import Any

from . import Finding

#: Narrow compute dtypes: accumulating in these loses mantissa on every
#: partial-sum step.
NARROW_DTYPES = frozenset({"bfloat16", "float16"})

#: Wide accumulator dtypes the policy requires.
WIDE_DTYPES = frozenset({"float32", "float64"})

#: Aten ops that accumulate: contractions, sum-reductions and the solves.
ACCUMULATING_OPS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "dot", "vdot", "mv", "addmv", "sum",
    "linalg_solve", "linalg_solve_ex", "_linalg_solve_ex", "linalg_lstsq",
})


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _recorder(sites: list[dict]):
    """A dispatch mode appending each accumulating op to ``sites``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    def dtypes(tree) -> list[str]:
        return [_dtype_name(t.dtype) for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]

    class AccumulationRecorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in ACCUMULATING_OPS:
                sites.append({"prim": name, "in": dtypes((args, kwargs)), "out": dtypes(out)})
            return out

    return AccumulationRecorder()


def accumulation_sites(fn, *args) -> tuple[Any, list[dict]]:
    """Run ``fn(*args)`` and return its result and every accumulating aten
    op it dispatched, as ``{"prim", "in": [dtypes], "out": [dtypes]}``."""
    sites: list[dict] = []
    with _recorder(sites):
        out = fn(*args)
    return out, sites


def check_accumulation(sites: list[dict], subject: str) -> list[Finding]:
    """The rule: a narrow-input accumulation must have a wide output."""
    findings: list[Finding] = []
    for s in sites:
        if any(d in NARROW_DTYPES for d in s["in"]) and any(
            d in NARROW_DTYPES for d in s["out"]
        ):
            findings.append(Finding(
                "dtypes", "narrow-accumulator", subject,
                f"{s['prim']} consumes {s['in']} and accumulates into "
                f"{s['out']}: the compute_dtype policy requires fp32 "
                f"accumulation",
            ))
    return findings


def check_launches(launches, subject: str) -> list[Finding]:
    """The rule on the card: every Hopper kernel launch but ``ssd_intra``'s
    writes a float32 buffer (the wrappers report it to
    :mod:`repro_torch.observe.collect`)."""
    return [Finding(
        "dtypes", "narrow-accumulator", subject,
        f"kernel {la.name} writes a {la.written_dtype} buffer: the kernels accumulate "
        f"into float32",
    ) for la in launches if la.name != "ssd_intra" and la.written_dtype not in WIDE_DTYPES]


def _run_program(name: str, fn, args: tuple) -> tuple[list[Finding], dict]:
    from ..observe import collect

    with collect.collecting() as launches:
        _, sites = accumulation_sites(fn, *args)
    findings = check_accumulation(sites, name)
    on_card = any(getattr(a, "is_cuda", False) for a in args[:1])
    if on_card:
        findings += check_launches(launches, name)
    verdict = {
        "analyzer": "dtypes", "name": name,
        "compute_dtype": "bfloat16",
        "accumulations": len(sites),
        "narrow_accumulations": len(findings),
        "kernel_launches": len(launches) if on_card else 0,
        "kernel_written_dtypes": sorted({la.written_dtype for la in launches}) if on_card else [],
        "agrees": not findings, "findings": len(findings),
    }
    return findings, verdict


def verify_dtypes(device: str = "cpu") -> tuple[list[Finding], list[dict]]:
    """Run MTTKRP and Multi-TTM under ``compute_dtype=bfloat16`` on every
    backend (einsum, blocked_host, cuda) on ``device`` and prove fp32
    accumulation throughout. On the CPU no Hopper kernel may launch
    (``kernel-executed``); on ``"cuda"`` the kernels launch and each must
    write float32."""
    import numpy as np
    import torch

    from ..engine.context import ExecutionContext
    from ..engine.execute import mttkrp, multi_ttm
    from .kernels import kernel_executed, wrapper_launches

    before = wrapper_launches()
    dims, rank, ranks = (8, 8, 8), 4, (4, 3, 2)
    rng = np.random.default_rng(0)

    def tensor(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)

    x = tensor(*dims)
    facs = [tensor(d, rank) for d in dims]
    mats = [tensor(d, r) for d, r in zip(dims, ranks)]

    findings: list[Finding] = []
    verdicts: list[dict] = []
    for backend in ("einsum", "blocked_host", "cuda"):
        ctx = ExecutionContext.create(backend, device=device, compute_dtype="bfloat16")
        for name, fn, args in (
            (f"mttkrp/{backend}", lambda x, fs, c=ctx: mttkrp(x, fs, 0, ctx=c), (x, facs)),
            (f"multi_ttm/{backend}", lambda x, ms, c=ctx: multi_ttm(x, ms, keep=0, ctx=c),
             (x, mats)),
        ):
            f, v = _run_program(name, fn, args)
            findings += f
            verdicts.append(v)
    if device == "cpu":
        findings += kernel_executed("dtypes", before, "verify_dtypes")
    return findings, verdicts
