"""The port's public surface: the context (validation, device rule, JSON),
the conversion bridge, and the import isolation from JAX.

The device rule: an entry point runs on the card unless the caller asks
for the CPU, so a context built without ``device="cpu"`` on a host without
CUDA raises.
"""

import ast
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.tune.cache import plan_to_dict
from repro_torch import convert
from repro_torch.engine.context import ExecutionContext

ROOT = Path(__file__).resolve().parents[1]


def test_public_surface():
    assert sorted(repro_torch.__all__) == sorted(
        ["ExecutionContext", "Memory", "BlockPlan", "mttkrp", "contract_partial", "cp_als",
         "CPResult", "multi_ttm", "MultiTTMPlan", "tucker_hooi", "TuckerResult",
         "cp_gradient", "cp_als_batched", "tucker_hooi_batched", "BatchedCPResult",
         "BatchedTuckerResult", "Trace", "Distribution", "select_grid", "select_tucker_grid"])
    for name in repro_torch.__all__:  # the reference's names for the same things
        assert name in repro.__all__


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert ExecutionContext().device.startswith("cuda")
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExecutionContext()
    with pytest.raises(RuntimeError):
        repro_torch.mttkrp(torch.ones(2, 2, 2), [torch.ones(2, 1)] * 3, 0)
    ctx = ExecutionContext.create("einsum", device="cpu")
    out = repro_torch.mttkrp(torch.ones(2, 3, 4), [torch.ones(d, 1) for d in (2, 3, 4)], 0,
                             ctx=ctx)
    assert out.device.type == "cpu" and torch.equal(out, torch.full((2, 1), 12.0))


def test_tensors_on_another_device_are_refused():
    ctx = ExecutionContext.create("einsum", device="cpu")
    with pytest.raises(ValueError, match="context runs on cpu"):
        repro_torch.mttkrp(torch.ones(2, 2, 2, device="meta"), [torch.ones(2, 1)] * 3, 0,
                           ctx=ctx)


@pytest.mark.parametrize("kw", [
    {"backend": "einsum"},
    {"backend": "blocked_host", "memory": repro_torch.Memory.abstract(4096)},
    {"backend": "cuda", "memory": repro_torch.Memory.h100_smem(), "compute_dtype": "bfloat16",
     "out_dtype": torch.float32},
])
def test_context_json_round_trip(kw):
    ctx = ExecutionContext.create(device="cpu", **kw)
    again = ExecutionContext.from_json(ctx.to_json())
    assert again == ctx
    assert ctx.to_dict()["schema"] == "repro_torch.ExecutionContext/1"
    with pytest.raises(ValueError, match="schema"):
        ExecutionContext.from_dict({**ctx.to_dict(), "schema": "repro.ExecutionContext/1"})


@pytest.mark.parametrize("kw,match", [
    ({"backend": "auto", "tune": True, "compilation_cache": 3}, "directory path"),
    ({"backend": "pallas"}, "backend='cuda'"),
    ({"backend": "fast"}, "unknown backend"),
    ({"tune": True}, "requires backend='auto'"),
    # distributed=True and observe=True are accepted since their slices (match None)
    pytest.param({"distributed": True}, None, id="kw4-distributed drivers"),
    pytest.param({"observe": True}, None, id="kw5-observability slice"),
    ({"compute_dtype": "int32"}, "float dtype"),
    ({"out_dtype": "float99"}, "not a torch dtype"),
    ({"device": "meta"}, "'cuda' or 'cpu'"),
])
def test_context_rejects_eagerly(kw, match):
    if match is None:
        ctx = ExecutionContext.create(**{"device": "cpu", **kw})
        assert ctx.observe == kw.get("observe", False)
        assert ctx.is_distributed == kw.get("distributed", False)
        assert ctx != ExecutionContext.create(device="cpu")
        return
    with pytest.raises(ValueError, match=match):
        ExecutionContext.create(**{"device": "cpu", **kw})


def test_context_memory_is_the_reference_memory():
    jctx = repro.ExecutionContext.create(memory=repro.Memory.tpu_vmem(itemsize=2))
    mem = convert.memory_from_dict(jctx.to_dict()["memory"])
    assert mem == repro_torch.Memory.tpu_vmem(itemsize=2)


def test_convert_carries_plans_factors_and_results():
    jplan = repro.BlockPlan(16, (8, 64), 32)
    assert convert.block_plan_from_dict(plan_to_dict(jplan)) == repro_torch.BlockPlan(
        16, (8, 64), 32)
    with pytest.raises(ValueError, match="multi_ttm_plan_from_dict"):
        convert.block_plan_from_dict(plan_to_dict(repro.MultiTTMPlan(8, (8,), (2,))))
    assert convert.multi_ttm_plan_from_dict(plan_to_dict(repro.MultiTTMPlan(8, (8,), (2,)))) \
        == repro_torch.MultiTTMPlan(8, (8,), (2,))
    with pytest.raises(ValueError, match="block_plan_from_dict"):
        convert.multi_ttm_plan_from_dict(plan_to_dict(jplan))
    rng = np.random.default_rng(0)
    fs = [rng.standard_normal((d, 3), dtype=np.float32) for d in (4, 5)]
    got = convert.factors_from_numpy(fs, "cpu", torch.float64)
    assert all(g.dtype == torch.float64 and np.array_equal(g.numpy(), f) for g, f in zip(got, fs))
    x = convert.tensor_from_numpy(np.asarray(jnp.ones((2, 3))), "cpu")
    assert x.dtype == torch.float32 and x.shape == (2, 3)
    res = convert.cp_result_from_numpy(fs, np.ones(3, np.float32), [0.5, np.float32(0.75)],
                                       device="cpu")
    assert res.fits == [0.5, 0.75] and res.final_fit == 0.75
    assert res.reconstruct().shape == (4, 5)


_PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_importing_the_port_loads_no_jax():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    code = ("import sys, repro_torch, repro_torch.convert, repro_torch.kernels.ops,"
            " repro_torch.models, repro_torch.configs, repro_torch.kernels.ssd_intra;"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')];"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("itemsize,want_ms", [(2, 0.10830), (4, 0.20846)])
def test_ssd_bound_counts_the_tensor_cores(itemsize, want_ms):
    """At the served shape the SSD kernel's products run on the tensor
    cores (the Gram 3xTF32; W X two bf16 products for bf16 X, 3xTF32 for
    fp32), so both mixes are bound by their bytes: 0.363 / 0.698 GB at
    3.35 TB/s. Counted on the fp32 CUDA cores instead, the operations
    took 0.330 ms."""
    cs = _chip_smoke()
    bcn, q, n, h, p = (cs.SSD_SHAPE[k] for k in ("bcn", "q", "n", "h", "p"))
    ms, by = cs.ssd_bound(bcn, q, n, h, p, itemsize)
    assert by == "bytes" and ms == pytest.approx(want_ms, abs=5e-5)
    causal = bcn * q * (q + 1) / 2
    ops_ms = 1e3 * (3 * 2 * causal * n / 495e12 + {2: 2 / 989e12, 4: 3 / 495e12}[itemsize]
                    * 2 * causal * h * p)
    assert ops_ms == pytest.approx({2: 0.04687, 4: 0.13397}[itemsize], abs=5e-5)
    assert ops_ms < ms
    fp32_cores_ms = 1e3 * 2 * causal * (n + h * p) / cs.H100.peak_flops["float32"]
    assert fp32_cores_ms == pytest.approx(0.330, abs=1e-3)

