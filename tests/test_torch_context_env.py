"""The context's seeding surface against the reference, on the CPU:
``ExecutionContext.save``/``load``/``from_env``/``default``, seeded from
the port's own ``REPRO_TORCH_CONTEXT``; every driver called without
``ctx`` running under ``default()``; ``ProblemSpec.is_multi_ttm``; and
``engine.plan.mttkrp_traffic_model``.

Inputs are made with numpy from a seed. A bare driver call under a seeded
CPU context must equal the same call with that context passed explicitly
(bit for bit: one process, one code path), and the reference's bare call
under ``REPRO_CONTEXT`` within 1e-5 (``_torch_parity.close``).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.engine import plan as jplan
from repro_torch import convert
from repro_torch.engine import plan as tplan
from repro_torch.engine.context import ENV_CONTEXT, ExecutionContext, ProblemSpec
from repro_torch.engine.batch import cp_als_batched, tucker_hooi_batched
from repro_torch.engine.sweep import fused_als_sweep
from repro_torch.engine.tree import all_mode_mttkrp, dimtree_als_sweep
from repro_torch.launch.serve import DecompositionServer
from repro_torch.observe import Trace

from _torch_parity import close, data, problem

DIMS, RANK = (9, 8, 7), 3


def _cpu(backend="einsum", **kw):
    return ExecutionContext.create(backend, device="cpu", **kw)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# save / load / from_env / default
# ---------------------------------------------------------------------------

def test_save_and_load_round_trip(tmp_path):
    ctx = _cpu("auto", memory=tplan.Memory.h100_smem(itemsize=2), compute_dtype="bfloat16",
               observe=True).resolve_for(DIMS, RANK)
    path = tmp_path / "ctx.json"
    ctx.save(str(path))
    assert ExecutionContext.load(str(path)) == ctx
    assert json.loads(path.read_text())["schema"] == "repro_torch.ExecutionContext/1"


@pytest.mark.parametrize("form", ["path", "inline"])
def test_from_env_reads_a_path_or_the_json_itself(tmp_path, monkeypatch, form):
    ctx = _cpu("blocked_host", memory=tplan.Memory.abstract(4096), observe=True)
    raw = ctx.to_json()
    if form == "path":
        raw = str(tmp_path / "seed.json")
        ctx.save(raw)
    monkeypatch.setenv(ENV_CONTEXT, raw)
    assert ExecutionContext.from_env() == ctx
    assert ExecutionContext.default() == ctx
    monkeypatch.delenv(ENV_CONTEXT)
    assert ExecutionContext.from_env() is None


def test_default_follows_the_variable_and_memoizes_its_value(monkeypatch):
    a, b = _cpu("einsum"), _cpu("blocked_host")
    monkeypatch.setenv(ENV_CONTEXT, a.to_json())
    first = ExecutionContext.default()
    assert first == a and ExecutionContext.default() is first  # memoized on the raw value
    monkeypatch.setenv(ENV_CONTEXT, b.to_json())
    assert ExecutionContext.default() == b
    monkeypatch.setenv(ENV_CONTEXT, a.to_json())
    assert ExecutionContext.default() == a and ExecutionContext.default() is not first
    monkeypatch.delenv(ENV_CONTEXT)
    if torch.cuda.is_available():
        assert ExecutionContext.default() == ExecutionContext()
    else:  # unset: ExecutionContext(), the card, which this host lacks
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ExecutionContext.default()


def test_the_port_reads_its_own_variable(monkeypatch):
    """The reference's ``REPRO_CONTEXT`` names ``backend="pallas"``; the
    port never reads it, and refuses a reference context in its own."""
    jctx = repro.ExecutionContext.create(backend="pallas")
    monkeypatch.setenv("REPRO_CONTEXT", jctx.to_json())
    monkeypatch.setenv(ENV_CONTEXT, _cpu("einsum").to_json())
    assert ExecutionContext.default() == _cpu("einsum")
    assert repro.ExecutionContext.default() == jctx
    monkeypatch.setenv(ENV_CONTEXT, jctx.to_json())
    with pytest.raises(ValueError, match="schema"):
        ExecutionContext.default()


# ---------------------------------------------------------------------------
# every driver without ctx runs under default()
# ---------------------------------------------------------------------------

def _drivers():
    x, fs = data(DIMS, RANK, 3)
    xb, _ = data((2,) + DIMS, RANK, 4)
    x, fs, xb = _t(x), [_t(f) for f in fs], _t(xb)
    mats = [f[:, :2] for f in fs]

    def sweep_with(fn):
        def run(ctx):
            out = []
            factors = list(fs)
            fn(x, factors, lambda m, b: out.append(b) or factors[m],
               **({} if ctx is None else {"ctx": ctx}))
            return out
        return run

    def serve(ctx):
        srv = DecompositionServer(ctx, n_iters=2) if ctx is not None else \
            DecompositionServer(n_iters=2)
        srv.submit(x, RANK, request_id="a", init_factors=fs)
        return [srv.flush()["a"].factors[0]]

    def kw(ctx):
        return {} if ctx is None else {"ctx": ctx}

    return {
        "mttkrp": lambda c: [repro_torch.mttkrp(x, fs, 1, **kw(c))],
        "contract_partial": lambda c: [repro_torch.contract_partial(
            x, fs, (0, 1, 2), (1, 2), False, **kw(c))],
        "multi_ttm": lambda c: [repro_torch.multi_ttm(x, mats, 0, **kw(c))],
        "all_mode_mttkrp": lambda c: all_mode_mttkrp(x, fs, **kw(c)),
        "dimtree_als_sweep": sweep_with(dimtree_als_sweep),
        "fused_als_sweep": sweep_with(fused_als_sweep),
        "cp_als_batched": lambda c: [cp_als_batched(xb, RANK, 2, **kw(c)).fits],
        "tucker_hooi_batched": lambda c: [tucker_hooi_batched(xb, (2, 2, 2), 1, **kw(c)).core],
        "cp_als": lambda c: [torch.tensor(repro_torch.cp_als(x, RANK, 2, init_factors=fs,
                                                             **kw(c)).fits)],
        "cp_gradient": lambda c: [repro_torch.cp_gradient(x, RANK, 3, init_factors=fs,
                                                          **kw(c)).factors[0]],
        "tucker_hooi": lambda c: [repro_torch.tucker_hooi(x, (2, 2, 2), 1, **kw(c)).core],
        "DecompositionServer": serve,
    }


DRIVERS = sorted(_drivers())


@pytest.mark.parametrize("name", DRIVERS)
@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_a_bare_driver_runs_under_the_seeded_context(monkeypatch, name, backend):
    """A seeded CPU context runs every driver called without ``ctx`` on the
    host, exactly as the same context passed explicitly."""
    ctx = _cpu(backend)
    monkeypatch.setenv(ENV_CONTEXT, ctx.to_json())
    run = _drivers()[name]
    for got, want in zip(run(None), run(ctx)):
        assert got.device.type == "cpu"
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("name", DRIVERS)
def test_a_bare_driver_without_a_seed_runs_on_the_card(monkeypatch, name):
    """With the variable unset the default stays ``ExecutionContext()``,
    the card: on a host without CUDA every bare driver call raises."""
    monkeypatch.delenv(ENV_CONTEXT, raising=False)
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the bare call would run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _drivers()[name](None)


def test_a_seeded_cp_als_matches_the_reference_seeded(monkeypatch):
    """``REPRO_TORCH_CONTEXT`` seeds a bare ``repro_torch.cp_als`` onto the
    CPU as ``REPRO_CONTEXT`` seeds a bare ``repro.cp_als``."""
    x, init = problem(DIMS, RANK, 5)
    monkeypatch.setenv(ENV_CONTEXT, _cpu("einsum").to_json())
    monkeypatch.setenv("REPRO_CONTEXT", repro.ExecutionContext.create(backend="einsum")
                       .to_json())
    port = repro_torch.cp_als(_t(x), RANK, 3, init_factors=[_t(f) for f in init])
    ref = repro.cp_als(jnp.asarray(x), RANK, 3, init_factors=[jnp.asarray(f) for f in init])
    np.testing.assert_allclose(port.fits, ref.fits, rtol=0, atol=1e-5)
    for a, b in zip(port.factors, ref.factors):
        close(a, np.asarray(b), tol=1e-4)


def test_a_seeded_observe_reaches_a_bare_call(monkeypatch):
    monkeypatch.setenv(ENV_CONTEXT, _cpu("cuda", observe=True).to_json())
    x, fs = data(DIMS, RANK, 6)
    with Trace(capture="observed") as t:
        repro_torch.mttkrp(_t(x), [_t(f) for f in fs], 0)
    assert [e["kind"] for e in t.events] == ["mttkrp"]
    assert t.events[0]["backend"] == "cuda"


# ---------------------------------------------------------------------------
# ProblemSpec.is_multi_ttm and mttkrp_traffic_model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [4, (2, 3, 4)])
def test_problem_spec_is_multi_ttm_as_the_reference(rank):
    from repro.engine.context import ProblemSpec as JProblemSpec

    assert ProblemSpec(DIMS, rank).is_multi_ttm == JProblemSpec(DIMS, rank).is_multi_ttm \
        == isinstance(rank, tuple)
    assert ProblemSpec.from_dict(ProblemSpec(DIMS, rank).to_dict()).is_multi_ttm \
        == isinstance(rank, tuple)


@pytest.mark.parametrize("shape,rank,itemsize,budget", [
    ((64, 48, 40), 16, 4, 1 << 16),
    ((1000, 1000, 1000), 64, 4, tplan.SMEM_BUDGET),
    ((180, 180, 180, 180), 32, 2, 1 << 20),
    ((33, 17, 9, 5, 3), 7, 4, 4096),
])
def test_mttkrp_traffic_model_equals_the_reference(shape, rank, itemsize, budget):
    mem = tplan.Memory(budget, 8, 8, itemsize)
    jmem = jplan.Memory(budget, 8, 8, itemsize)
    plan = tplan.choose_blocks(shape, rank, itemsize, memory=mem)
    jp = jplan.choose_blocks(shape, rank, itemsize, memory=jmem)
    assert convert.memory_from_dict(
        repro.ExecutionContext.create(memory=jmem).to_dict()["memory"]) == mem
    got = tplan.mttkrp_traffic_model(shape, rank, plan, itemsize)
    assert got == jplan.mttkrp_traffic_model(shape, rank, jp, itemsize)
    assert got == plan.traffic_model(shape, rank, itemsize)
    from repro_torch.engine import mttkrp_traffic_model

    assert mttkrp_traffic_model is tplan.mttkrp_traffic_model


def test_a_tensor_on_another_device_names_a_device_the_context_takes():
    ctx = ExecutionContext.create("einsum", device="cpu")
    with pytest.raises(ValueError) as err:
        ctx.check_tensor("mttkrp", torch.empty((2, 3), device="meta"))
    msg = str(err.value)
    assert "tensor on meta" in msg and "device='meta'" not in msg
    assert "the context takes only device='cuda' or 'cpu'" in msg
    # the device it would otherwise have suggested is one the context refuses
    with pytest.raises(ValueError, match="device must be 'cuda' or 'cpu'"):
        ExecutionContext.create("einsum", device="meta")
