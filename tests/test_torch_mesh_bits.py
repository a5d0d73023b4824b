"""The mesh layer's repairs change no bit where the steps ran before them.

To run at production width, the attention projections (``_proj``, ``_out``)
lay out their flattened products and their gradients
(``sharding.grad_as_input``), ``local_map`` makes each local gradient
contiguous (``sharding._contiguous_grads``), and MoE's ``assign`` and
``dispatch`` work in buffers of fixed shape. On the meshes and configs
that ran before them, none of that may change a value. So each step runs
twice on the same state and batch: once as it is, once with the earlier
formulations (re-stated here) patched in, and every output must be
bit-equal (``torch.equal``):

* unsharded, in this process;
* on a ``(2, 2)`` ``("data", "model")`` mesh of 4 gloo ranks (this file,
  run as a script, is the worker; ``torch.distributed`` over a
  ``FileStore`` in a temporary directory).

Each run is one AdamW step of ``jit_train_step`` (its loss, parameters
and both moments, which carry the gradient) and 2 decode steps of
``jit_serve_step`` (logits and caches), on smoke configs in fp32: a dense
model, the hybrid (attention, SSM and MoE layers) and the
encoder-decoder model.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
NAMES = ("qwen2-1.5b", "jamba-v0.1-52b", "whisper-tiny")
WORLD = 4
TIMEOUT = 300
B, S = 4, 16
DECODE_STEPS = 2
LR = 1e-4


# --------------------------------------------------------------------------
# The earlier formulations
# --------------------------------------------------------------------------

def _old_proj(x, w, spec=None, sh=None):
    """``_proj`` as it was: one matmul, unflattened."""
    from repro_torch.models.layers import matmul

    d, h, k = w.shape
    return matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def _old_out(out, wo, cfg, sh):
    """``_out`` as it was: no layout of either flattened operand. Under
    ``head_tp`` the weight gathered over fsdp and the output's gradient
    summed, as ``_out`` has done since: that sum changes the order of a
    sum, the layouts it came with change no bit."""
    from repro_torch.models.attention import _wo_spec
    from repro_torch.models.layers import matmul
    from repro_torch.models.sharding import grad_as_input

    head_tp = _wo_spec(sh, cfg)[0] == "tp"
    wo = sh.constrain(wo, *_wo_spec(sh, cfg)).reshape(-1, wo.shape[-1])
    if head_tp:
        wo = sh.constrain(wo, "tp", None)
    y = sh.constrain(matmul(out.flatten(-2), wo), "dp", None, None)
    return grad_as_input(y, summed=True) if head_tp else y


def _old_assign(ids, e: int, cap: int):
    """``assign`` as it was, on a ``bincount``."""
    import torch

    flat = ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(flat.numel(), device=flat.device) - starts[flat[order]]
    pos = pos.reshape(ids.shape)
    return pos, pos < cap


def _old_dispatch(xf, ids, pos, keep, e: int, cap: int):
    """``dispatch`` as it was, scattering the kept choices by a mask."""
    import torch

    t, d = xf.shape
    k = ids.shape[1]
    slots = (ids * cap + pos)[keep]
    tokens = torch.arange(t, device=xf.device).repeat_interleave(k).reshape(t, k)[keep]
    xe = torch.zeros((e * cap, d), dtype=xf.dtype, device=xf.device)
    xe[slots] = xf[tokens]
    return xe.reshape(e, cap, d)


def _earlier(calls: dict):
    """The patches that put the earlier formulations in place, each
    counting its calls in ``calls``: (module, name, function) triples."""
    from repro_torch.models import attention, moe, sharding

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return run

    return [(attention, "_proj", counted("_proj", _old_proj)),
            (attention, "_out", counted("_out", _old_out)),
            (sharding, "_contiguous_grads", counted("_contiguous_grads", lambda fn: fn)),
            (moe, "assign", counted("assign", _old_assign)),
            (moe, "dispatch", counted("dispatch", _old_dispatch))]


def _run_twice(cfg, sh, case: dict) -> tuple[dict, dict, dict]:
    """The case's steps as they are and with the earlier formulations:
    both runs' outputs (whole values, by name) and the earlier ones'
    calls."""
    calls: dict = {}
    now = _steps(cfg, sh, case)
    patches = _earlier(calls)
    own = [(m, n, getattr(m, n)) for m, n, _ in patches]
    try:
        for m, n, fn in patches:
            setattr(m, n, fn)
        before = _steps(cfg, sh, case)
    finally:
        for m, n, fn in own:
            setattr(m, n, fn)
    return now, before, calls


def _steps(cfg, sh, case: dict) -> dict:
    """One train step and the decode steps from the case's initial state,
    their outputs as whole plain tensors by name."""
    import torch

    from repro_torch.models import init_decode_state
    from repro_torch.models.sharding import distribute_tree, full
    from repro_torch.training import jit_serve_step, jit_train_step, train_state_specs

    def whole(t):
        return full(t.detach()).clone()

    state = _state(cfg)
    if sh.mesh is not None:
        state = distribute_tree(state, train_state_specs(state, cfg, sh), sh)
    step = jit_train_step(cfg, sh, state, lr_fn=lambda s: torch.tensor(LR) + 0 * s)
    state, metrics = step(state, case["batch"])
    out = {"loss": whole(metrics["loss"])}
    for k, p in state.params.named_parameters():
        out[f"param {k}"] = whole(p)
    for which in ("m", "v"):
        for k, t in getattr(state.opt, which).items():
            out[f"{which} {k}"] = whole(t)
    params = _state(cfg).params
    dstate = init_decode_state(params, cfg, B, DECODE_STEPS)
    serve = jit_serve_step(cfg, sh, params, dstate)
    for i in range(DECODE_STEPS):
        logits, dstate = serve(params, dstate, case["tokens"][:, i:i + 1])
        out[f"logits {i}"] = whole(logits)
    leaves = []
    torch.utils._pytree.tree_map(lambda t: leaves.append(t) if isinstance(t, torch.Tensor)
                                 else None, dstate)
    for j, t in enumerate(leaves):
        out[f"cache {j}"] = whole(t)
    return out


def _state(cfg):
    import torch

    from repro_torch.training import init_train_state

    return init_train_state(cfg, generator=torch.Generator().manual_seed(5), device="cpu")


def _case(name: str) -> tuple:
    """The smoke config in fp32, a batch and the decode tokens."""
    from dataclasses import replace

    import torch

    from repro_torch.configs import get_smoke

    cfg = replace(get_smoke(name), dtype="float32")
    rng = np.random.default_rng(6)
    batch = {}
    if cfg.frontend != "none":
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.is_encdec:
        batch["dec_tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch["dec_labels" if cfg.is_encdec else "labels"] = rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, DECODE_STEPS)).astype(np.int32)
    return cfg, {"batch": {k: torch.from_numpy(v) for k, v in batch.items()},
                 "tokens": torch.from_numpy(tokens)}


def _unequal(now: dict, before: dict) -> list[str]:
    import torch

    assert list(now) == list(before)
    return [k for k in now if not torch.equal(now[k], before[k])]


# --------------------------------------------------------------------------
# The worker: one rank of the gloo group
# --------------------------------------------------------------------------

def worker(rank: int, world: int, store: str, tmp: str) -> None:
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.sharding import make_policy

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    result = {}
    for name in NAMES:
        cfg, case = _case(name)
        now, before, calls = _run_twice(cfg, make_policy(cfg, mesh), case)
        result[name] = {"tensors": len(now), "unequal": _unequal(now, before), "calls": calls}
    if rank == 0:
        torch.save(result, os.path.join(tmp, "out.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    import torch

    tmp = str(tmp_path_factory.mktemp("mesh_bits"))
    env = {**os.environ, "PYTHONPATH": SRC, "GLOO_SOCKET_IFNAME": os.environ.get(
        "GLOO_SOCKET_IFNAME", "lo"), "OMP_NUM_THREADS": "1"}
    store = os.path.join(tmp, "store")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "worker", str(r),
                               str(WORLD), store, tmp],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(i, p.returncode, o) for i, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    assert not bad, "\n".join(f"rank {i} rc={rc}:\n{o[-4000:]}" for i, rc, o in bad)
    return torch.load(os.path.join(tmp, "out.pt"), weights_only=False)


def _check(got: dict, name: str) -> None:
    assert not got["unequal"], f"{name}: {len(got['unequal'])} of {got['tensors']} differ: " \
                               f"{got['unequal'][:10]}"
    assert got["tensors"] > 0
    # the earlier formulations did run: the projections, the local maps and,
    # in a model with MoE layers, the router's assignment and dispatch
    assert got["calls"]["_proj"] > 0 and got["calls"]["_out"] > 0
    if name == "jamba-v0.1-52b":
        assert got["calls"]["assign"] > 0 and got["calls"]["dispatch"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_unsharded_steps_are_the_earlier_bits(name):
    from repro_torch.models.sharding import NULL

    cfg, case = _case(name)
    now, before, calls = _run_twice(cfg, NULL, case)
    _check({"tensors": len(now), "unequal": _unequal(now, before), "calls": calls}, name)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_steps_on_a_2x2_mesh_are_the_earlier_bits(mesh_run, name):
    got = mesh_run[name]
    _check(got, name)
    assert got["calls"]["_contiguous_grads"] > 0


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
