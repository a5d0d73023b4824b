"""Where the sharded path's activations and gradients are laid out: Mamba2's
causal conv on each rank's own channels, the norm's backward handed its
gradient in the norm's layout, and the attention output projection's
gradient under ``head_tp``, on gloo meshes of host tensors, against the
port's unsharded path:

* **the steps** (``jit_train_step`` against ``build_train_step``, and a
  sharded ``forward`` prefill against the unsharded one) for the smoke
  configs of ``mamba2-2.7b`` and ``jamba-v0.1-52b`` (whose SSM layers run
  ``ssm._conv_gates``) and of ``nemotron-4-340b`` under ``head_tp``: the
  loss, every gradient and the prefill's logits within 1e-5 relative;
  through a router, the smallest router margin over the run asserted at
  or above 1e-4 first, as ``tests/_torch_mesh.py`` does;
* **the earlier bits**: on a ``(1, 1)`` mesh each of those steps is
  bit-equal (``torch.equal``) to the same step with the earlier
  ``ssm._conv_gates`` (the conv over every channel on each rank's batch
  rows), ``blocks._normed`` (no layout of its gradient) and
  ``attention._out`` (no gathered weight, no summed gradient), re-stated
  here and patched in;
* **the normed input's backward** (``blocks._normed``, rmsnorm and
  layernorm) handed an upstream gradient laid out as a projection's
  backward leaves it (split over dp on the width, pending a sum over tp)
  or as the norm's output is (split over dp on the batch): under
  ``CommDebugMode`` at most one collective from the output's gradient to
  the input's (none where it already arrives so laid out), where the
  earlier formulation ran more than one; the input's gradient within
  1e-5 of the unsharded one, bit-equal on ``(1, 1)``.

Each mesh is one gloo group (``torch.distributed`` over a ``FileStore``;
this file, run as a script, is the worker): ``(1, 1)``, ``(2, 2)`` and
``(2, 4)`` ``("data", "model")`` meshes, all in fp32.
"""

from __future__ import annotations

import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
MESHES = ((1, 1), (2, 2), (2, 4))
TIMEOUT = 300
TOL = 1e-5
MODEL_MARGIN = 1e-4
NAMES = ("mamba2-2.7b", "jamba-v0.1-52b", "nemotron-4-340b")
B, S = 4, 16
NORMS = ("rmsnorm", "layernorm")
#: The upstream gradient's layouts at the normed output: as the MLP's input
#: projection's backward hands it, and as the output is laid out.
UPSTREAM = ("width", "rows")


# --------------------------------------------------------------------------
# The earlier formulations, for the (1, 1) mesh
# --------------------------------------------------------------------------

def _old_conv_gates(p, xin, bmat, cmat, dt, cfg, sh):
    """The conv and gates as they were: the conv over every channel of
    (x, B, C) on each rank's batch rows, x gathered over tp for it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.sharding import local_map
    from repro_torch.models.ssm import _causal_conv

    n = cfg.ssm_state

    def body(xin, bmat, cmat, dt, conv_w, dt_bias, a_log):
        d_inner = xin.shape[-1]
        conv_in = torch.cat([xin, bmat, cmat], dim=-1)
        conv_out = F.silu(_causal_conv(conv_in, conv_w).float()).to(xin.dtype)
        dt = F.softplus(dt + dt_bias)
        a = -torch.exp(a_log)
        return (conv_out[..., :d_inner], conv_out[..., d_inner: d_inner + n],
                conv_out[..., d_inner + n:], dt, dt * a)

    rows, rep = sh.spec("dp", None, None), (None, None)
    return local_map(sh, body, (rows,) * 4 + (rep, (None,), (None,)), (0,) * 5)(
        xin, bmat, cmat, dt, p.conv_w, p.dt_bias, p.A_log)


def _old_normed(norm, x, sh):
    """``_normed`` as it was: no layout of its gradient."""
    from repro_torch.models.layers import apply_norm

    return sh.constrain(apply_norm(norm, x), "dp", None, None)


def _old_out(out, wo, cfg, sh):
    """``_out`` as it was: the weight left as fsdp lays it out, the
    output's gradient as the backward's rules hand it."""
    from repro_torch.models.attention import _act_specs, _wo_spec
    from repro_torch.models.layers import matmul
    from repro_torch.models.sharding import grad_as_input

    q_spec = _act_specs(sh, cfg)[0]
    out = grad_as_input(sh.constrain(out, q_spec[0], None, *q_spec[2:]).flatten(-2))
    wo = grad_as_input(sh.constrain(wo, *_wo_spec(sh, cfg)).reshape(-1, wo.shape[-1]))
    return sh.constrain(matmul(out, wo), "dp", None, None)


def _earlier():
    """(module, name, function) triples that put the earlier formulations
    in place."""
    from repro_torch.models import attention, blocks, ssm

    return [(ssm, "_conv_gates", _old_conv_gates), (blocks, "_normed", _old_normed),
            (attention, "_out", _old_out)]


# --------------------------------------------------------------------------
# The cases
# --------------------------------------------------------------------------

def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    from repro_torch.models.sharding import full

    got, want = full(got).detach().double(), full(want).detach().double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def step_case(mesh, name: str) -> dict:
    """One sharded train step and prefill against the unsharded ones from
    the same seed: the loss's, every gradient's and the logits' largest
    relative error, the policy, the router margins; on (1, 1) whether the
    earlier formulations give the same bits."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.models import blocks, forward, moe
    from repro_torch.models.model import param_specs
    from repro_torch.models.sharding import distribute_tree, full, make_policy
    from repro_torch.training import (
        batch_specs,
        build_train_step,
        init_train_state,
        jit_train_step,
        steps,
    )

    cfg = replace(get_smoke(name), dtype="float32")
    sh = make_policy(cfg, mesh)
    rng = np.random.default_rng(71)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
             for k in ("tokens", "labels")}
    captured, margins = [], []
    own_update, own_moe = steps.adamw_update, blocks.apply_moe

    def watched(params, grads, *args, **kw):
        captured.append({k: full(g).detach().clone() for k, g in grads.items()})
        return own_update(params, grads, *args, **kw)

    def routed(p, x, cfg, *args, **kw):
        t = x.shape[0] * x.shape[1]
        r = moe.route(moe.MoE({k: full(v.detach()) for k, v in p.named_parameters()}),
                      full(x.detach()).reshape(t, -1), cfg.top_k)
        margins.append(float(moe.router_margin(r)))
        return own_moe(p, x, cfg, *args, **kw)

    def state():
        return init_train_state(cfg, generator=torch.Generator().manual_seed(72), device="cpu")

    def sharded():
        s = state()
        _, metrics = jit_train_step(cfg, sh, s)(s, batch)
        params = state().params
        logits, _ = forward(distribute_tree(params, param_specs(params, cfg, sh), sh), cfg,
                            distribute_tree({"tokens": batch["tokens"]}, batch_specs(cfg, sh),
                                            sh), mode="prefill", sh=sh)
        return float(metrics["loss"]), captured.pop(), full(logits).detach().clone()

    steps.adamw_update, blocks.apply_moe = watched, routed
    try:
        _, metrics = build_train_step(cfg)(state(), batch)
        want_loss, want_grads = float(metrics["loss"]), captured.pop()
        want_logits, _ = forward(state().params, cfg, {"tokens": batch["tokens"]},
                                 mode="prefill")
        got = sharded()
        rec = {"attn": sh.attn, "margin": min(margins, default=None),
               "loss": abs(got[0] - want_loss) / abs(want_loss),
               "grads": max(_rel(got[1][k], w) for k, w in want_grads.items()),
               "names": sorted(got[1]) == sorted(want_grads),
               # the vocabulary's words only: the padding's logits are -1e30
               "logits": _rel(got[2][..., :cfg.vocab_size], want_logits[..., :cfg.vocab_size])}
        if mesh.size() == 1:
            patched = _earlier()
            kept = [getattr(m, a) for m, a, _ in patched]
            for m, a, f in patched:
                setattr(m, a, f)
            try:
                before = sharded()
            finally:
                for (m, a, _), f in zip(patched, kept):
                    setattr(m, a, f)
            rec["bits"] = (got[0] == before[0] and torch.equal(got[2], before[2])
                           and all(torch.equal(g, before[1][k]) for k, g in got[1].items()))
    finally:
        steps.adamw_update, blocks.apply_moe = own_update, own_moe
    return rec


def _upstream(sh, g, layout: str):
    """``g`` (B, S, D) as a DTensor laid out as ``layout`` says: split over
    dp on the width and pending a sum over tp (its whole value on tp rank
    0, zeros on the others), or split over dp on the batch."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Shard

    names = sh.mesh.mesh_dim_names
    coord = sh.mesh.get_coordinate()
    dp, tp = names.index(sh.dp[0]), names.index(sh.tp)
    dim = 2 if layout == "width" else 0
    local = g.chunk(sh.mesh.size(dp), dim=dim)[coord[dp]].contiguous()
    if coord[tp]:
        local = torch.zeros_like(local)
    placements = [None, None]
    placements[dp], placements[tp] = Shard(dim), Partial()
    return DTensor.from_local(local, sh.mesh, placements, run_check=False)


def norm_case(mesh, norm: str, layout: str) -> dict:
    """The normed input's backward under ``CommDebugMode``, as it is and as
    it was: the collectives counted from the output's gradient to the
    input's, and the input's gradient against the unsharded one."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_smoke
    from repro_torch.models import blocks
    from repro_torch.models.layers import Norm
    from repro_torch.models.sharding import NULL, full, make_policy, replicating

    cfg = replace(get_smoke("nemotron-4-340b"), dtype="float32")
    sh = make_policy(cfg, mesh)
    rng = np.random.default_rng(81)
    d = cfg.d_model
    x = torch.from_numpy(rng.standard_normal((B, S, d), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((B, S, d), dtype=np.float32))
    p = {"scale": torch.from_numpy(1 + 0.1 * rng.standard_normal(d, dtype=np.float32))}
    if norm == "layernorm":
        p["bias"] = torch.from_numpy(0.1 * rng.standard_normal(d, dtype=np.float32))
    params = Norm(p)

    def grad(fn, sh, x, g):
        x = x.clone().requires_grad_(True)
        xs = sh.constrain(x.detach(), "dp", None, None).requires_grad_(True) if sh.mesh else x
        with replicating(sh):
            h = fn(params, xs, sh)
            up = _upstream(sh, g, layout) if sh.mesh else g
            comm = CommDebugMode()
            with comm:
                (gx,) = torch.autograd.grad(h, [xs], up)
        return full(gx).detach().clone(), comm.get_total_counts()

    want, _ = grad(blocks._normed, NULL, x, g)
    got, count = grad(blocks._normed, sh, x, g)
    before, count_before = grad(_old_normed, sh, x, g)
    return {"count": count, "count_before": count_before, "rel": _rel(got, want),
            "bits": torch.equal(got, want), "bits_before": torch.equal(got, before)}


# --------------------------------------------------------------------------
# The worker: one rank of a gloo group
# --------------------------------------------------------------------------

def worker(rank: int, dp: int, tp: int, store: str, out: str) -> None:
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, dp * tp), rank=rank,
                            world_size=dp * tp)
    mesh = make_debug_mesh(dp, tp, device_type="cpu")
    result = {"step": {name: step_case(mesh, name) for name in NAMES},
              "norm": {f"{n} {u}": norm_case(mesh, n, u) for n in NORMS for u in UPSTREAM}}
    if rank == 0:
        torch.save(result, out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch

    tmp = tmp_path_factory.mktemp("mesh_layouts")
    env = {**os.environ, "PYTHONPATH": SRC, "GLOO_SOCKET_IFNAME": os.environ.get(
        "GLOO_SOCKET_IFNAME", "lo"), "OMP_NUM_THREADS": "1"}
    procs = {}
    for dp, tp in MESHES:
        name = f"{dp}x{tp}"
        procs[name] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", str(r), str(dp), str(tp),
             str(tmp / f"store{name}"), str(tmp / f"{name}.pt")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(dp * tp)]
    bad = []
    try:
        for name, group in procs.items():
            for r, p in enumerate(group):
                out = p.communicate(timeout=TIMEOUT)[0]
                if p.returncode:
                    bad.append(f"{name} rank {r} rc={p.returncode}:\n{out[-4000:]}")
    finally:
        for group in procs.values():
            for p in group:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    assert not bad, "\n".join(bad)
    return {name: torch.load(tmp / f"{name}.pt", weights_only=False) for name in procs}


MESH_NAMES = [f"{dp}x{tp}" for dp, tp in MESHES]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_the_sharded_step_takes_the_unsharded_steps_gradients(runs, mesh, name):
    got = runs[mesh]["step"][name]
    if got["margin"] is not None:
        assert got["margin"] >= MODEL_MARGIN, got
    if name == "nemotron-4-340b":
        assert got["attn"] == "head_tp", got
    assert got["names"] and got["loss"] <= TOL and got["grads"] <= TOL, got


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_the_sharded_prefill_takes_the_unsharded_logits(runs, mesh, name):
    got = runs[mesh]["step"][name]
    if got["margin"] is not None:
        assert got["margin"] >= MODEL_MARGIN, got
    assert got["logits"] <= TOL, got


@pytest.mark.parametrize("name", NAMES)
def test_one_by_one_mesh_keeps_the_earlier_bits(runs, name):
    assert runs["1x1"]["step"][name]["bits"]


@pytest.mark.parametrize("upstream", UPSTREAM)
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_the_normed_gradient_moves_at_most_once(runs, mesh, norm, upstream):
    got = runs[mesh]["norm"][f"{norm} {upstream}"]
    assert got["rel"] <= TOL, got
    if mesh == "1x1":
        assert got["bits"] and got["bits_before"] and got["count"] == 0, got
    elif upstream == "rows":
        # already laid out as the output is: nothing moves
        assert got["count"] == 0, got
    else:
        # one redistribution where the earlier formulation gathered in op after op
        assert got["count"] == 1 < got["count_before"], got


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
