"""The sharded backward of the SSM mixer and the MLP on each rank's own
channels: the SSM's and the MLP's output projections with their output's
gradient summed once and laid out as the output, and the SSM gate's
gradient laid out as the gate is, on gloo meshes of host tensors, against
the port's unsharded path:

* **the steps** (``jit_train_step`` against ``build_train_step``, and a
  sharded ``forward`` prefill against the unsharded one) for the smoke
  configs of ``mamba2-2.7b``, ``jamba-v0.1-52b`` and ``qwen2-1.5b``: the
  loss, every gradient and the prefill's logits within 1e-5 relative;
  through a router, the smallest router margin over the run asserted at
  or above 1e-4 first, as ``tests/_torch_mesh.py`` does;
* **the earlier bits**: on a ``(1, 1)`` mesh each of those steps is
  bit-equal (``torch.equal``) to the same step with the earlier
  ``apply_ssm`` (the gate and the output projection as DTensor's rules
  laid out their gradients) and ``apply_mlp`` (the output's gradient as it
  arrives), re-stated here and patched in;
* **the products of the backward**: ``apply_ssm`` (the ``mamba2-2.7b``
  and ``jamba-v0.1-52b`` smoke configs) and ``apply_mlp`` (``jamba`` and
  ``qwen2-1.5b``) alone, their output's gradient handed in as the
  residual hands it (split over dp on the rows and pending a sum over tp)
  or laid out as the output is: under a dispatch mode that sees each
  rank's local ops, no ``mm`` of the backward has an operand at the whole
  ``d_inner`` or ``d_ff`` where tp splits it, where the earlier
  formulation ran such products from the pending sum; the MLP handed a
  gradient laid out as its output runs no more collectives
  (``CommDebugMode``) than the earlier formulation; every gradient within
  1e-5 of the unsharded one, bit-equal to the earlier formulation's on
  ``(1, 1)``.

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
NAMES = ("mamba2-2.7b", "jamba-v0.1-52b", "qwen2-1.5b")
#: (module, smoke config) pairs run alone; the smoke configs' d_inner and
#: d_ff (128) are no other dim of their products at B x S = 4 x 16
MODULES = (("ssm", "mamba2-2.7b"), ("ssm", "jamba-v0.1-52b"), ("mlp", "jamba-v0.1-52b"),
           ("mlp", "qwen2-1.5b"))
B, S = 4, 16
#: The output's gradient as the residual hands it (rows split over dp,
#: pending a sum over tp), and as the output is laid out.
UPSTREAM = ("pending", "rows")


# --------------------------------------------------------------------------
# The earlier formulations, for the (1, 1) mesh and the products' control
# --------------------------------------------------------------------------

def _old_apply_ssm(p, x, cfg, *, sh):
    """``apply_ssm`` as it was: the gate's and the output projection's
    gradients as DTensor's rules lay them out."""
    from repro_torch.models.sharding import grad_as_input, local_map
    from repro_torch.models.ssm import _chunk_scan, _conv_gates, _gated_norm

    b, s, d = x.shape
    h, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    q = min(cfg.ssm_chunk, s)
    nc = s // q
    z = x @ sh.constrain(p.wz, "fsdp", "tp")
    xin = x @ sh.constrain(p.wx, "fsdp", "tp")
    bmat, cmat, dt = x @ p.wB, x @ p.wC, (x @ p.wdt).float()
    xin, bmat, cmat, dt, log_decay = _conv_gates(p, xin, bmat, cmat, dt, cfg, sh)
    xh = sh.constrain(xin.reshape(b, s, h, pd), "dp", None, "tp", None)
    xc = sh.constrain(xh.reshape(b, nc, q, h, pd), "dp", None, None, "tp", None)
    bc, cc = bmat.reshape(b, nc, q, n).float(), cmat.reshape(b, nc, q, n).float()
    dtc = sh.constrain(dt.reshape(b, nc, q, h), "dp", None, None, "tp")
    ld = sh.constrain(log_decay.reshape(b, nc, q, h), "dp", None, None, "tp")
    cb, hc = sh.spec("dp", None, None, None), sh.spec("dp", None, None, "tp")
    scan = local_map(sh, _chunk_scan, (cb, cb, hc, hc, sh.spec("dp", None, None, "tp", None)), 4)
    y = sh.constrain(scan(cc, bc, ld, dtc, xc), "dp", None, None, "tp", None)
    y = grad_as_input(y.reshape(b, s, h, pd))
    y = y + xh * p.D[None, None, :, None].to(x.dtype)
    y = _gated_norm(y.reshape(b, s, cfg.d_inner), z, p.norm_scale)
    return sh.constrain(y @ sh.constrain(p.wo, "tp", "fsdp"), "dp", None, None)


def _old_apply_mlp(p, x, cfg, *, sh):
    """``apply_mlp`` as it was: the output's gradient as it arrives."""
    import torch.nn.functional as F

    from repro_torch.models.layers import matmul

    wi, wo = sh.constrain(p.wi, "fsdp", "tp"), sh.constrain(p.wo, "tp", "fsdp")
    h = sh.constrain(matmul(x, wi), "dp", None, "tp")
    if cfg.act == "silu_glu":
        h = F.silu(matmul(x, sh.constrain(p.wg, "fsdp", "tp")).float()).to(h.dtype) * h
    elif cfg.act == "sq_relu":
        h = F.relu(h.float()).square().to(h.dtype)
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return sh.constrain(matmul(h, wo), "dp", None, None)


def _earlier():
    """(module, name, function) triples that put the earlier formulations
    in place."""
    from repro_torch.models import blocks, layers, ssm

    return [(blocks, "apply_ssm", _old_apply_ssm), (ssm, "apply_ssm", _old_apply_ssm),
            (blocks, "apply_mlp", _old_apply_mlp), (layers, "apply_mlp", _old_apply_mlp)]


def _patched(fn):
    """``fn()`` with the earlier formulations in place."""
    patched = _earlier()
    kept = [getattr(m, a) for m, a, _ in patched]
    for m, a, f in patched:
        setattr(m, a, f)
    try:
        return fn()
    finally:
        for (m, a, _), f in zip(patched, kept):
            setattr(m, a, f)


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
    relative error, the router margins; on (1, 1) whether the earlier
    formulations give the same bits."""
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
    rng = np.random.default_rng(91)
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
        return init_train_state(cfg, generator=torch.Generator().manual_seed(92), device="cpu")

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
        rec = {"margin": min(margins, default=None),
               "loss": abs(got[0] - want_loss) / abs(want_loss),
               "grads": max(_rel(got[1][k], w) for k, w in want_grads.items()),
               "names": sorted(got[1]) == sorted(want_grads),
               # the vocabulary's words only: the padding's logits are -1e30
               "logits": _rel(got[2][..., :cfg.vocab_size], want_logits[..., :cfg.vocab_size])}
        if mesh.size() == 1:
            before = _patched(sharded)
            rec["bits"] = (got[0] == before[0] and torch.equal(got[2], before[2])
                           and all(torch.equal(g, before[1][k]) for k, g in got[1].items()))
    finally:
        steps.adamw_update, blocks.apply_moe = own_update, own_moe
    return rec


def _products():
    """A dispatch mode that records the local operands' shapes of each
    ``mm`` (DTensor's ops handed back to DTensor, whose local ops then
    come back here)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func is torch.ops.aten.mm.default:
                self.shapes.append((tuple(args[0].shape), tuple(args[1].shape)))
            return func(*args, **(kwargs or {}))

    return Products()


def _upstream(sh, g, layout: str):
    """``g`` (B, S, D) as a DTensor split over dp on the batch, and pending
    a sum over tp (its whole value on tp rank 0, zeros on the others) or
    replicated there."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    names = sh.mesh.mesh_dim_names
    coord = sh.mesh.get_coordinate()
    dp, tp = names.index(sh.dp[0]), names.index(sh.tp)
    local = g.chunk(sh.mesh.size(dp), dim=0)[coord[dp]].contiguous()
    placements = [None, None]
    placements[dp], placements[tp] = Shard(0), Replicate()
    if layout == "pending":
        placements[tp] = Partial()
        if coord[tp]:
            local = torch.zeros_like(local)
    return DTensor.from_local(local, sh.mesh, placements, run_check=False)


def module_case(mesh, kind: str, name: str, layout: str) -> dict:
    """``apply_ssm`` or ``apply_mlp`` alone, sharded, as it is and as it
    was: the backward's ``mm`` operands at the whole width, every
    gradient against the unsharded one."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_smoke
    from repro_torch.launch.dryrun import propagation_apart
    from repro_torch.models import layers, ssm
    from repro_torch.models.layers import set_trainable
    from repro_torch.models.model import _leaf_spec
    from repro_torch.models.sharding import NULL, distribute_tree, full, make_policy, replicating

    cfg = replace(get_smoke(name), dtype="float32")
    sh = make_policy(cfg, mesh)
    gen = torch.Generator().manual_seed(93)
    if kind == "ssm":
        p, width = ssm.init_ssm(gen, cfg, torch.float32, device="cpu"), cfg.d_inner
    else:
        p, width = layers.init_mlp(gen, cfg, cfg.d_ff, torch.float32, device="cpu"), cfg.d_ff
    with torch.no_grad():  # A_log, D and dt_bias away from their constant inits
        for t in p.parameters():
            if t.dim() == 1:
                t.add_(0.1 * torch.randn(t.shape, generator=gen))
    set_trainable(p)
    rng = np.random.default_rng(94)
    x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model), dtype=np.float32))
    specs = {k: sh.fit_spec(t.shape, _leaf_spec(f"{kind}.{k}", t.dim(), cfg, sh))
             for k, t in p.named_parameters()}
    sharded_p = distribute_tree(p, specs, sh)

    def grads(fn, sh, params):
        xs = sh.constrain(x.clone(), "dp", None, None).requires_grad_(True)
        leaves = [xs] + list(params.parameters())
        with replicating(sh), propagation_apart():
            out = fn(params, xs, cfg, sh=sh)
            up = _upstream(sh, g, layout) if sh.mesh else g
            mode, comm = _products(), CommDebugMode()
            with mode, comm:
                got = torch.autograd.grad(out, leaves, up)
        whole = [s for s in mode.shapes if width in s[0] + s[1]]
        return [full(t).detach().clone() for t in got], whole, comm.get_total_counts()

    fn = ssm.apply_ssm if kind == "ssm" else layers.apply_mlp
    old = _old_apply_ssm if kind == "ssm" else _old_apply_mlp
    want, _, _ = grads(fn, NULL, p)
    got, whole, count = grads(fn, sh, sharded_p)
    before, whole_before, count_before = grads(old, sh, sharded_p)
    return {"tp": sh.tp_size, "rel": max(_rel(a, b) for a, b in zip(got, want)),
            "whole": whole, "whole_before": whole_before, "count": count,
            "count_before": count_before,
            "bits": all(torch.equal(a, b) for a, b in zip(got, before))}


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
              "module": {f"{k} {n} {u}": module_case(mesh, k, n, u)
                         for k, n in MODULES for u in UPSTREAM}}
    if rank == 0:
        torch.save(result, out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch

    tmp = tmp_path_factory.mktemp("mesh_ssm_grads")
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
@pytest.mark.parametrize("kind,name", MODULES)
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_the_backward_runs_on_each_ranks_own_width(runs, mesh, kind, name, upstream):
    got = runs[mesh]["module"][f"{kind} {name} {upstream}"]
    assert got["rel"] <= TOL, got
    if mesh == "1x1":
        assert got["tp"] == 1 and got["bits"], got
    else:
        # tp splits the width: no product of the backward holds all of it,
        # where the earlier formulation's did from the residual's pending sum
        assert got["tp"] > 1 and not got["whole"], got
        if upstream == "pending":
            assert got["whole_before"], got
    if kind == "mlp" and upstream == "rows":
        # the output's gradient already laid out as the output: nothing moves
        assert got["count"] == got["count_before"], got


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
