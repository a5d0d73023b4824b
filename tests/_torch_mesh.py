"""Helpers of the sharded-step tests (``tests/test_torch_mesh_train*.py``,
one model family a file): the port's sharded steps
(``jit_train_step``, ``jit_serve_step``) on a ``(2, 2)`` ``("data",
"model")`` mesh of host tensors (``(2, 4)`` where a file asks for tp = 4),
against the reference's unsharded ones.

One gloo group of a rank a mesh device (``torch.distributed`` over a
``FileStore`` in a temporary directory; this file, run as a script, is the
worker) runs every
check of a test file once, on smoke configs in fp32 under
``make_policy(cfg, mesh)``; rank 0 writes what it read. The reference's
steps run meanwhile in the test's process on the same state (carried
across by ``convert.train_state_from_numpy``) and batch:

* the loss of each of 2 AdamW steps within 1e-5 relative;
* every gradient of the first step (the sharded ``loss_fn`` under
  autograd) within 1e-4 of its leaf's largest; the reference's gradient is
  read back from its first step's moment, ``m = (1 - b1) g s`` with ``s``
  the step's clip scale (its own arithmetic, one fp32 rounding away);
* the moments after 2 steps within 1e-4, and each parameter element
  within 1e-6 of the leaf's largest plus 2 lr times its gradient's
  relative error bound, ``1e-4 max|g| / |g|``, where the reference's
  gradient exceeds the gradient tolerance: Adam scales each element's
  update by that element's own running magnitude, so the update carries
  the element's relative gradient error, which the gradient limit bounds
  only through the leaf's largest (whisper's ``norm2.bias`` element at
  1.4e-3 of its leaf's largest gradient read 1.2e-4 of 2 lr); below that
  tolerance a gradient that is rounding noise may flip ``lr * sign(g)``
  (``tests/test_torch_train.py`` says why);
* 4 decode steps of ``jit_serve_step`` against the reference's
  ``decode_step``, logits within 1e-5 relative.

The learning rate is 1e-4, where ``tests/test_torch_train.py`` takes 1e-3
for one step: the second step's loss is read at parameters that a first
step of ``lr * sign(g)`` moved, and at 1e-3 the elements whose gradient is
rounding noise, each moved by +-lr in one package and maybe -+lr in the
other, moved the second loss by 2.9e-5 relative (``mamba2-2.7b``); at
1e-4 by a tenth of that, so the limit on the loss holds the step's
arithmetic, not that noise.

Through a router, the sharded path's smallest router margin over the run
is asserted at or above 1e-4 first (the hidden states reaching a router
differ between the packages by about 1e-6), as ``tests/test_torch_train.py``
does; the batch's seed is that file's.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
MESH = (2, 2)
TIMEOUT = 300
B, S = 4, 16
DECODE_STEPS = 4
LR = 1e-4
B1 = 0.9
BATCH_SEED = 6
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-6
LOGIT_TOL = 1e-5
MODEL_MARGIN = 1e-4


# --------------------------------------------------------------------------
# The worker: one rank of the gloo group
# --------------------------------------------------------------------------

def worker(rank: int, shape: tuple[int, int], store: str, tmp: str, names: list[str],
           restore: bool) -> None:
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import blocks, init_decode_state, loss_fn, moe
    from repro_torch.models.sharding import distribute_tree, full, make_policy, replicating
    from repro_torch.training import batch_specs, jit_serve_step, jit_train_step, train_state_specs

    torch.set_num_threads(1)
    world = shape[0] * shape[1]
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    mesh = make_debug_mesh(*shape, device_type="cpu")
    out: dict = {}

    def numpy(t):
        """A copy: a replicated DTensor's whole value is its local tensor,
        which the in-place step goes on updating."""
        return full(t.detach()).numpy().copy()

    margins: list = []
    real_moe = blocks.apply_moe

    def watched(p, x, cfg, *args, **kw):
        t = x.shape[0] * x.shape[1]
        r = moe.route(moe.MoE({k: full(v.detach()) for k, v in p.named_parameters()}),
                      full(x.detach()).reshape(t, -1), cfg.top_k)
        margins.append(float(moe.router_margin(r)))
        return real_moe(p, x, cfg, *args, **kw)

    def load(name):
        return torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=False)

    blocks.apply_moe = watched
    try:
        for name in names:
            case = load(name)
            cfg, state, batch = case["cfg"], case["state"], case["batch"]
            sh = make_policy(cfg, mesh)
            margins.clear()
            state = distribute_tree(state, train_state_specs(state, cfg, sh), sh)
            leaves = dict(state.params.named_parameters())
            with replicating(sh):
                loss, _ = loss_fn(state.params, cfg,
                                  distribute_tree(batch, batch_specs(cfg, sh), sh), sh=sh)
                grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            rec = {"grad_loss": float(full(loss)),
                   "grads": {k: None if g is None else numpy(g) for k, g in zip(leaves, grads)},
                   "placed": {k: tuple(p.placements) for k, p in leaves.items()}}
            step = jit_train_step(cfg, sh, state, lr_fn=lambda s: torch.tensor(LR) + 0 * s)
            losses = []
            for i in range(2):
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
                if i == 0 and restore and name == names[0]:
                    rec["params1"] = {k: numpy(p) for k, p in state.params.named_parameters()}
            rec.update(losses=losses, step=int(full(state.step)),
                       kept_placements=all(tuple(p.placements) == rec["placed"][k]
                                           for k, p in state.params.named_parameters()),
                       params={k: numpy(p) for k, p in state.params.named_parameters()},
                       m={k: numpy(v) for k, v in state.opt.m.items()},
                       v={k: numpy(v) for k, v in state.opt.v.items()},
                       train_margins=list(margins))
            # decode on the initial weights
            params = load(name)["state"].params
            dstate = init_decode_state(params, cfg, B, DECODE_STEPS)
            serve = jit_serve_step(cfg, sh, params, dstate)
            margins.clear()
            logits = []
            for i in range(DECODE_STEPS):
                lg, dstate = serve(params, dstate, case["tokens"][:, i:i + 1])
                logits.append(numpy(lg))
            rec.update(logits=logits, decode_margins=list(margins))
            rec["placed"] = {k: str(v) for k, v in rec["placed"].items()}
            out[name] = rec
    finally:
        blocks.apply_moe = real_moe
    result = {"cases": out}
    if restore:
        result["restore"] = elastic_restore(rank, mesh, tmp, load(names[0]))
        result["microbatches"] = two_microbatches(mesh, load(names[0]))
    if rank == 0:
        torch.save(result, os.path.join(tmp, "out.pt"))
    dist.barrier()
    dist.destroy_process_group()


def two_microbatches(mesh, case: dict) -> dict:
    """One sharded step of the case's state in 2 microbatches: its loss,
    parameters, and whether every parameter, moment and accumulated
    gradient kept its layout."""
    import torch

    from repro_torch.models.sharding import full, make_policy
    from repro_torch.training import jit_train_step, train_state_specs

    cfg, state = case["cfg"], case["state"]
    sh = make_policy(cfg, mesh)
    specs = train_state_specs(state, cfg, sh)
    step = jit_train_step(cfg, sh, state, 2, lr_fn=lambda s: torch.tensor(LR) + 0 * s)
    state, metrics = step(state, case["batch"])

    def laid_out(t, spec):
        return tuple(t.placements) == sh.placements(sh.fit_spec(t.shape, spec))

    return {"loss": float(metrics["loss"]),
            "params": {k: full(p.detach()).numpy().copy()
                       for k, p in state.params.named_parameters()},
            "kept": all(laid_out(p, specs.params[k]) for k, p in state.params.named_parameters())
            and all(laid_out(state.opt.m[k], s) and laid_out(state.opt.v[k], s)
                    for k, s in specs.opt.m.items())}


def elastic_restore(rank: int, mesh, tmp: str, case: dict) -> dict:
    """The case's initial state laid out on ``mesh``, saved (every rank
    gathers, rank 0 writes) beside an unsharded save of the same state,
    then restored onto no mesh and onto a ``(1, 4)`` mesh."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import restore_latest, save_checkpoint
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.sharding import distribute_tree, full, make_policy
    from repro_torch.training import train_state_specs

    cfg, plain = case["cfg"], case["state"]
    sh = make_policy(cfg, mesh)
    sharded = distribute_tree(plain, train_state_specs(plain, cfg, sh), sh)
    save_checkpoint(os.path.join(tmp, "sharded"), 3, sharded)
    if rank == 0:
        save_checkpoint(os.path.join(tmp, "plain"), 3, plain)
    dist.barrier()
    _, back = restore_latest(os.path.join(tmp, "sharded"), plain)
    wide = make_debug_mesh(1, 4, device_type="cpu")
    sh4 = make_policy(cfg, wide)
    specs4 = train_state_specs(plain, cfg, sh4)
    _, back4 = restore_latest(os.path.join(tmp, "sharded"), plain, mesh=wide, spec_tree=specs4)
    want = dict(plain.params.named_parameters())
    return {
        "null_equal": all(torch.equal(p, want[k]) for k, p in back.params.named_parameters()),
        "null_plain": all(type(p.data) is torch.Tensor for p in back.params.parameters()),
        "mesh_equal": all(torch.equal(full(p.detach()), want[k])
                          for k, p in back4.params.named_parameters()),
        "mesh_moments_equal": all(torch.equal(full(back4.opt.m[k]), plain.opt.m[k])
                                  and torch.equal(full(back4.opt.v[k]), plain.opt.v[k])
                                  for k in plain.opt.m),
        "mesh_laid_out": all(tuple(p.placements) == sh4.placements(specs4.params[k])
                             and p.device_mesh == wide for k, p in back4.params.named_parameters()),
        "step": int(full(back4.step)),
    }


# --------------------------------------------------------------------------
# The reference, and one run of a test file's checks
# --------------------------------------------------------------------------

def _batch(cfg, rng) -> dict:
    out = {}
    if cfg.frontend != "none":
        out["embeds"] = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.is_encdec:
        out["dec_tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out["dec_labels" if cfg.is_encdec else "labels"] = rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return out


def _prepare(name: str, tmp: str):
    """The reference's state and batch for one smoke config in fp32; the
    case the workers load (the port's state from the same arrays)."""
    from dataclasses import asdict, replace

    import jax
    import torch

    from repro.configs import get_smoke
    from repro.training import init_train_state
    from repro_torch import convert
    from repro_torch.models import ArchConfig

    ref_cfg = replace(get_smoke(name), dtype="float32")
    cfg = ArchConfig(**asdict(ref_cfg))
    state = init_train_state(jax.random.PRNGKey(4), ref_cfg)
    batch = _batch(cfg, np.random.default_rng(BATCH_SEED))
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, DECODE_STEPS)).astype(
        np.int32)
    torch.save({"cfg": cfg, "state": convert.train_state_from_numpy(
                    jax.tree.map(np.asarray, state), cfg, device="cpu"),
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
                "tokens": torch.from_numpy(tokens)}, os.path.join(tmp, f"{name}.pt"))
    return ref_cfg, cfg, state, batch, tokens


def _reference(ref_cfg, cfg, state, batch, tokens) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.models import decode_step, init_decode_state
    from repro.models.sharding import NULL
    from repro.training import build_train_step
    from repro_torch import convert

    def by_name(tree):
        return {k: p.detach().numpy() for k, p in convert.lm_from_numpy(
            jax.tree.map(np.asarray, tree), cfg, device="cpu").named_parameters()}

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(build_train_step(ref_cfg, NULL, lr_fn=lambda s: jnp.float32(LR) + 0 * s))
    new, m1 = step(state, jbatch)
    grads = jax.tree.map(lambda m: m / ((1 - B1) * m1["clip_scale"]), new.opt.m)
    losses = [float(m1["loss"])]
    new, m2 = step(new, jbatch)
    losses.append(float(m2["loss"]))
    decode = jax.jit(lambda p, s, t: decode_step(p, ref_cfg, s, t))
    dstate = init_decode_state(state.params, ref_cfg, B, DECODE_STEPS)
    logits = []
    for i in range(DECODE_STEPS):
        lg, dstate = decode(state.params, dstate, jnp.asarray(tokens[:, i:i + 1]))
        logits.append(np.asarray(lg))
    return {"losses": losses, "grads": by_name(grads), "params": by_name(new.params),
            "m": by_name(new.opt.m), "v": by_name(new.opt.v), "logits": logits}


def run(names: tuple[str, ...], tmp: str, restore: bool = False,
        shape: tuple[int, int] = MESH) -> dict:
    """Every case prepared, a rank a device of the ``shape`` mesh started on
    them, the reference's steps meanwhile; the ranks' readings beside the
    reference's."""
    import torch

    prepared = {name: _prepare(name, tmp) for name in names}
    env = {**os.environ, "PYTHONPATH": SRC, "GLOO_SOCKET_IFNAME": os.environ.get(
        "GLOO_SOCKET_IFNAME", "lo"), "OMP_NUM_THREADS": "1"}
    store = os.path.join(tmp, "store")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "worker", str(r),
                               "x".join(map(str, shape)), store, tmp, ",".join(names),
                               str(int(restore))],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(shape[0] * shape[1])]
    outs = []
    try:
        ref = {name: _reference(*prepared[name]) for name in names}
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(i, p.returncode, o) for i, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    assert not bad, "\n".join(f"rank {i} rc={rc}:\n{o[-4000:]}" for i, rc, o in bad)
    got = torch.load(os.path.join(tmp, "out.pt"), weights_only=False)
    return {"ref": ref, "got": got["cases"], "restore": got.get("restore"),
            "microbatches": got.get("microbatches"), "tmp": tmp}


# --------------------------------------------------------------------------
# The checks
# --------------------------------------------------------------------------

def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _precondition(name, margins):
    if margins:
        assert min(margins) >= MODEL_MARGIN, (
            f"{name}: the router's smallest margin {min(margins):.2e} is below {MODEL_MARGIN}")


def check_losses(run: dict, name: str) -> None:
    got, ref = run["got"][name], run["ref"][name]
    _precondition(name, got["train_margins"])
    assert got["step"] == 2
    for a, b in zip(got["losses"], ref["losses"]):
        assert abs(a - b) <= LOSS_TOL * abs(b), (got["losses"], ref["losses"])
    assert abs(got["grad_loss"] - ref["losses"][0]) <= LOSS_TOL * abs(ref["losses"][0])


def check_gradients(run: dict, name: str) -> None:
    got, ref = run["got"][name], run["ref"][name]
    _precondition(name, got["train_margins"])
    assert set(got["grads"]) == set(ref["grads"])
    for k, want in ref["grads"].items():
        g = got["grads"][k]
        g = np.zeros_like(want) if g is None else g
        assert float(np.abs(g - want).max()) <= GRAD_TOL * max(float(np.abs(want).max()),
                                                               1e-30), k


def check_parameters(run: dict, name: str) -> None:
    got, ref = run["got"][name], run["ref"][name]
    _precondition(name, got["train_margins"])
    assert got["kept_placements"], "the in-place step changed a parameter's placement"
    for k, want in ref["params"].items():
        g = np.abs(ref["grads"][k])
        bound = GRAD_TOL * max(float(g.max()), 1e-30)
        sure = g > bound
        limit = PARAM_TOL * float(np.abs(want).max()) + 2 * LR * np.minimum(
            bound / np.maximum(g, 1e-30), 1.0)
        assert (np.abs(got["params"][k] - want) <= limit)[sure].all(), k
        for which in ("m", "v"):
            assert _rel(got[which][k], ref[which][k]) <= GRAD_TOL, (which, k)


def check_microbatches(run: dict, name: str) -> None:
    """Two microbatches of half the batch take the whole batch's step: the
    mean of the halves' losses is the whole's, and so is the mean of their
    gradients (within the same limits as the step against the
    reference)."""
    got, ref, mb = run["got"][name], run["ref"][name], run["microbatches"]
    assert mb["kept"], "a parameter or moment left its layout"
    assert abs(mb["loss"] - ref["losses"][0]) <= LOSS_TOL * abs(ref["losses"][0])
    for k, want in got["params1"].items():
        g = np.abs(ref["grads"][k])
        bound = GRAD_TOL * max(float(g.max()), 1e-30)
        limit = PARAM_TOL * float(np.abs(want).max()) + LR * np.minimum(
            bound / np.maximum(g, 1e-30), 1.0)
        assert (np.abs(mb["params"][k] - want) <= limit)[g > bound].all(), k


def check_decode(run: dict, name: str) -> None:
    got, ref = run["got"][name], run["ref"][name]
    _precondition(name, got["decode_margins"])
    assert len(got["logits"]) == DECODE_STEPS
    for a, b in zip(got["logits"], ref["logits"]):
        assert _rel(a, b) <= LOGIT_TOL


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        worker(int(sys.argv[2]), tuple(map(int, sys.argv[3].split("x"))), sys.argv[4],
               sys.argv[5], sys.argv[6].split(","), bool(int(sys.argv[7])))
