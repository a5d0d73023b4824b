"""The three parts of the sharded path that keep the reference's sharding,
on gloo meshes of host tensors, against the port's unsharded path:

* **decode on a sequence-sharded cache** (``attention._decode_seq_sharded``):
  ``qwen2-1.5b``'s smoke model under each attention policy (``context``
  forced: the smoke heads divide tp; ``head_tp``, its own), 40 decode steps from an empty cache of 40
  positions, so that ``length`` crosses every shard boundary of the
  sequence (one at position 20 on sp = 2, three on sp = 4); each step's
  logits and the final caches within 1e-5 relative of ``decode_step``'s;
* **MoE on each rank's own tokens** (``moe.assign_sharded``,
  ``moe._apply_sharded``): ``olmoe-1b-7b``'s smoke layer on 2048 tokens
  under both MoE policies, its routing held fixed; the queue positions and
  kept flags bit-equal to the unsharded ``assign``, on a router draw and
  on a skewed one where every token's first choice is expert 0, whose 768
  slots keep the earliest 768 tokens in global order; ``y`` and the
  gradients of the input and the expert weights within 1e-5 relative;
* **the vocabulary-parallel NLL** (``model._vocab_parallel_nll``):
  ``qwen2-1.5b``'s smoke model with a vocabulary of 200 words (256 rows
  padded, so every tp shard holds words and the last also padding), the
  ``nll`` and every parameter gradient within 1e-5 relative, with labels
  in every vocabulary shard, and again with labels in the padding too.

On a ``(1, 1)`` mesh each of the three is also bit-equal (``torch.equal``)
to the path it replaced: the decode step under ``decode_cache="heads"``
(which keeps the whole-cache core), and MoE and the loss with the earlier
``local_map`` formulations (re-stated here) patched in.

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
DECODE_B, DECODE_LEN = 4, 40
#: The attention policies the decode case runs under.
ATTN = ("context", "head_tp")
MOE_B, MOE_S = 4, 512
LOSS_B, LOSS_S, LOSS_VOCAB = 4, 16, 200
#: The loss case's labels in the padding (LOSS_VOCAB..255).
PAD_LABELS = (203, 255)


# --------------------------------------------------------------------------
# The earlier formulations, for the (1, 1) mesh
# --------------------------------------------------------------------------

def _old_moe(p, xf, r, cfg, cap, sh):
    """MoE's assignment, dispatch and combine as they were: on each rank's
    replicated copy of every token."""
    from repro_torch.models.moe import Routing, assign, combine, dispatch, experts
    from repro_torch.models.sharding import local_map

    e = cfg.n_experts
    rep2, rep3 = (None, None), (None, None, None)
    pos, keep = local_map(sh, lambda ids: assign(ids, e, cap), (rep2,), (None, None))(r.ids)
    xe = local_map(sh, lambda xf, ids, pos, keep: dispatch(xf, ids, pos, keep, e, cap),
                   (rep2,) * 4, None)(xf, r.ids, pos, keep)
    ye = experts(p, xe, cfg, sh=sh)
    return local_map(sh, lambda ye, gates, ids, pos, keep: combine(ye, Routing(None, gates, ids),
                                                                    pos, keep),
                     (rep3,) + (rep2,) * 4, None)(ye, r.gates, r.ids, pos, keep)


def _old_nll(out, labels, sh):
    """The loss's NLL as it was: each rank's batch rows over the whole
    vocabulary."""
    from repro_torch.models.model import _nll
    from repro_torch.models.sharding import local_map

    return local_map(sh, _nll, (sh.spec("dp", None, None), sh.spec("dp", None)), 1)(out, labels)


# --------------------------------------------------------------------------
# The cases
# --------------------------------------------------------------------------

def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    from repro_torch.models.sharding import full

    got, want = full(got).detach().double(), full(want).detach().double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def decode_case(mesh, attn: str) -> dict:
    """40 decode steps sharded under the attention policy ``attn`` and
    unsharded: the largest relative error of the logits, of the caches,
    and (on (1, 1)) whether the whole-cache core gives the same bits."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.models import decode_step, init_decode_state, init_params
    from repro_torch.models.sharding import full, make_policy
    from repro_torch.training import jit_serve_step

    cfg = replace(get_smoke("qwen2-1.5b"), dtype="float32")
    sh = replace(make_policy(cfg, mesh), attn=attn)
    params = init_params(cfg, generator=torch.Generator().manual_seed(11), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (DECODE_B, DECODE_LEN)).astype(np.int32))

    def sharded(policy):
        state = init_decode_state(params, cfg, DECODE_B, DECODE_LEN)
        serve = jit_serve_step(cfg, policy, params, state)
        logits = []
        for i in range(DECODE_LEN):
            out, state = serve(params, state, tokens[:, i:i + 1])
            logits.append(full(out).clone())
        return logits, state

    plain = init_decode_state(params, cfg, DECODE_B, DECODE_LEN)
    want = []
    for i in range(DECODE_LEN):
        out, plain = decode_step(params, cfg, plain, tokens[:, i:i + 1])
        want.append(out.clone())
    got, state = sharded(sh)
    caches = [(c.k, c.v) for c in state["caches"]]
    rec = {"policy": (sh.attn, sh.decode_cache), "sp": mesh.size(1),
           "logits": max(_rel(g, w) for g, w in zip(got, want)),
           "cache": max(_rel(a, b) for (ka, va), c in zip(caches, plain["caches"])
                        for a, b in ((ka, c.k), (va, c.v))),
           "length": int(full(state["caches"][0].length))}
    if mesh.size() == 1:
        before, _ = sharded(replace(sh, decode_cache="heads"))
        rec["bits"] = all(torch.equal(a, b) for a, b in zip(got, before))
    return rec


def _moe_inputs(cfg, skewed: bool):
    """2048 tokens' hidden states and a routing of them: the router's, or
    every first choice expert 0 and a second drawn from the others."""
    import torch

    from repro_torch.models import set_trainable
    from repro_torch.models.moe import Routing, init_moe, route

    rng = np.random.default_rng(21)
    p = set_trainable(init_moe(torch.Generator().manual_seed(22), cfg, torch.float32,
                               device="cpu"))
    x = torch.from_numpy(rng.standard_normal((MOE_B, MOE_S, cfg.d_model), dtype=np.float32))
    with torch.no_grad():
        r = route(p, x.reshape(-1, cfg.d_model), cfg.top_k)
    if skewed:
        t = MOE_B * MOE_S
        ids = torch.stack([torch.zeros(t, dtype=torch.int64),
                           torch.from_numpy(rng.integers(1, cfg.n_experts, t))], dim=1)
        gates = torch.from_numpy(rng.uniform(0.1, 1.0, (t, 2)).astype(np.float32))
        r = Routing(r.probs, gates / gates.sum(dim=1, keepdim=True), ids)
    return p, x, r


def moe_case(mesh, moe: str, skewed: bool) -> dict:
    """One MoE layer with its routing held fixed, sharded and unsharded:
    the routing integers' equality, the drops, and the relative errors of
    ``y`` and of the gradients; on (1, 1) whether the earlier formulation
    gives the same bits."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.sharding import distribute_tree, full, make_policy, replicating

    cfg = replace(get_smoke("olmoe-1b-7b"), dtype="float32")
    sh = replace(make_policy(cfg, mesh), moe=moe)
    p, x, r = _moe_inputs(cfg, skewed)
    t, e, k = MOE_B * MOE_S, cfg.n_experts, cfg.top_k
    cap = moe_mod.capacity(t, k, e)
    pos, keep = moe_mod.assign(r.ids, e, cap)
    spos, skeep = moe_mod.assign_sharded(r.ids, e, cap, sh)
    names = ("wi", "wo", "wg")

    def run(params, x):
        x = x.clone().requires_grad_(True)
        with replicating(sh):
            y, _ = moe_mod.apply_moe(params, x, cfg, routing=r, sh=sh)
            leaves = [x] + [getattr(params, n) for n in names]
            grads = torch.autograd.grad((y * y).sum(), leaves)
        return [full(v).detach().clone() for v in (y, *grads)]

    want = _run_plain(p, x, cfg, r, names)
    sp = distribute_tree(p, _moe_specs(cfg, sh), sh)
    xs = sh.constrain(x, "dp", None, None)
    got = run(sp, xs)
    rec = {"policy": sh.moe, "skewed": skewed, "cap": cap,
           "dropped": int((~keep).sum()),
           "first_kept": int(keep[:, 0].sum()), "first_kept_earliest": bool(
               keep[:int(keep[:, 0].sum()), 0].all()),
           "pos_equal": torch.equal(full(spos), pos), "keep_equal": torch.equal(full(skeep), keep),
           "y": _rel(got[0], want[0]), "grads": max(_rel(a, b) for a, b in zip(got[1:], want[1:]))}
    if mesh.size() == 1:
        own = moe_mod._apply_sharded
        moe_mod._apply_sharded = _old_moe
        try:
            before = run(sp, xs)
        finally:
            moe_mod._apply_sharded = own
        rec["bits"] = all(torch.equal(a, b) for a, b in zip(got, before))
    return rec


def _run_plain(p, x, cfg, r, names):
    """The unsharded MoE layer's ``y`` and gradients."""
    import torch

    from repro_torch.models.moe import apply_moe

    x = x.clone().requires_grad_(True)
    y, _ = apply_moe(p, x, cfg, routing=r)
    return [y.detach()] + [g.detach() for g in torch.autograd.grad(
        (y * y).sum(), [x] + [getattr(p, n) for n in names])]


def _moe_specs(cfg, sh) -> dict:
    """The MoE layer's parameter specs, as the model lays out an MoE
    layer's."""
    from repro_torch.models.model import _leaf_spec

    return {n: sh.fit_spec(s, _leaf_spec(f"blocks.0.moe.{n}", len(s), cfg, sh))
            for n, s in (("router", (cfg.d_model, cfg.n_experts)),
                         ("wi", (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)),
                         ("wg", (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)),
                         ("wo", (cfg.n_experts, cfg.moe_d_ff, cfg.d_model)))}


def loss_case(mesh, pad: bool) -> dict:
    """``loss_fn`` and its gradients sharded and unsharded: the relative
    errors of the nll and of every parameter's gradient, the labels'
    vocabulary shards; on (1, 1) whether the earlier NLL gives the same
    bits."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.models import init_params, loss_fn, set_trainable
    from repro_torch.models import model as model_mod
    from repro_torch.models.model import param_specs
    from repro_torch.models.sharding import distribute_tree, full, make_policy, replicating

    cfg = replace(get_smoke("qwen2-1.5b"), dtype="float32", vocab_size=LOSS_VOCAB)
    sh = make_policy(cfg, mesh)
    rng = np.random.default_rng(31)
    labels = rng.integers(0, cfg.vocab_size, (LOSS_B, LOSS_S))
    if pad:
        labels[0, :len(PAD_LABELS)] = PAD_LABELS
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (LOSS_B, LOSS_S))
                                        .astype(np.int32)),
             "labels": torch.from_numpy(labels.astype(np.int32))}
    params = set_trainable(init_params(cfg, generator=torch.Generator().manual_seed(32),
                                       device="cpu"))

    def run(params, sh):
        with replicating(sh):
            total, aux = loss_fn(params, cfg, batch, sh=sh)
            grads = torch.autograd.grad(total, list(params.parameters()))
        return [full(aux["nll"]).detach().clone()] + [full(g).detach().clone() for g in grads]

    want = run(params, model_mod.NULL)
    sparams = distribute_tree(params, param_specs(params, cfg, sh), sh)
    got = run(sparams, sh)
    part = cfg.padded_vocab // mesh.size(1)
    rec = {"nll": _rel(got[0], want[0]),
           "grads": max(_rel(a, b) for a, b in zip(got[1:], want[1:])),
           "shards": sorted({int(v) // part for v in labels.ravel()}),
           "padding": bool((labels >= cfg.vocab_size).any())}
    if mesh.size() == 1:
        own = model_mod._vocab_parallel_nll
        model_mod._vocab_parallel_nll = _old_nll
        try:
            before = run(sparams, sh)
        finally:
            model_mod._vocab_parallel_nll = own
        rec["bits"] = all(torch.equal(a, b) for a, b in zip(got, before))
    return rec


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
    result = {"decode": {attn: decode_case(mesh, attn) for attn in ATTN},
              "moe": {f"{moe} {'skewed' if skewed else 'routed'}": moe_case(mesh, moe, skewed)
                      for moe in ("expert", "ffn") for skewed in (False, True)},
              "loss": {"labels": loss_case(mesh, False), "padding": loss_case(mesh, True)}}
    if rank == 0:
        torch.save(result, out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch

    tmp = tmp_path_factory.mktemp("mesh_costs")
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


@pytest.mark.parametrize("attn", ATTN)
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_decode_on_a_sequence_sharded_cache(runs, mesh, attn):
    got = runs[mesh]["decode"][attn]
    assert got["policy"] == (attn, "seq") and got["length"] == DECODE_LEN
    assert got["logits"] <= TOL and got["cache"] <= TOL, got


@pytest.mark.parametrize("case", ["expert routed", "expert skewed", "ffn routed", "ffn skewed"])
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_moe_routes_each_ranks_own_tokens(runs, mesh, case):
    got = runs[mesh]["moe"][case]
    assert got["policy"] == case.split()[0]
    assert got["pos_equal"] and got["keep_equal"], got
    if got["skewed"]:
        # expert 0 overflows: its slots keep the earliest tokens, all dp ranks' order
        assert got["first_kept"] == got["cap"] and got["first_kept_earliest"], got
        assert got["dropped"] == MOE_B * MOE_S - got["cap"], got
    assert got["y"] <= TOL and got["grads"] <= TOL, got


@pytest.mark.parametrize("labels", ["labels", "padding"])
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_vocab_parallel_loss(runs, mesh, labels):
    got = runs[mesh]["loss"][labels]
    tp = int(mesh.split("x")[1])
    assert got["shards"] == list(range(tp)) and got["padding"] is (labels == "padding"), got
    assert got["nll"] <= TOL and got["grads"] <= TOL, got


@pytest.mark.parametrize("part", ["decode", "moe", "loss"])
def test_one_by_one_mesh_keeps_the_earlier_bits(runs, part):
    got = runs["1x1"][part]
    assert all(c["bits"] for c in got.values()), got


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
