"""The sharded path's vocabulary-parallel embedding lookup, its head and
its microbatch split, on gloo meshes of host tensors, against the port's
unsharded path:

* **the lookup** (``layers._vocab_parallel_take``): ``qwen2-1.5b``'s smoke
  table with a vocabulary of 200 words (256 rows padded, so every tp part
  holds words and the last also padding), ids in every part and in the
  padding, under each of its three layouts (the rows moved, the table's
  words gathered, the whole table gathered) and under the one it picks
  (``layers._lookup_layout``): the rows bit-equal
  (``torch.equal``) to ``table[ids]``, and the table's gradient bit-equal
  under integer upstream gradients (every sum exact in any order), within
  1e-5 relative under drawn ones;
* **the microbatch split** (``steps._split``): a batch of tokens and one
  of embeddings laid out over dp, cut into 1, 2 and 4 microbatches: each
  part bit-equal to the reference's rows ``[i * n, (i + 1) * n)`` and laid
  out over dp, and ``CommDebugMode`` counting no all-gather, one
  reduce-scatter a part (the earlier slice-and-constrain gathered the
  whole batch onto every rank for each part);
* **the sharded train step** (``jit_train_step``) with 1, 2 and 4
  microbatches against ``build_train_step`` from the same seed, for a
  token model (``qwen2-1.5b``'s smoke config) and an embeddings model
  (``qwen2-vl-72b``'s): the loss and every gradient within 1e-5 relative.

On a ``(1, 1)`` mesh the train step is also bit-equal to the same step
with the earlier lookup, logits and split (re-stated here) patched in.

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
VOCAB = 200
#: The lookup's ids: the first of them set to these (words in every tp part
#: of 256 rows on tp = 4, and padding rows), the rest drawn over all rows.
IDS_B, IDS_S = 4, 16
SET_IDS = (0, 63, 64, 127, 128, 199, 200, 203, 255)
LAYOUTS = ("rows", "table", "whole", "auto")
TRAIN_B, TRAIN_S = 8, 16
MICROBATCHES = (1, 2, 4)
#: The train step's models: one reads tokens, one embeddings.
TRAIN_NAMES = ("qwen2-1.5b", "qwen2-vl-72b")


# --------------------------------------------------------------------------
# The earlier formulations, for the (1, 1) mesh
# --------------------------------------------------------------------------

def _old_embed_tokens(p, ids, *, sh):
    """The lookup as it was: each rank's batch rows from the whole table."""
    from repro_torch.models.sharding import local_map

    rows = local_map(sh, lambda table, ids: table[ids],
                     ((None, None), sh.spec("dp", None)), 1)(p.table, ids)
    return sh.constrain(rows, "dp", None, None)


def _old_logits(p, x, vocab_size=None, *, sh):
    """The logits as they were: the head left at ``("fsdp", "tp")``."""
    import torch

    from repro_torch.models.layers import matmul

    head = sh.constrain(p.head if "head" in p else p.table.T, "fsdp", "tp")
    out = matmul(x, head)
    v_pad = head.shape[-1]
    if vocab_size is not None and vocab_size < v_pad:
        mask = torch.arange(v_pad, device=out.device) < vocab_size
        out = torch.where(mask, out, torch.tensor(-1e30, dtype=out.dtype, device=out.device))
    return sh.constrain(out, "dp", None, "tp")


def _old_split(batch, microbatches, sh):
    """The split as it was: each part a slice of the dp-sharded batch."""
    out = [{} for _ in range(microbatches)]
    for k, x in batch.items():
        n = x.shape[0] // microbatches
        for i in range(microbatches):
            out[i][k] = sh.constrain(x[i * n:(i + 1) * n], "dp", *(None,) * (x.dim() - 1))
    return out


# --------------------------------------------------------------------------
# The cases
# --------------------------------------------------------------------------

def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    from repro_torch.models.sharding import full

    got, want = full(got).detach().double(), full(want).detach().double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def lookup_case(mesh, layout: str) -> dict:
    """The lookup sharded (its layout forced, or ``"auto"``) and unsharded:
    the rows' and the gradients' equality, the ids' tp parts, the layout
    that ran."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.models import layers
    from repro_torch.models.layers import Embedding, embed_tokens, set_trainable
    from repro_torch.models.model import _leaf_spec
    from repro_torch.models.sharding import distribute_tree, full, make_policy, replicating

    cfg = replace(get_smoke("qwen2-1.5b"), dtype="float32", vocab_size=VOCAB)
    sh = make_policy(cfg, mesh)
    rng = np.random.default_rng(41)
    v, d = cfg.padded_vocab, cfg.d_model
    table = torch.from_numpy(rng.standard_normal((v, d), dtype=np.float32))
    ids = rng.integers(0, v, (IDS_B, IDS_S))
    ids.ravel()[:len(SET_IDS)] = SET_IDS
    ids = torch.from_numpy(ids.astype(np.int32))
    upstream = {"integer": torch.from_numpy(rng.integers(-8, 9, (IDS_B, IDS_S, d))
                                            .astype(np.float32)),
                "drawn": torch.from_numpy(rng.standard_normal((IDS_B, IDS_S, d),
                                                              dtype=np.float32))}
    emb = set_trainable(Embedding({"table": table}))
    semb = distribute_tree(emb, {"table": _leaf_spec("embed.table", 2, cfg, sh)}, sh)
    sids = sh.constrain(ids, "dp", None)
    chosen = []
    own = layers._lookup_layout

    def forced(*args):
        chosen.append(own(*args) if layout == "auto" else layout)
        return chosen[-1]

    def run(p, ids, sh, w):
        with replicating(sh):
            rows = embed_tokens(p, ids, sh=sh)
            (g,) = torch.autograd.grad((rows * sh.constrain(w, "dp", None, None)).sum(),
                                       [p.table])
        return full(rows).detach().clone(), full(g).detach().clone()

    layers._lookup_layout = forced
    try:
        got = {k: run(semb, sids, sh, w) for k, w in upstream.items()}
    finally:
        layers._lookup_layout = own
    want = {k: run(emb, ids, make_policy(cfg, None), w) for k, w in upstream.items()}
    part = v // mesh.size(1)
    return {"layouts": sorted(set(chosen)),
            "parts": sorted({int(i) // part for i in ids.ravel()}),
            "padding": bool((ids >= VOCAB).any()),
            "rows": all(torch.equal(got[k][0], want[k][0]) for k in got),
            "grad_integer": torch.equal(got["integer"][1], want["integer"][1]),
            "grad_drawn": _rel(got["drawn"][1], want["drawn"][1]),
            "grad_drawn_bits": torch.equal(got["drawn"][1], want["drawn"][1])}


def split_case(mesh) -> dict:
    """A batch of tokens and one of embeddings over dp, split under
    ``CommDebugMode``: each part against the reference's rows, its
    layout, and the collectives by kind."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_smoke
    from repro_torch.models.sharding import full, make_policy, replicating
    from repro_torch.training import steps

    cfg = get_smoke("qwen2-vl-72b")
    sh = make_policy(cfg, mesh)
    rng = np.random.default_rng(51)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 1 << 20, (TRAIN_B, TRAIN_S))
                                        .astype(np.int32)),
             "embeds": torch.from_numpy(rng.standard_normal((TRAIN_B, TRAIN_S, cfg.d_model),
                                                            dtype=np.float32))}
    placed = {k: sh.constrain(x, "dp", *(None,) * (x.dim() - 1)) for k, x in batch.items()}
    out = {}
    for mb in MICROBATCHES:
        comm = CommDebugMode()
        with replicating(sh), comm:
            parts = steps._split(placed, mb, sh)
        n = TRAIN_B // mb
        out[mb] = {
            "rows": all(torch.equal(full(p[k]), batch[k][i * n:(i + 1) * n])
                        for i, p in enumerate(parts) for k in batch),
            "laid_out": all(tuple(p[k].placements) == sh.placements(sh.fit_spec(
                p[k].shape, sh.spec("dp", *(None,) * (p[k].dim() - 1))))
                for p in parts for k in batch),
            "kinds": {str(op).split(".")[-1]: c for op, c in comm.get_comm_counts().items()}}
    return out


def train_case(mesh, name: str, microbatches: int) -> dict:
    """One sharded step and one unsharded step from the same seed: the
    losses' and every gradient's largest relative error; on (1, 1) whether
    the earlier lookup, logits and split give the same bits."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.models import model as model_mod
    from repro_torch.models.sharding import full, make_policy
    from repro_torch.training import build_train_step, init_train_state, jit_train_step, steps

    cfg = replace(get_smoke(name), dtype="float32")
    sh = make_policy(cfg, mesh)
    rng = np.random.default_rng(61)
    batch = {"labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S))
                                        .astype(np.int32))}
    if cfg.frontend != "none":
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (TRAIN_B, TRAIN_S, cfg.d_model), dtype=np.float32))
    else:
        batch["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S))
                                           .astype(np.int32))
    captured = []
    own = steps.adamw_update

    def watched(params, grads, *args, **kw):
        captured.append({k: full(g).detach().clone() for k, g in grads.items()})
        return own(params, grads, *args, **kw)

    def state():
        return init_train_state(cfg, generator=torch.Generator().manual_seed(62), device="cpu")

    def sharded():
        s = state()
        _, metrics = jit_train_step(cfg, sh, s, microbatches)(s, batch)
        return float(metrics["loss"]), captured.pop()

    steps.adamw_update = watched
    try:
        _, metrics = build_train_step(cfg, microbatches=microbatches)(state(), batch)
        want = (float(metrics["loss"]), captured.pop())
        got = sharded()
        rec = {"loss": abs(got[0] - want[0]) / abs(want[0]),
               "grads": max(_rel(got[1][k], w) for k, w in want[1].items()),
               "names": sorted(got[1]) == sorted(want[1])}
        if mesh.size() == 1:
            patched = ((model_mod, "embed_tokens", _old_embed_tokens),
                       (model_mod, "lm_logits", _old_logits), (steps, "_split", _old_split))
            kept = [getattr(m, a) for m, a, _ in patched]
            for m, a, f in patched:
                setattr(m, a, f)
            try:
                before = sharded()
            finally:
                for (m, a, _), f in zip(patched, kept):
                    setattr(m, a, f)
            rec["bits"] = got[0] == before[0] and all(
                torch.equal(g, before[1][k]) for k, g in got[1].items())
    finally:
        steps.adamw_update = own
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
    result = {"lookup": {layout: lookup_case(mesh, layout) for layout in LAYOUTS},
              "split": split_case(mesh),
              "train": {f"{name} {mb}": train_case(mesh, name, mb)
                        for name in TRAIN_NAMES for mb in MICROBATCHES}}
    if rank == 0:
        torch.save(result, out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch

    tmp = tmp_path_factory.mktemp("mesh_vocab")
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


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_the_vocab_parallel_lookup_takes_the_tables_rows(runs, mesh, layout):
    got = runs[mesh]["lookup"][layout]
    tp = int(mesh.split("x")[1])
    assert got["parts"] == list(range(tp)) and got["padding"], got
    if layout != "auto":
        assert got["layouts"] == [layout], got
    assert len(got["layouts"]) == 1, got
    assert got["rows"] and got["grad_integer"], got
    assert got["grad_drawn"] <= TOL, got
    if mesh == "1x1" or got["layouts"] == ["rows"]:
        # one rank, or every id's row summed on the rank of its width: one order
        assert got["grad_drawn_bits"], got


@pytest.mark.parametrize("mb", MICROBATCHES)
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_the_split_moves_no_batch_onto_every_rank(runs, mesh, mb):
    got = runs[mesh]["split"][mb]
    assert got["rows"] and got["laid_out"], got
    assert not any("all_gather" in k for k in got["kinds"]), got
    if mesh != "1x1" and mb > 1:
        # one reduce-scatter a part and a key, each of that part alone
        assert got["kinds"] == {"reduce_scatter_tensor": 2 * mb}, got


@pytest.mark.parametrize("mb", MICROBATCHES)
@pytest.mark.parametrize("name", TRAIN_NAMES)
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_the_sharded_step_takes_the_unsharded_steps_gradients(runs, mesh, name, mb):
    got = runs[mesh]["train"][f"{name} {mb}"]
    assert got["names"] and got["loss"] <= TOL and got["grads"] <= TOL, got


@pytest.mark.parametrize("mb", MICROBATCHES)
@pytest.mark.parametrize("name", TRAIN_NAMES)
def test_one_by_one_mesh_keeps_the_earlier_bits(runs, name, mb):
    assert runs["1x1"]["train"][f"{name} {mb}"]["bits"]


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
