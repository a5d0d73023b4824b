"""The port's CP gradient compression against the reference:
``cp_compressed_mean`` and ``compressed_gradient``'s error feedback on a
gloo group of 4 ranks against the reference's on a 4-device ``dp`` mesh,
the all-reduce's operand bytes against ``sweeps * sum(dims) * rank *
itemsize``, and ``pick_3way_shape`` / ``compression_ratio``.

The JAX key cannot be reproduced in torch, so both sides start from the
same explicit factors (numpy, one seed). The ranks run in one group for the
module (``torch.distributed`` over a ``FileStore`` in ``tmp_path``); the
reference runs in a subprocess with 4 host devices (``XLA_FLAGS``), as
``tests/dist_worker.py`` does. Tolerance: 1e-5 of the largest magnitude.

Run as a script, this file is the worker (``worker``) or the reference
(``reference``).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_distributed import SRC, wait_all

WORLD = 4
#: The mean check (the reference's ``check_cp_compressed_mean``): dims,
#: rank, sweeps; each worker's gradient a rank-3 base plus i x 0.01 of a
#: rank-2 delta.
MEAN = ((16, 12, 1), 6, 25)
#: The byte check (``check_collective_only_factor_sized``): dims, rank, sweeps.
BYTES = ((32, 24, 1), 4, 2)
#: Error feedback: a 2-D gradient of this shape at this rank, two steps.
FEEDBACK = ((20, 18), 4, 2)


def _orthonormal(rng, dims, rank) -> list[np.ndarray]:
    out = []
    for d in dims:
        g = rng.standard_normal((d, rank))
        if d >= rank:
            out.append(np.linalg.qr(g)[0].astype(np.float32))
        else:
            out.append((g / np.linalg.norm(g, axis=0, keepdims=True)).astype(np.float32))
    return out


def _cp(rng, dims, rank) -> np.ndarray:
    fs = [rng.standard_normal((d, rank)) for d in dims]
    return np.einsum("az,bz,cz->abc", *fs)


def make_inputs(path: str) -> None:
    rng = np.random.default_rng(24)
    arrays = {}
    dims, rank, _ = MEAN
    base, delta = _cp(rng, dims, 3), _cp(rng, dims, 2)
    arrays["mean_g"] = np.stack([base + i * 0.01 * delta for i in range(WORLD)]).astype(
        np.float32)
    for k, f in enumerate(_orthonormal(rng, dims, rank)):
        arrays[f"mean_f{k}"] = f
    dims, rank, _ = BYTES
    arrays["bytes_g"] = rng.standard_normal((WORLD,) + dims).astype(np.float32)
    for k, f in enumerate(_orthonormal(rng, dims, rank)):
        arrays[f"bytes_f{k}"] = f
    shape, rank, steps = FEEDBACK
    arrays["fb_g"] = rng.standard_normal((steps, WORLD) + shape).astype(np.float32)
    for k, f in enumerate(_orthonormal(rng, shape + (1,), rank)):
        arrays[f"fb_f{k}"] = f
    np.savez(path, **arrays)


def _factors(data, name):
    return [data[f"{name}_f{k}"] for k in range(3)]


# --------------------------------------------------------------------------
# The worker: one rank of the gloo group
# --------------------------------------------------------------------------

def worker(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.distributed.compression import (
        CompressionState,
        compressed_gradient,
        cp_compressed_mean,
    )
    from repro_torch.distributed.mesh import world_group

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    data = np.load(inputs)
    meta: dict = {}
    arrays: dict = {}

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    try:
        group = world_group()
        meta["group"] = {"ranks": list(group.ranks), "me": group.me, "backend": group.backend}
        dims, r, sweeps = MEAN
        recon, _ = cp_compressed_mean(tensor(data["mean_g"][rank]), group, r, sweeps,
                                      factors=[tensor(f) for f in _factors(data, "mean")])
        arrays["mean"] = recon.numpy()
        meta["mean_digest"] = hashlib.sha256(recon.numpy().tobytes()).hexdigest()

        # every all-reduce operand, as the compressor hands it over
        operands = []
        plain = collectives.all_reduce

        def recording(x, grp):
            operands.append(x.numel() * x.element_size())
            return plain(x, grp)

        collectives.all_reduce = recording
        try:
            dims, r, sweeps = BYTES
            before = collectives.COUNTER.snapshot()
            cp_compressed_mean(tensor(data["bytes_g"][rank]), group, r, sweeps,
                               factors=[tensor(f) for f in _factors(data, "bytes")])
            by_kind = collectives.COUNTER.delta(before)
        finally:
            collectives.all_reduce = plain
        meta["bytes"] = {"operands": operands, "by_kind": by_kind}

        shape, r, steps = FEEDBACK
        state = CompressionState(torch.zeros(shape + (1,)),
                                 [tensor(f) for f in _factors(data, "fb")])
        for s in range(steps):
            g = tensor(data["fb_g"][s, rank])
            approx, new = compressed_gradient(g, state, group)
            arrays[f"fb{s}"] = approx.numpy()
            arrays[f"fb{s}_residual"] = new.residual.numpy()
            # error feedback: the residual is what this step's compression
            # left of the gradient plus the residual carried in
            meta[f"fb{s}_feedback_err"] = float(
                ((g.reshape(shape + (1,)) + state.residual - approx.reshape(shape + (1,)))
                 - new.residual).abs().max())
            state = new
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)


def spawn_group(tmp: str, world: int = WORLD) -> list[subprocess.Popen]:
    env = {**os.environ, "PYTHONPATH": SRC, "GLOO_SOCKET_IFNAME": os.environ.get(
        "GLOO_SOCKET_IFNAME", "lo"), "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(r), str(world),
         os.path.join(tmp, "store"), os.path.join(tmp, "inputs.npz"), tmp], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]


# --------------------------------------------------------------------------
# The reference: the same calls under shard_map on a 4-device dp mesh
# --------------------------------------------------------------------------

def reference(inputs: str, out: str) -> None:
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={WORLD} "
                               + os.environ.get("XLA_FLAGS", ""))
    sys.path.insert(0, SRC)
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh, shard_map
    from repro.distributed.compression import (
        CompressionState,
        compressed_gradient,
        cp_compressed_mean,
    )

    data = np.load(inputs)
    mesh = make_mesh((WORLD,), ("dp",))
    spec = P("dp", None, None, None)

    def run(body, stacked):
        return np.asarray(jax.jit(shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec,
                                            check_rep=False))(jnp.asarray(stacked)))

    got = {}
    dims, r, sweeps = MEAN
    fs = [jnp.asarray(f) for f in _factors(data, "mean")]
    got["mean"] = run(lambda g: cp_compressed_mean(g.reshape(dims), ("dp",), r, sweeps,
                                                   factors=fs)[0][None], data["mean_g"])

    shape, r, steps = FEEDBACK
    fs = [jnp.asarray(f) for f in _factors(data, "fb")]
    stacked = np.stack([data["fb_g"][:, i].reshape((steps,) + shape + (1,))
                        for i in range(WORLD)])  # (WORLD, steps, *shape, 1)

    def feedback(g):  # g: (1, steps, *shape, 1) -> (1, 2 steps, *shape, 1)
        state = CompressionState(jnp.zeros(shape + (1,)), list(fs))
        outs = []
        for s in range(steps):
            approx, state = compressed_gradient(g[0, s].reshape(shape), state, ("dp",))
            outs += [approx.reshape(shape + (1,)), state.residual]
        return jnp.stack(outs)[None]

    fb = np.asarray(jax.jit(shard_map(feedback, mesh=mesh, in_specs=P("dp"),
                                      out_specs=P("dp"), check_rep=False))(
        jnp.asarray(stacked)))
    for i in range(WORLD):
        for s in range(steps):
            got[f"fb{s}_{i}"] = fb[i, 2 * s].reshape(shape)
            got[f"fb{s}_residual_{i}"] = fb[i, 2 * s + 1]
    np.savez(out, **got)


# --------------------------------------------------------------------------
# The tests
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("compression"))
    inputs = os.path.join(tmp, "inputs.npz")
    make_inputs(inputs)
    ref = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "reference", inputs,
         os.path.join(tmp, "ref.npz")],
        env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    wait_all(spawn_group(tmp) + [ref])
    ranks = [(json.load(open(os.path.join(tmp, f"rank{r}.json"))),
              dict(np.load(os.path.join(tmp, f"rank{r}.npz")))) for r in range(WORLD)]
    return {"data": dict(np.load(inputs)), "ref": dict(np.load(os.path.join(tmp, "ref.npz"))),
            "ranks": ranks}


def _close(got, want, tol=1e-5):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), err


def test_world_group_is_the_whole_group(run):
    for r, (meta, _) in enumerate(run["ranks"]):
        assert meta["group"] == {"ranks": list(range(WORLD)), "me": r, "backend": "gloo"}


def test_compressed_mean_matches_reference(run):
    for i, (_, arrays) in enumerate(run["ranks"]):
        _close(arrays["mean"], run["ref"]["mean"][i])


def test_compressed_mean_is_the_same_on_every_rank(run):
    digests = {meta["mean_digest"] for meta, _ in run["ranks"]}
    assert len(digests) == 1


def test_compressed_mean_approximates_the_true_mean(run):
    g_mean = run["data"]["mean_g"].astype(np.float64).mean(axis=0)
    got = run["ranks"][0][1]["mean"]
    assert np.linalg.norm(got - g_mean) / np.linalg.norm(g_mean) < 0.05


def test_only_factor_sized_data_is_all_reduced(run):
    dims, rank, sweeps = BYTES
    full = int(np.prod(dims)) * 4
    for meta, _ in run["ranks"]:
        b = meta["bytes"]
        assert sum(b["operands"]) == sweeps * sum(dims) * rank * 4
        assert len(b["operands"]) == sweeps * len(dims)
        assert max(b["operands"]) < full
        assert set(b["by_kind"]) == {"all-reduce"}
        assert b["by_kind"]["all-reduce"]["operand_bytes"] == sweeps * sum(dims) * rank * 4


@pytest.mark.parametrize("step", range(FEEDBACK[2]))
def test_compressed_gradient_error_feedback_matches_reference(run, step):
    for i, (meta, arrays) in enumerate(run["ranks"]):
        _close(arrays[f"fb{step}"], run["ref"][f"fb{step}_{i}"])
        _close(arrays[f"fb{step}_residual"], run["ref"][f"fb{step}_residual_{i}"])
        assert meta[f"fb{step}_feedback_err"] <= 1e-6


@pytest.mark.parametrize("shape", [(7,), (4096, 14336), (8, 6, 5), (8, 6, 5, 4), (3, 2, 2, 2, 2)])
def test_pick_3way_shape_and_ratio_match_reference(shape):
    from repro.distributed import compression as ref

    from repro_torch.distributed import compression

    assert compression.pick_3way_shape(shape) == ref.pick_3way_shape(shape)
    for rank, sweeps in ((1, 1), (8, 1), (6, 25)):
        assert compression.compression_ratio(shape, rank, sweeps) == \
            ref.compression_ratio(shape, rank, sweeps)


def test_ratio_of_the_mlp_gradient():
    from repro_torch.distributed.compression import compression_ratio

    assert round(compression_ratio((4096, 14336), 8, 1), 1) == 398.2


def test_init_factors_are_orthonormal_and_seeded():
    import torch

    from repro_torch.distributed.compression import init_compression_state, init_factors

    def draw():
        return init_factors(torch.Generator().manual_seed(3), (12, 9, 1), 4)

    a, b = draw(), draw()
    for fa, fb in zip(a, b):
        assert torch.equal(fa, fb)
    for f in a[:2]:
        assert torch.allclose(f.T @ f, torch.eye(4), atol=1e-5)
    assert torch.allclose(torch.linalg.vector_norm(a[2], dim=0), torch.ones(4))
    state = init_compression_state(torch.Generator().manual_seed(3), (12, 9), 4)
    assert state.residual.shape == (12, 9, 1) and not state.residual.any()


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
    elif sys.argv[1] == "reference":
        reference(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(f"unknown role {sys.argv[1]!r}")
