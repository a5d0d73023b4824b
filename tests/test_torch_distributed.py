"""The port's distributed path against the reference: Algorithms 3 and 4,
the stationary CP-ALS sweep (``overlap`` none and ring), the counted
collective bytes against Eq (12)/(16) and the sweep model, the sweep's
event and histogram, and the mesh's refusals.

One gloo group of 4 ranks (``torch.distributed`` over a ``FileStore`` in
``tmp_path``) runs every check once for the module; each rank writes its
blocks and readings, which the tests assemble and hold against the
reference. The reference's ``mttkrp_stationary``/``mttkrp_general`` run in
a subprocess with 8 host devices (``XLA_FLAGS``), as ``tests/dist_worker.py``
does; the reference's sequential ``cp_als`` runs here. Tolerances:
Alg 3/4 outputs 1e-5 of the largest magnitude; CP fits 1e-5 a step and
factors 1e-4 (``_torch_parity``); bytes exactly.

Run as a script, this file is the worker (``worker``) or the reference
(``reference``); nothing here imports JAX at module level, so the card's
test (``tests/test_torch_cuda.py``) spawns the same worker on a machine
without it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 4
TIMEOUT = 150

#: Alg 3 cases: (name, input, grid); Alg 4: (name, input, p0, grid).
ALG3 = [("alg3-2x2x1", "a3", (2, 2, 1)), ("alg3-4x1x1", "a3", (4, 1, 1)),
        ("alg3-1x1x2x2", "a4w", (1, 1, 2, 2))]
ALG4 = [("alg4-p2-2x1x1", "a3", 2, (2, 1, 1)), ("alg4-p2-1x2x1", "a3", 2, (1, 2, 1))]
CP_ITERS = 5
CP_RANK = 4


def make_inputs(path: str) -> None:
    """Every input of the module, as numpy from one seed."""
    rng = np.random.default_rng(22)
    arrays = {}
    for name, dims, rank in (("a3", (8, 16, 24), 8), ("a4w", (4, 8, 12, 8), 4),
                             ("nm", (16, 16, 16), 4)):
        arrays[f"{name}_x"] = rng.standard_normal(dims, dtype=np.float32)
        for k, d in enumerate(dims):
            arrays[f"{name}_f{k}"] = rng.standard_normal((d, rank), dtype=np.float32)
    dims = (8, 12, 16)
    true = [rng.standard_normal((d, CP_RANK), dtype=np.float32) for d in dims]
    x = np.einsum("az,bz,cz->abc", *true).astype(np.float32)
    x += 0.05 * rng.standard_normal(dims, dtype=np.float32)
    arrays["cp_x"] = x
    for k, d in enumerate(dims):
        arrays[f"cp_f{k}"] = rng.standard_normal((d, CP_RANK), dtype=np.float32)
    np.savez(path, **arrays)


def _factors(data, name):
    x = data[f"{name}_x"]
    return x, [data[f"{name}_f{k}"] for k in range(x.ndim)]


# --------------------------------------------------------------------------
# The worker: one rank of the gloo group
# --------------------------------------------------------------------------

def _out_rows(mesh, n_rows, n_cols, mode, rank_axis):
    """The rows and columns of B^(mode) this rank holds (``output_block``)."""
    from repro_torch.distributed.mesh import RANK_AXIS, row_sharding_axes

    axes = row_sharding_axes(mesh.ndim, mode)
    parts = math.prod(mesh.layout.shape[mesh.layout.names.index(a)] for a in axes)
    rows = n_rows // parts * mesh.linear(axes)
    cols = (n_cols // mesh.p0 * mesh.coord(RANK_AXIS), n_cols // mesh.p0) if rank_axis \
        else (0, n_cols)
    return [rows, rows + n_rows // parts], [cols[0], cols[0] + cols[1]]


def worker(rank: int, world: int, store: str, inputs: str, out: str, device: str,
           cases: str) -> None:
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    import repro_torch
    from repro_torch.distributed import collectives
    from repro_torch.distributed.mesh import make_grid_mesh
    from repro_torch.distributed.mttkrp_parallel import (
        mttkrp_general,
        mttkrp_stationary,
        place_inputs,
    )
    from repro_torch.distributed.ring import ring_all_gather, ring_reduce_scatter
    from repro_torch.observe import collect
    from repro_torch.observe.metrics import SWEEP_COLLECTIVE_BYTES, registry

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    data = np.load(inputs)
    meta: dict = {}
    arrays: dict = {}

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def run_alg(name, key, grid, p0, backend):
        x, fs = _factors(data, key)
        ctx = repro_torch.ExecutionContext.create(backend, device=device)
        mesh = make_grid_mesh(grid, p0=p0, dims=x.shape, rank=fs[0].shape[1], device=device)
        for mode in range(x.ndim):
            xs, fl = place_inputs(mesh, tensor(x), [tensor(f) for f in fs], mode,
                                  rank_axis=p0 > 1)
            fn = (mttkrp_general if p0 > 1 else mttkrp_stationary)(mesh, mode, x.ndim, ctx=ctx)
            before = collectives.COUNTER.snapshot()
            b = fn(xs, *fl)
            by_kind = collectives.COUNTER.delta(before)
            rows, cols = _out_rows(mesh, x.shape[mode], fs[0].shape[1], mode, p0 > 1)
            arrays[f"{name}-m{mode}"] = b.cpu().numpy()
            meta[f"{name}-m{mode}"] = {
                "rows": rows, "cols": cols, "bytes": collectives.ring_total(by_kind),
                "by_kind": by_kind, "local_x_bytes": xs.numel() * xs.element_size()}

    def run_cp(name, backend, overlap, iters=CP_ITERS):
        x, init = _factors(data, "cp")
        ctx = repro_torch.ExecutionContext.create(backend, device=device, distributed=True,
                                                  overlap=overlap, observe=True)
        sink: list = []
        hist0 = len(registry().histogram(SWEEP_COLLECTIVE_BYTES))
        collect.SINKS.append(sink)
        try:
            with repro_torch.Trace() as tr:
                res = repro_torch.cp_als(tensor(x), CP_RANK, iters,
                                         init_factors=[tensor(f) for f in init], ctx=ctx)
        finally:
            collect.detach(sink)
        events = [e for e in tr.events if e["kind"] == "cp_sweep_collectives"]
        launches: dict = {}
        for launch in sink:
            launches[launch.name] = launches.get(launch.name, 0) + 1
        for k, f in enumerate(res.factors):
            arrays[f"{name}-f{k}"] = f.cpu().numpy()
        arrays[f"{name}-w"] = res.weights.cpu().numpy()
        meta[name] = {"fits": res.fits, "events": events, "launches": launches,
                      "sweep_bytes": list(registry().histogram(SWEEP_COLLECTIVE_BYTES)[hist0:]),
                      "grid": events[0]["grid"] if events else None}

    try:
        if "alg" in cases:
            for name, key, grid in ALG3:
                run_alg(name, key, grid, 1, "cuda" if len(grid) == 4 else "einsum")
            for name, key, p0, grid in ALG4:
                run_alg(name, key, grid, p0, "einsum")
            run_alg("nm-2x2x1", "nm", (2, 2, 1), 1, "einsum")
            # the rings against the monolithic collectives on every group
            mesh = make_grid_mesh((1, 2, 2), device=device)
            for axes, group in mesh.groups.items():
                x = torch.arange(12.0, device=device).reshape(4, 3) * (rank + 1) + rank
                got = {}
                for name, fn in (("ag", collectives.all_gather), ("rag", ring_all_gather),
                                 ("rs", collectives.reduce_scatter),
                                 ("rrs", ring_reduce_scatter)):
                    before = collectives.COUNTER.snapshot()
                    got[name] = fn(x, group).cpu().numpy()
                    got[name + "_bytes"] = collectives.ring_total(
                        collectives.COUNTER.delta(before))
                meta["ring-" + "".join(axes)] = {
                    "size": group.size, "ag_equal": bool(np.array_equal(got["ag"], got["rag"])),
                    "rs_close": bool(np.allclose(got["rs"], got["rrs"], rtol=1e-6)),
                    "bytes": [got[k] for k in ("ag_bytes", "rag_bytes", "rs_bytes",
                                               "rrs_bytes")]}
            for grid, p0 in (((2, 1, 1), 1), ((2, 2, 2), 1), ((2, 2, 1), 2)):
                try:
                    make_grid_mesh(grid, p0=p0, device=device)
                    meta[f"refused-{grid}-{p0}"] = None
                except ValueError as e:
                    meta[f"refused-{grid}-{p0}"] = str(e)
        if "cp" in cases:
            run_cp("cp-none", "einsum", "none")
            run_cp("cp-ring", "einsum", "ring")
            run_cp("cp-cuda", "cuda", "none")
        if "card" in cases:  # two ranks on one card (tests/test_torch_cuda.py)
            run_alg("card-alg3-2x1x1", "a3", (2, 1, 1), 1, "cuda")
            run_cp("card-cp", "cuda", "none", iters=1)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)


def spawn_group(tmp: str, device: str = "cpu", world: int = WORLD,
                cases: str = "alg,cp") -> list[subprocess.Popen]:
    """Start ``world`` worker processes on one fresh ``FileStore``."""
    inputs = os.path.join(tmp, "inputs.npz")
    if not os.path.exists(inputs):
        make_inputs(inputs)
    store = os.path.join(tmp, "store")
    env = {**os.environ, "PYTHONPATH": SRC, "GLOO_SOCKET_IFNAME": os.environ.get(
        "GLOO_SOCKET_IFNAME", "lo"), "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(r), str(world), store, inputs,
         tmp, device, cases], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def wait_all(procs, timeout: float = TIMEOUT) -> None:
    """Wait for every process under one time limit; kill them all and
    raise with their output if any fails or overruns."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    bad = [(i, p.returncode, o) for i, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        raise AssertionError("\n".join(f"process {i} rc={rc}:\n{o[-3000:]}" for i, rc, o in bad))


# --------------------------------------------------------------------------
# The reference: Alg 3/4 on 8 host devices
# --------------------------------------------------------------------------

def reference(inputs: str, out: str) -> None:
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    sys.path.insert(0, SRC)
    import jax.numpy as jnp

    from repro.distributed import (
        make_grid_mesh,
        mttkrp_general,
        mttkrp_stationary,
        place_inputs,
    )

    data = np.load(inputs)
    got = {}
    cases = [(n, k, 1, g) for n, k, g in ALG3] + ALG4
    for name, key, p0, grid in cases:
        x, fs = _factors(data, key)
        mesh = make_grid_mesh(grid, p0=p0)
        for mode in range(x.ndim):
            xs, fl = place_inputs(mesh, jnp.asarray(x), [jnp.asarray(f) for f in fs], mode,
                                  rank_axis=p0 > 1)
            fn = (mttkrp_general if p0 > 1 else mttkrp_stationary)(mesh, mode, x.ndim)
            got[f"{name}-m{mode}"] = np.asarray(fn(xs, *fl))
    np.savez(out, **got)


# --------------------------------------------------------------------------
# The tests
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist"))
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


def _assemble(run, key, shape):
    """The global output from the ranks' blocks; every entry written by
    exactly the ranks that hold it (Alg 3/4 output blocks are disjoint)."""
    full = np.zeros(shape, np.float32)
    hits = np.zeros(shape, np.int64)
    for meta, arrays in run["ranks"]:
        (r0, r1), (c0, c1) = meta[key]["rows"], meta[key]["cols"]
        full[r0:r1, c0:c1] = arrays[key]
        hits[r0:r1, c0:c1] += 1
    assert (hits == 1).all(), f"{key}: output blocks overlap or leave gaps"
    return full


def _close(got, want, tol=1e-5):
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * max(float(np.abs(want).max()), 1.0)


@pytest.mark.parametrize("name,key,grid", ALG3, ids=[c[0] for c in ALG3])
def test_alg3_matches_reference_and_eq12(run, name, key, grid):
    from repro_torch.core.bounds import par_stationary_cost

    x, fs = _factors(run["data"], key)
    rank = fs[0].shape[1]
    for mode in range(x.ndim):
        k = f"{name}-m{mode}"
        _close(_assemble(run, k, (x.shape[mode], rank)), run["ref"][k])
        want = par_stationary_cost(x.shape, rank, grid, mode) * 4
        assert all(meta[k]["bytes"] == want for meta, _ in run["ranks"]), (k, want)


@pytest.mark.parametrize("name,key,p0,grid", ALG4, ids=[c[0] for c in ALG4])
def test_alg4_matches_reference_and_eq16(run, name, key, p0, grid):
    from repro_torch.core.bounds import par_general_cost

    x, fs = _factors(run["data"], key)
    rank = fs[0].shape[1]
    for mode in range(x.ndim):
        k = f"{name}-m{mode}"
        _close(_assemble(run, k, (x.shape[mode], rank)), run["ref"][k])
        want = par_general_cost(x.shape, rank, grid, p0, mode) * 4
        assert all(meta[k]["bytes"] == want for meta, _ in run["ranks"]), (k, want)
        # the tensor's rank-axis all-gather is one of the counted collectives
        assert all(meta[k]["by_kind"]["all-gather"]["count"] >= 1 for meta, _ in run["ranks"])


def test_stationary_tensor_never_moves(run):
    """Alg 3's defining property: every collective moves factor-sized data;
    all of them together move less than one rank's block of X."""
    x, fs = _factors(run["data"], "nm")
    for mode in range(3):
        for meta, _ in run["ranks"]:
            m = meta[f"nm-2x2x1-m{mode}"]
            total = sum(d["operand_bytes"] for d in m["by_kind"].values())
            assert 0 < total < m["local_x_bytes"]
            assert set(m["by_kind"]) <= {"all-gather", "reduce-scatter"}


def test_ring_collectives_equal_the_monolithic_ones(run):
    """``ring_all_gather`` / ``ring_reduce_scatter`` on every group of a
    (1, 2, 2) mesh (groups of 1, 2 and 4): the all-gather bit for bit, the reduce-scatter to fp32
    rounding, each with the monolithic collective's ring bytes."""
    for meta, _ in run["ranks"]:
        rings = {k: v for k, v in meta.items() if k.startswith("ring-")}
        assert {v["size"] for v in rings.values()} == {1, 2, 4}
        for v in rings.values():
            assert v["ag_equal"] and v["rs_close"]
            ag, rag, rs, rrs = v["bytes"]
            q = v["size"]
            assert ag == rag == (q - 1) * 48 and rs == rrs == (q - 1) * 48 // q


def test_world_size_must_equal_the_grid(run):
    meta = run["ranks"][0][0]
    assert "spans 2 ranks but the default group has 4" in meta["refused-(2, 1, 1)-1"]
    assert "needs 8 processes but the default group has 4" in meta["refused-(2, 2, 2)-1"]
    assert "needs 8 processes" in meta["refused-(2, 2, 1)-2"]


def _reference_cp(run):
    import jax.numpy as jnp

    import repro

    x, init = _factors(run["data"], "cp")
    return repro.cp_als(jnp.asarray(x), CP_RANK, CP_ITERS,
                        init_factors=[jnp.asarray(f) for f in init])


@pytest.mark.parametrize("name", ["cp-none", "cp-ring", "cp-cuda"])
def test_cp_sweep_matches_sequential_reference(run, name):
    ref = _reference_cp(run)
    for meta, arrays in run["ranks"]:
        np.testing.assert_allclose(meta[name]["fits"], np.asarray(ref.fits), rtol=0, atol=1e-5)
        for k in range(3):
            _close(arrays[f"{name}-f{k}"], np.asarray(ref.factors[k]), 1e-4)
        _close(arrays[f"{name}-w"], np.asarray(ref.weights), 1e-4)
    # every rank returns the same gathered result
    first = run["ranks"][0][1]
    for _, arrays in run["ranks"][1:]:
        for k in range(3):
            np.testing.assert_array_equal(arrays[f"{name}-f{k}"], first[f"{name}-f{k}"])


@pytest.mark.parametrize("name", ["cp-none", "cp-ring"])
def test_cp_sweep_bytes_equal_the_model(run, name):
    from repro_torch.distributed.grid_select import choose_cp_grid, stationary_sweep_words

    x, _ = _factors(run["data"], "cp")
    grid = choose_cp_grid(x.shape, CP_RANK, WORLD).grid
    fit_term = int(2 * (WORLD - 1) / WORLD * 4)
    want = stationary_sweep_words(x.shape, CP_RANK, grid) * 4 + fit_term
    for meta, _ in run["ranks"]:
        assert tuple(meta[name]["grid"]) == grid
        assert meta[name]["sweep_bytes"] == [want] * CP_ITERS
        (event,) = meta[name]["events"]
        assert event["measured_collective_bytes"] == want
        assert event["modeled_bytes"] + event["fit_allreduce_bytes"] == want
        kinds = set(event["collectives_by_kind"])
        assert kinds == ({"collective-permute", "all-reduce"} if name == "cp-ring"
                         else {"all-gather", "reduce-scatter", "all-reduce"})


def test_cp_sweep_event_carries_the_reference_fields(run):
    (event,) = run["ranks"][0][0]["cp-none"]["events"]
    for f in ("shape", "rank", "grid", "procs", "itemsize", "overlap",
              "measured_collective_bytes", "modeled_words", "modeled_bytes",
              "fit_allreduce_bytes", "collectives_by_kind"):
        assert f in event
    assert event["transport"] == "gloo" and event["procs"] == WORLD
    assert event["overlap"] == "none" and event["shape"] == [8, 12, 16]


def test_cuda_backend_on_cpu_reports_the_card_launches(run):
    """The ``cuda`` local backend on CPU tensors reports the launches the
    card would make: three ``mttkrp3`` a rank an iteration."""
    for meta, _ in run["ranks"]:
        assert meta["cp-cuda"]["launches"]["mttkrp3"] == 3 * CP_ITERS
        assert meta["cp-none"]["launches"] == {}


def test_audit_records_measured_collective_bytes():
    """The audit row's event carries ``measured_collective_bytes``, as the
    reference's does: the collective counter's reading over the call, 0
    on one device."""
    import torch

    import repro_torch
    from repro_torch.observe import audit_mttkrp

    ctx = repro_torch.ExecutionContext.create("einsum", device="cpu")
    x = torch.ones(6, 5, 4)
    with repro_torch.Trace() as tr:
        audit_mttkrp(x, [torch.ones(d, 3) for d in x.shape], 0, ctx=ctx)
    (event,) = [e for e in tr.events if e["kind"] == "bounds_audit"]
    assert event["measured_collective_bytes"] == 0.0


@pytest.mark.parametrize("kw,match", [
    ({"sweep": "fused"}, "not supported on the distributed path"),
    ({"sweep": "dimtree"}, "not supported on the distributed path"),
    ({"mttkrp_fn": lambda x, fs, m: None}, "mttkrp_fn cannot be combined"),
    ({"use_dimension_tree": True}, "use_dimension_tree is not supported"),
])
def test_cp_als_refuses_on_a_distributed_context(kw, match):
    import jax.numpy as jnp
    import torch

    import repro
    import repro_torch

    x = torch.ones(4, 4, 4)
    ctx = repro_torch.ExecutionContext.create("einsum", device="cpu", distributed=True)
    with pytest.raises(ValueError, match=match) as port:
        repro_torch.cp_als(x, 2, 1, ctx=ctx, **kw)
    with pytest.raises(ValueError) as ref:
        repro.cp_als(jnp.ones((4, 4, 4)), 2, 1, ctx=repro.ExecutionContext.create(
            distributed=True), **kw)
    assert str(port.value) == str(ref.value)


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6],
               sys.argv[7], sys.argv[8])
    elif sys.argv[1] == "reference":
        reference(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(f"unknown role {sys.argv[1]!r}")
