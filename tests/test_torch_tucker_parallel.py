"""The port's distributed Tucker path against the reference: the
stationary full-core Multi-TTM, the HOOI sweep (``overlap`` none and ring)
behind ``repro_torch.tucker_hooi`` on a distributed context, its counted
collective bytes against ``par_multi_ttm_cost`` and
``multi_ttm_sweep_words``, its event and histogram, and its refusals.

One gloo group of 4 ranks (``torch.distributed`` over a ``FileStore`` in
``tmp_path``) runs every case once for the module; each rank writes its
results and readings, which the tests hold against the reference. The
reference's ``multi_ttm_stationary`` runs in a subprocess with 8 host
devices (``XLA_FLAGS``), as ``tests/dist_worker.py`` does; the reference's
own distributed sweep stops at shard_map's ``check_vma`` on this jax, so
the sweep is held against the reference's sequential ``tucker_hooi`` from
the same HOSVD factors, and its bytes against the models. Tolerances:
Multi-TTM 1e-5 of the largest magnitude; fits 1e-4; factors and core 1e-3
(the reference's own limits for its distributed sweep); bytes exactly.

Run as a script, this file is the worker (``worker``) or the reference
(``reference``).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_distributed import SRC, wait_all

WORLD = 4
SWEEPS = 5
MT_DIMS, MT_RANKS = (16, 16, 16), (4, 3, 2)
MT_GRIDS = ((2, 2, 1), (1, 2, 2))
#: HOOI problems: (name, dims, ranks).
TUCKER = [("t3", (16, 16, 16), (4, 3, 2)), ("t4", (8, 12, 8, 4), (3, 2, 3, 2))]
#: HOOI runs: (name, problem, backend, overlap, explicit grid).
RUNS = [("t3-none", "t3", "einsum", "none", None), ("t3-ring", "t3", "einsum", "ring", None),
        ("t4-none", "t4", "einsum", "none", None), ("t4-ring", "t4", "einsum", "ring", None),
        ("t3-grid411", "t3", "einsum", "none", (4, 1, 1)),
        ("t3-cuda", "t3", "cuda", "none", None)]


def _hosvd(x: np.ndarray, ranks) -> list[np.ndarray]:
    """HOSVD factors in float64 numpy, signs fixed as the drivers fix them
    (largest-magnitude entry of each column positive), cast to float32."""
    out = []
    for k, r in enumerate(ranks):
        xm = np.moveaxis(x, k, 0).reshape(x.shape[k], -1).astype(np.float64)
        _, v = np.linalg.eigh(xm @ xm.T)
        v = v[:, ::-1][:, :r]
        idx = np.argmax(np.abs(v), axis=0)
        v = v * np.where(np.sign(v[idx, np.arange(r)]) == 0, 1, np.sign(v[idx, np.arange(r)]))
        out.append(np.ascontiguousarray(v, dtype=np.float32))
    return out


def make_inputs(path: str) -> None:
    """Every input of the module, as numpy from one seed: the Multi-TTM
    problem, and each HOOI problem (a multilinear-rank tensor plus 5 %
    noise) with its HOSVD factors."""
    rng = np.random.default_rng(23)
    arrays = {"mt_x": rng.standard_normal(MT_DIMS, dtype=np.float32)}
    for k, (d, r) in enumerate(zip(MT_DIMS, MT_RANKS)):
        arrays[f"mt_m{k}"] = rng.standard_normal((d, r), dtype=np.float32)
    for name, dims, ranks in TUCKER:
        x = rng.standard_normal(ranks)
        for k, (d, r) in enumerate(zip(dims, ranks)):
            q, _ = np.linalg.qr(rng.standard_normal((d, r)))
            x = np.moveaxis(np.tensordot(x, q, axes=([k], [1])), -1, k)
        x = x + 0.05 * x.std() * rng.standard_normal(dims)
        arrays[f"{name}_x"] = x.astype(np.float32)
        for k, f in enumerate(_hosvd(arrays[f"{name}_x"], ranks)):
            arrays[f"{name}_f{k}"] = f
    np.savez(path, **arrays)


def _problem(data, name):
    x = data[f"{name}_x"]
    return x, [data[f"{name}_f{k}"] for k in range(x.ndim)]


def _digest(t) -> str:
    return hashlib.sha256(np.ascontiguousarray(t.cpu().numpy()).tobytes()).hexdigest()


# --------------------------------------------------------------------------
# The worker: one rank of the gloo group
# --------------------------------------------------------------------------

def worker(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    import repro_torch
    from repro_torch.distributed import collectives
    from repro_torch.distributed.mesh import make_grid_mesh
    from repro_torch.distributed.tucker_parallel import (
        multi_ttm_stationary,
        place_multi_ttm_inputs,
        tucker_hooi_parallel,
    )
    from repro_torch.observe import collect
    from repro_torch.observe.metrics import SWEEP_COLLECTIVE_BYTES, registry

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    data = np.load(inputs)
    meta: dict = {}
    arrays: dict = {}

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    try:
        x = data["mt_x"]
        mats = [data[f"mt_m{k}"] for k in range(3)]
        ctx = repro_torch.ExecutionContext.create("einsum", device="cpu")
        for grid in MT_GRIDS:
            mesh = make_grid_mesh(grid, device="cpu")
            xs, ms = place_multi_ttm_inputs(mesh, tensor(x), [tensor(m) for m in mats])
            before = collectives.COUNTER.snapshot()
            core = multi_ttm_stationary(mesh, 3, ctx=ctx)(xs, *ms)
            by_kind = collectives.COUNTER.delta(before)
            key = "mt-" + "x".join(map(str, grid))
            arrays[key] = core.numpy()
            meta[key] = {"bytes": collectives.ring_total(by_kind), "by_kind": by_kind}

        for name, prob, backend, overlap, grid in RUNS:
            x, init = _problem(data, prob)
            ranks = next(r for n, _, r in TUCKER if n == prob)
            ctx = repro_torch.ExecutionContext.create(backend, device="cpu", distributed=True,
                                                      overlap=overlap, observe=True, grid=grid)
            sink: list = []
            hist0 = len(registry().histogram(SWEEP_COLLECTIVE_BYTES))
            collect.SINKS.append(sink)
            try:
                with repro_torch.Trace() as tr:
                    res = repro_torch.tucker_hooi(tensor(x), ranks, SWEEPS,
                                                  init_factors=[tensor(f) for f in init], ctx=ctx)
            finally:
                collect.detach(sink)
            launches: dict = {}
            for launch in sink:
                launches[launch.name] = launches.get(launch.name, 0) + 1
            for k, f in enumerate(res.factors):
                arrays[f"{name}-f{k}"] = f.numpy()
            arrays[f"{name}-core"] = res.core.numpy()
            events = [e for e in tr.events if e["kind"] == "tucker_sweep_collectives"]
            meta[name] = {
                "fits": res.fits, "events": events, "launches": launches,
                "sweep_bytes": list(registry().histogram(SWEEP_COLLECTIVE_BYTES)[hist0:]),
                "digest": [_digest(f) for f in res.factors] + [_digest(res.core)]}

        # n_iters=0: the HOSVD projection, no sweep and no collective
        x, init = _problem(data, "t3")
        ctx = repro_torch.ExecutionContext.create("einsum", device="cpu", distributed=True)
        before = collectives.COUNTER.snapshot()
        res = repro_torch.tucker_hooi(tensor(x), (4, 3, 2), 0,
                                      init_factors=[tensor(f) for f in init], ctx=ctx)
        arrays["hosvd-core"] = res.core.numpy()
        meta["hosvd"] = {"fits": res.fits,
                         "bytes": collectives.ring_total(collectives.COUNTER.delta(before))}

        # a rank-axis mesh is refused
        mesh = make_grid_mesh((2, 1, 1), p0=2, device="cpu")
        try:
            tucker_hooi_parallel(tensor(x), (4, 3, 2), 1, mesh=mesh, ctx=ctx)
            meta["refused-mesh"] = None
        except ValueError as e:
            meta["refused-mesh"] = str(e)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)


def spawn_group(tmp: str, world: int = WORLD) -> list[subprocess.Popen]:
    inputs = os.path.join(tmp, "inputs.npz")
    store = os.path.join(tmp, "store")
    env = {**os.environ, "PYTHONPATH": SRC, "GLOO_SOCKET_IFNAME": os.environ.get(
        "GLOO_SOCKET_IFNAME", "lo"), "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(r), str(world), store, inputs,
         tmp], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


# --------------------------------------------------------------------------
# The reference: multi_ttm_stationary on 8 host devices
# --------------------------------------------------------------------------

def reference(inputs: str, out: str) -> None:
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    sys.path.insert(0, SRC)
    import jax.numpy as jnp

    from repro.distributed import make_grid_mesh, multi_ttm_stationary, place_multi_ttm_inputs

    data = np.load(inputs)
    x = jnp.asarray(data["mt_x"])
    mats = [jnp.asarray(data[f"mt_m{k}"]) for k in range(3)]
    got = {}
    for grid in MT_GRIDS:
        mesh = make_grid_mesh(grid)
        xs, ms = place_multi_ttm_inputs(mesh, x, mats)
        got["mt-" + "x".join(map(str, grid))] = np.asarray(multi_ttm_stationary(mesh, 3)(xs, *ms))
    np.savez(out, **got)


# --------------------------------------------------------------------------
# The tests
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tucker_dist"))
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


def _close(got, want, tol):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), err


@pytest.mark.parametrize("grid", MT_GRIDS, ids=["x".join(map(str, g)) for g in MT_GRIDS])
def test_multi_ttm_stationary_matches_reference(run, grid):
    key = "mt-" + "x".join(map(str, grid))
    for _, arrays in run["ranks"]:
        _close(arrays[key], run["ref"][key], 1e-5)


@pytest.mark.parametrize("grid", MT_GRIDS, ids=["x".join(map(str, g)) for g in MT_GRIDS])
def test_multi_ttm_stationary_bytes_equal_par_multi_ttm_cost(run, grid):
    from repro_torch.core.bounds import par_multi_ttm_cost

    key = "mt-" + "x".join(map(str, grid))
    want = par_multi_ttm_cost(MT_DIMS, MT_RANKS, grid) * 4
    assert want == int(want)
    for meta, _ in run["ranks"]:
        assert meta[key]["bytes"] == int(want)
        kinds = meta[key]["by_kind"]
        assert set(kinds) == {"all-gather", "all-reduce"} and kinds["all-reduce"]["count"] == 1


def _reference_tucker(run, prob, n_iters=SWEEPS):
    import jax.numpy as jnp

    import repro

    x, init = _problem(run["data"], prob)
    ranks = next(r for n, _, r in TUCKER if n == prob)
    return repro.tucker_hooi(jnp.asarray(x), ranks, n_iters,
                             init_factors=[jnp.asarray(f) for f in init])


@pytest.mark.parametrize("name,prob", [(r[0], r[1]) for r in RUNS], ids=[r[0] for r in RUNS])
def test_hooi_sweep_matches_sequential_reference(run, name, prob):
    ref = _reference_tucker(run, prob)
    for meta, arrays in run["ranks"]:
        np.testing.assert_allclose(meta[name]["fits"], np.asarray(ref.fits), rtol=0, atol=1e-4)
        for k in range(len(ref.factors)):
            _close(arrays[f"{name}-f{k}"], np.asarray(ref.factors[k]), 1e-3)
        _close(arrays[f"{name}-core"], np.asarray(ref.core), 1e-3)


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_hooi_factors_equal_on_every_rank(run, name):
    digests = [meta[name]["digest"] for meta, _ in run["ranks"]]
    assert all(d == digests[0] for d in digests)


def _expected_sweep_bytes(dims, ranks, grid) -> int:
    """One sweep's ring bytes op by op, each truncated as the counter
    truncates it: per mode one hyperslice all-reduce and one fiber
    all-gather of the partial Y^(k) block-rows."""
    procs = math.prod(grid)
    total = 0
    for k, (d, pk) in enumerate(zip(dims, grid)):
        w_bytes = (d // pk) * math.prod(r for j, r in enumerate(ranks) if j != k) * 4
        q = procs // pk
        total += int(2 * (q - 1) / q * w_bytes) + (pk - 1) * w_bytes
    return total


@pytest.mark.parametrize("name,prob,grid", [(r[0], r[1], r[4]) for r in RUNS],
                         ids=[r[0] for r in RUNS])
def test_hooi_sweep_bytes_equal_the_model(run, name, prob, grid):
    from repro_torch.distributed.grid_select import choose_tucker_grid, multi_ttm_sweep_words

    dims, ranks = next((d, r) for n, d, r in TUCKER if n == prob)
    grid = grid or choose_tucker_grid(dims, ranks, WORLD).grid
    want = _expected_sweep_bytes(dims, ranks, grid)
    assert want == int(multi_ttm_sweep_words(dims, ranks, grid) * 4)
    for meta, _ in run["ranks"]:
        (event,) = meta[name]["events"]
        assert tuple(event["grid"]) == tuple(grid)
        assert meta[name]["sweep_bytes"] == [want] * SWEEPS
        assert event["measured_collective_bytes"] == want == event["modeled_bytes"]
        kinds = set(event["collectives_by_kind"])
        ring = name.endswith("ring")
        assert kinds <= {"all-reduce", "collective-permute" if ring else "all-gather"}
        assert "all-reduce" in kinds


def test_distributed_context_picks_choose_tucker_grid(run):
    from repro_torch.distributed.grid_select import choose_tucker_grid

    for name, dims, ranks in TUCKER:
        want = list(choose_tucker_grid(dims, ranks, WORLD).grid)
        for meta, _ in run["ranks"]:
            assert meta[f"{name}-none"]["events"][0]["grid"] == want
    assert run["ranks"][0][0]["t3-grid411"]["events"][0]["grid"] == [4, 1, 1]


def test_sweep_event_carries_the_reference_fields(run):
    (event,) = run["ranks"][0][0]["t3-ring"]["events"]
    fields = [k for k in event if k not in ("schema", "seq", "time_s", "kind")]
    ref_order = ["shape", "ranks", "grid", "procs", "itemsize", "measured_collective_bytes",
                 "modeled_words", "modeled_bytes", "collectives_by_kind"]
    assert [f for f in fields if f in ref_order] == ref_order
    assert fields[-3:] == ["transport", "overlap", "measured_by"]
    assert event["transport"] == "gloo" and event["overlap"] == "ring"
    assert event["measured_by"] == "collective_wrappers"
    assert event["procs"] == WORLD and event["itemsize"] == 4 and event["shape"] == [16, 16, 16]


def test_cuda_backend_on_cpu_reports_the_card_launches(run):
    """The ``cuda`` local backend on CPU tensors reports the launches the
    card would make: one ``multi_ttm_keep`` a mode a sweep on every rank."""
    for meta, _ in run["ranks"]:
        assert meta["t3-cuda"]["launches"] == {"multi_ttm_keep": 3 * SWEEPS}
        assert meta["t3-none"]["launches"] == {}


def test_n_iters_zero_projects_onto_the_hosvd_factors(run):
    ref = _reference_tucker(run, "t3", 0)
    for meta, arrays in run["ranks"]:
        assert meta["hosvd"]["bytes"] == 0
        np.testing.assert_allclose(meta["hosvd"]["fits"], np.asarray(ref.fits), atol=1e-4)
        _close(arrays["hosvd-core"], np.asarray(ref.core), 1e-5)


def test_rank_axis_mesh_is_refused(run):
    assert run["ranks"][0][0]["refused-mesh"] == (
        "tucker_hooi_parallel keeps X stationary; pass a p0=1 grid mesh")


@pytest.mark.parametrize("kw", [{"p0": 2, "grid": (2, 1, 1)}, {"grid": (3, 1, 1)},
                                {"grid": (2, 2)}])
def test_refusals_match_the_reference(kw):
    import jax.numpy as jnp
    import torch

    import repro
    import repro_torch

    ctx = repro_torch.ExecutionContext.create("einsum", device="cpu", distributed=True, **kw)
    with pytest.raises(ValueError) as port:
        repro_torch.tucker_hooi(torch.ones(16, 16, 16), (2, 2, 2), 1, ctx=ctx)
    with pytest.raises(ValueError) as ref:
        repro.tucker_hooi(jnp.ones((16, 16, 16)), (2, 2, 2), 1,
                          ctx=repro.ExecutionContext.create(distributed=True, **kw))
    assert str(port.value) == str(ref.value)


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
    elif sys.argv[1] == "reference":
        reference(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(f"unknown role {sys.argv[1]!r}")
