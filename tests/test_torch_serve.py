"""The port's serving layer against the reference, on the CPU (the
counterpart of ``tests/test_serve.py``): bucketing by the tune-cache key,
exact zero-padding, one batched run a bucket, the convergence mask, the
warm-start directory and the CLI.

A served request must equal the reference's served request from the
reference's own initial draws (``PRNGKey(i + 1)`` for the server's i-th
request, handed to the port through ``submit(init_factors=...)``): weights,
factors and fit within 1e-5 of their largest magnitude, the same iteration
count and convergence flag. ``tol`` is chosen so that no request's last fit
change lies within a tenth of it (no request sits on the boundary). The
port's own draws (``torch.Generator`` seeded ``i + 1``) are checked against
a direct ``cp_als`` from the same start.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core.tensor import random_factors as j_random_factors
from repro.launch import serve as jserve
from repro_torch.core.tensor import random_factors
from repro_torch.engine import batch as batch_mod
from repro_torch.engine.context import ExecutionContext
from repro_torch.kernels import build
from repro_torch.launch import serve
from repro_torch.launch.serve import (
    DecompositionServer,
    bucket_key,
    bucket_shape,
    pad_to_bucket,
)

TOL = 1e-5


def _ctx(backend="einsum", **kw):
    return ExecutionContext.create(backend, device="cpu", **kw)


def _jctx(backend="einsum", **kw):
    return repro.ExecutionContext.create(backend=backend, **kw)


def _low_rank(shape, rank, seed, noise=0.05):
    rng = np.random.default_rng(seed)
    fs = [rng.standard_normal((d, rank), dtype=np.float32) for d in shape]
    spec = ",".join(f"{'abcd'[k]}z" for k in range(len(shape))) + "->" + "abcd"[:len(shape)]
    x = np.einsum(spec, *fs).astype(np.float32)
    return x + noise * rng.standard_normal(shape, dtype=np.float32)


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,pad_to", [((7, 6, 5), 8), ((8, 3, 2), 8), ((9, 8, 17), 8),
                                          ((5, 4), 1), ((249, 256, 250), 8),
                                          ((89, 96, 90, 91), 16)])
def test_bucket_shape_equals_the_reference(shape, pad_to):
    assert bucket_shape(shape, pad_to) == jserve.bucket_shape(shape, pad_to)


def test_bucket_shape_refuses_a_zero_quantum():
    for fn in (bucket_shape, jserve.bucket_shape):
        with pytest.raises(ValueError, match="pad_to"):
            fn((4, 4), pad_to=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bucket_key_equals_the_reference_up_to_platform(dtype):
    got = bucket_key((7, 6, 5), 3, getattr(torch, dtype), device="cpu")
    want = jserve.bucket_key((7, 6, 5), 3, getattr(jnp, dtype))
    assert got.rsplit("|", 2)[0] == want.rsplit("|", 2)[0]
    assert got.startswith("serve|shape=8x8x8|rank=3|mode=0|")
    mem = repro_torch.Memory.h100_smem()
    assert bucket_key((7, 6, 5), 3, dtype, memory=mem, device="cpu") != got


def test_equal_keys_share_a_bucket():
    k1 = bucket_key((7, 6, 5), 3, torch.float32, device="cpu")
    assert bucket_key((8, 3, 2), 3, torch.float32, device="cpu") == k1
    assert bucket_key((7, 6, 5), 4, torch.float32, device="cpu") != k1
    assert bucket_key((7, 6, 5), 3, torch.float64, device="cpu") != k1
    assert bucket_key((9, 6, 5), 3, torch.float32, device="cpu") != k1
    assert bucket_key((3, 3, 3), 3, torch.float32, pad_to=4, device="cpu") != bucket_key(
        (3, 3, 3), 3, torch.float32, pad_to=8, device="cpu")


@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_one_batched_call_a_bucket(monkeypatch, backend):
    calls = []
    real = batch_mod.cp_als_batched

    def counted(xs, rank, *a, **kw):
        calls.append((tuple(xs.shape), rank))
        return real(xs, rank, *a, **kw)

    monkeypatch.setattr(batch_mod, "cp_als_batched", counted)
    srv = DecompositionServer(_ctx(backend), n_iters=3, tol=0.0)
    for i, shape in enumerate([(7, 6, 5), (8, 3, 2), (5, 5, 5)]):
        srv.submit(torch.from_numpy(_low_rank(shape, 3, i)), 3, request_id=f"r{i}")
    srv.submit(torch.from_numpy(_low_rank((7, 6, 5), 2, 9)), 2, request_id="r3")
    assert len(srv) == 4
    results = srv.flush()
    assert len(srv) == 0 and set(results) == {"r0", "r1", "r2", "r3"}
    assert sorted(calls) == [((1, 8, 8, 8), 2), ((3, 8, 8, 8), 3)]
    assert results["r0"].bucket == results["r1"].bucket == results["r2"].bucket
    assert results["r0"].batch == 3 and results["r3"].batch == 1
    assert results["r3"].bucket != results["r0"].bucket
    assert [tuple(f.shape) for f in results["r1"].factors] == [(8, 3), (3, 3), (2, 3)]
    for r in results.values():
        assert r.execute_s > 0.0 and r.queue_s >= 0.0 and r.cold
        assert r.n_iters == 3 and not r.converged


def test_submit_refuses_what_it_cannot_serve():
    srv = DecompositionServer(_ctx())
    with pytest.raises(ValueError, match=">=2-way"):
        srv.submit(torch.ones(5), 2)
    with pytest.raises(ValueError, match="init_factors"):
        srv.submit(torch.ones(4, 3), 2, init_factors=[torch.ones(4, 2), torch.ones(4, 2)])
    with pytest.raises(ValueError, match=">=2-way"):
        jserve.DecompositionServer(_jctx()).submit(jnp.ones((5,)), 2)
    with pytest.raises(ValueError, match="pad_to"):
        DecompositionServer(_ctx(), pad_to=0)


def test_observe_is_refused_by_name():
    """Refused until the observability slice; now ``observe=True`` builds,
    and an observed server records the reference's serving spans under a
    ``capture="observed"`` trace: one ``serve_bucket`` a bucket, one
    ``serve_request`` a request."""
    from repro.observe import Trace as JTrace
    from repro_torch.observe import Trace

    shapes = [(7, 6, 5), (8, 5, 6), (7, 7, 4)]
    kinds = []
    for make, trace, new in ((lambda x: torch.from_numpy(x), Trace, DecompositionServer),
                             (jnp.asarray, JTrace, jserve.DecompositionServer)):
        ctx = _ctx(observe=True) if new is DecompositionServer else _jctx(observe=True)
        srv = new(ctx, n_iters=2)
        for i, shape in enumerate(shapes):
            srv.submit(make(_low_rank(shape, 2, 40 + i)), 2, request_id=f"r{i}")
        with trace(capture="observed") as t:
            out = srv.flush()
        kinds.append(sorted(e["kind"] for e in t.events if e["kind"].startswith("serve_")))
        requests = [e for e in t.events if e["kind"] == "serve_request"]
        assert sorted(e["request_id"] for e in requests) == sorted(out)
    assert kinds[0] == kinds[1] == ["serve_bucket"] + ["serve_request"] * 3


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------

def test_pad_to_bucket_round_trips_as_the_reference():
    x = np.random.default_rng(3).standard_normal((7, 6, 5), dtype=np.float32)
    p = pad_to_bucket(torch.from_numpy(x), (8, 8, 8))
    assert tuple(p.shape) == (8, 8, 8)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jserve.pad_to_bucket(
        jnp.asarray(x), (8, 8, 8))))
    assert np.array_equal(p[:7, :6, :5].numpy(), x)
    assert float(p[7:].abs().sum() + p[:, 6:].abs().sum() + p[:, :, 5:].abs().sum()) == 0.0
    assert pad_to_bucket(p, (8, 8, 8)) is p
    with pytest.raises(ValueError, match="cannot pad"):
        pad_to_bucket(torch.from_numpy(x), (6, 6, 6))


# ---------------------------------------------------------------------------
# the served result against the reference's
# ---------------------------------------------------------------------------

def _reference_serve(requests, rank, n_iters, tol):
    """The reference's server on einsum, and the initial factors it drew."""
    srv = jserve.DecompositionServer(_jctx(), n_iters=n_iters, tol=tol)
    for rid, x in requests:
        srv.submit(jnp.asarray(x), rank, request_id=rid)
    out = srv.flush()
    # the reference seeds its i-th request (in flush order) with PRNGKey(i + 1)
    order = [rid for key in dict.fromkeys(r.bucket for r in out.values())
             for rid, _ in requests if out[rid].bucket == key]
    inits = {rid: [np.asarray(f) for f in j_random_factors(
        jax.random.PRNGKey(i + 1), dict(requests)[rid].shape, rank, jnp.float32)]
        for i, rid in enumerate(order)}
    return out, inits


@pytest.mark.parametrize("shapes,tol", [
    ([(7, 6, 5)], 1e-4),
    ([(7, 6, 5), (8, 5, 6), (6, 6, 8)], 1e-4),
    ([(7, 6, 5), (5, 7, 3, 4)], 0.0),
])
@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_served_result_matches_the_reference(shapes, tol, backend):
    rank, n_iters = 3, 8
    requests = [(f"r{i}", _low_rank(s, rank, 20 + i)) for i, s in enumerate(shapes)]
    ref, inits = _reference_serve(requests, rank, n_iters, tol)
    srv = DecompositionServer(_ctx(backend), n_iters=n_iters, tol=tol)
    for rid, x in requests:
        srv.submit(torch.from_numpy(x), rank, request_id=rid,
                   init_factors=[torch.from_numpy(np.array(f)) for f in inits[rid]])
    got = srv.flush()
    for rid, x in requests:
        g, w = got[rid], ref[rid]
        assert (g.n_iters, g.converged, g.batch) == (w.n_iters, w.converged, w.batch)
        assert abs(g.fit - w.fit) <= TOL * max(abs(w.fit), 1.0)
        assert _rel(g.weights.numpy(), w.weights) <= TOL
        for gf, wf in zip(g.factors, w.factors):
            assert tuple(gf.shape) == wf.shape
            assert _rel(gf.numpy(), wf) <= TOL


def test_a_served_matrix_matches_the_reference():
    """A matrix's CP factors are defined only up to an invertible R x R
    mix (X = A diag(w) B^T = (A M)(M^-1 diag(w) B^T)), so fp32 rounding in
    another order moves them along that freedom; what the request defines,
    its reconstruction, is held to 1e-5, with the fit, iterations and
    convergence."""
    rank, n_iters, tol = 3, 8, 1e-4
    requests = [("m", _low_rank((9, 7), rank, 23))]
    ref, inits = _reference_serve(requests, rank, n_iters, tol)
    srv = DecompositionServer(_ctx(), n_iters=n_iters, tol=tol)
    srv.submit(torch.from_numpy(requests[0][1]), rank, request_id="m",
               init_factors=[torch.from_numpy(np.array(f)) for f in inits["m"]])
    g, w = srv.flush()["m"], ref["m"]
    assert (g.n_iters, g.converged) == (w.n_iters, w.converged)
    assert abs(g.fit - w.fit) <= TOL
    a, b = (f.numpy() for f in g.factors)
    ja, jb = (np.asarray(f) for f in w.factors)
    assert _rel((a * g.weights.numpy()) @ b.T, (ja * np.asarray(w.weights)) @ jb.T) <= TOL


def test_tol_keeps_every_request_off_the_boundary():
    """The parity cases' ``tol`` is no coin toss: each request's fit
    change at its last sweep is at least 10 % away from ``tol``."""
    rank, tol = 3, 1e-4
    for shapes in ([(7, 6, 5)], [(7, 6, 5), (8, 5, 6), (6, 6, 8)], [(9, 7)]):
        for i, s in enumerate(shapes):
            x = _low_rank(s, rank, 20 + i)
            ctx = _ctx()
            init = [torch.from_numpy(np.array(f)) for f in j_random_factors(
                jax.random.PRNGKey(1), s, rank, jnp.float32)]
            fits = repro_torch.cp_als(torch.from_numpy(x), rank, 8, init_factors=init,
                                      ctx=ctx).fits
            deltas = np.abs(np.diff(fits))
            assert np.all(np.abs(deltas - tol) > 0.1 * tol), (s, deltas)


def test_the_servers_own_draws_are_seeded_i_plus_one():
    rank, shapes = 3, [(7, 6, 5), (6, 5, 7)]
    srv = DecompositionServer(_ctx(), n_iters=4, tol=0.0)
    xs = [_low_rank(s, rank, 30 + i) for i, s in enumerate(shapes)]
    for i, x in enumerate(xs):
        srv.submit(torch.from_numpy(x), rank, request_id=f"r{i}")
    got = srv.flush()
    for i, x in enumerate(xs):
        init = random_factors(torch.Generator().manual_seed(i + 1), x.shape, rank)
        direct = repro_torch.cp_als(torch.from_numpy(x), rank, 4, init_factors=init,
                                    ctx=_ctx())
        assert abs(got[f"r{i}"].fit - direct.final_fit) <= TOL
        for gf, df in zip(got[f"r{i}"].factors, direct.factors):
            assert _rel(gf.numpy(), df.numpy()) <= 1e-4


def test_convergence_mask_freezes_the_easy_request():
    shape, rank, n_iters = (8, 8, 8), 3, 25
    easy = _low_rank(shape, rank, 41, noise=0.0)
    hard = np.random.default_rng(42).standard_normal(shape, dtype=np.float32)
    srv = DecompositionServer(_ctx(), n_iters=n_iters, tol=1e-5)
    srv.submit(torch.from_numpy(easy), rank, request_id="easy")
    srv.submit(torch.from_numpy(hard), rank, request_id="hard")
    res = srv.flush()
    assert res["easy"].bucket == res["hard"].bucket
    assert res["easy"].converged and res["easy"].n_iters < n_iters
    assert res["easy"].n_iters < res["hard"].n_iters
    assert res["easy"].fit == pytest.approx(1.0, abs=1e-3)
    init = random_factors(torch.Generator().manual_seed(1), shape, rank)
    solo = repro_torch.cp_als(torch.from_numpy(easy), rank, n_iters, init_factors=init,
                              tol=1e-5, ctx=_ctx())
    assert abs(res["easy"].n_iters - len(solo.fits)) <= 1
    np.testing.assert_allclose(res["easy"].weights.numpy(), solo.weights.numpy(), rtol=1e-4)


def test_a_second_flush_of_a_bucket_is_warm():
    srv = DecompositionServer(_ctx(), n_iters=2, tol=0.0)
    srv.submit(torch.from_numpy(_low_rank((7, 6, 5), 2, 1)), 2, request_id="a")
    assert srv.flush()["a"].cold
    srv.submit(torch.from_numpy(_low_rank((6, 6, 5), 2, 2)), 2, request_id="b")
    assert not srv.flush()["b"].cold


def test_the_server_rejects_a_tensor_off_its_device():
    srv = DecompositionServer(_ctx())
    assert srv.ctx.device == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecompositionServer()


# ---------------------------------------------------------------------------
# the warm-start directory
# ---------------------------------------------------------------------------

def test_set_build_dir_points_builds_and_keeps_loaded_libraries(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "_build_dir", build.BUILD_DIR)
    assert build.build_dir() == build.BUILD_DIR
    assert build.set_build_dir(str(tmp_path / "cc")) == (tmp_path / "cc").resolve()
    assert build.build_dir() == (tmp_path / "cc").resolve()
    assert build.set_build_dir(None) == build.BUILD_DIR
    assert all(source in build.SOURCES for source in build.loaded())


def test_ensure_compilation_cache_on_a_cpu_context_is_a_no_op(tmp_path):
    srv = DecompositionServer(_ctx(compilation_cache=str(tmp_path / "cc")))
    assert srv.ctx.ensure_compilation_cache() is None
    assert not (tmp_path / "cc").exists()
    ctx = _ctx(compilation_cache=str(tmp_path / "cc"))
    assert ExecutionContext.from_json(ctx.to_json()) == ctx


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_serves_a_synthetic_workload(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    assert serve.main(["--device", "cpu", "--requests", "4", "--shape", "8x7x6", "--rank",
                       "2", "--iters", "3"]) == 0
    out = capsys.readouterr().out
    assert "served 4 request(s)" in out and "across 1 bucket(s)" in out
    assert out.count("req") >= 4
