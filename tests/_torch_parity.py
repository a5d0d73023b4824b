"""Helpers the port's parity tests share: numpy inputs for both packages,
tolerance checks, one ALS update written for either package, and CP-ALS
runs of the port on the CPU.

Tolerances: float32 in different summation orders agrees to 1e-5 of the
largest output magnitude; CP-ALS fits agree within 1e-5 a step and factors
within 1e-4 of their largest magnitude (float32 ALS from the same start
drifts by a few ulps an iteration).
"""

import numpy as np
import torch

import repro_torch
from repro_torch.convert import factors_from_numpy

F32_TOL = 1e-5
FIT_TOL = 1e-5
PARAM_TOL = 1e-4


def data(dims, rank, seed=0):
    """A standard-normal tensor and one factor per mode, as numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(dims, dtype=np.float32)
    fs = [rng.standard_normal((d, rank), dtype=np.float32) for d in dims]
    return x, fs


def close(got, want, tol=F32_TOL):
    """``got`` (torch) within ``tol`` of the largest magnitude of ``want``."""
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * max(float(np.abs(want).max()), 1.0)


def als_update(factors, rank, xp):
    """The same ALS update for either package (``xp`` is ``jax.numpy`` or
    ``torch``): solve against the Hadamard product of the other Grams."""
    grams = [f.T @ f for f in factors]

    def update(mode, b):
        gamma = xp.ones((rank, rank), dtype=xp.float32)
        for k, g in enumerate(grams):
            if k != mode:
                gamma = gamma * g
        a = xp.linalg.solve(gamma + 1e-3 * xp.eye(rank, dtype=xp.float32), b.T).T
        grams[mode] = a.T @ a
        return a

    return update


def problem(dims, rank, seed):
    """A CP-rank-``rank`` tensor plus 5 % noise, and initial factors."""
    rng = np.random.default_rng(seed)
    true = [rng.standard_normal((d, rank), dtype=np.float32) for d in dims]
    spec = ",".join(f"{'abcde'[k]}z" for k in range(len(dims))) + "->" + "abcde"[:len(dims)]
    x = np.einsum(spec, *true).astype(np.float32)
    x += 0.05 * rng.standard_normal(dims, dtype=np.float32)
    init = [rng.standard_normal((d, rank), dtype=np.float32) for d in dims]
    return x, init


def port_cp(x, init, rank, iters, sweep, backend="cuda"):
    """The port's CP-ALS on the CPU from explicit initial factors."""
    ctx = repro_torch.ExecutionContext.create(backend, device="cpu")
    return repro_torch.cp_als(torch.from_numpy(x), rank, iters, sweep=sweep,
                              init_factors=factors_from_numpy(init, "cpu"), ctx=ctx)


def assert_same_cp(port, ref):
    """Fits within FIT_TOL at every step; factors and weights within
    PARAM_TOL of their largest magnitude."""
    np.testing.assert_allclose(port.fits, ref.fits, rtol=0, atol=FIT_TOL)
    for a, b in zip(port.factors + [port.weights], list(ref.factors) + [ref.weights]):
        b = np.asarray(b)
        assert float(np.abs(a.numpy() - b).max()) <= PARAM_TOL * max(float(np.abs(b).max()), 1.0)
