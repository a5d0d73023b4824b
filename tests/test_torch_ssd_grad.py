"""The gradient of the port's intra-chunk SSD term (``SsdIntra``, the
closed-form adjoint that ``ssd_intra`` carries on both devices) and the
``REPRO_SSD_LEAN`` option of ``apply_ssm``, on the CPU.

Inputs are made with numpy from a seed. Tolerances: in float64 the
backward passes ``torch.autograd.gradcheck`` and equals autograd through
``ssd_intra_plain`` within 1e-12 of each gradient's largest magnitude; in
fp32 each of the five gradients is within 1e-5 of the largest magnitude of
``jax.vjp`` of the reference's oracle ``ssd_intra_ref`` on the same output
gradient (the same sums in another order); with x in bf16, dx is bf16 and
within 1e-2 of the fp32 adjoint on the same rounded x (a bf16 ulp is 2^-8).
``apply_ssm`` under ``_LEAN`` (both packages' flags patched) is held to the
reference's lean path within 1e-5 in fp32, output and gradients.
"""

import os
import subprocess
import sys
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.kernels.ssd_intra import ssd_intra_ref
from repro.models import init_params as ref_init_params
from repro.models import ssm as ref_ssm
from repro_torch.kernels.ssd_intra import SsdIntra, ssd_intra, ssd_intra_grads, ssd_intra_plain
from repro_torch.models import ArchConfig, set_trainable, ssm

F32_TOL = 1e-5
F64_TOL = 1e-12
BF16_TOL = 1e-2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("dcc", "dbc", "dcum", "ddt", "dx")


def _softplus(a):
    return np.log1p(np.exp(a))


def _mk(bcn, q, n, h, p, seed=0):
    """(cc, bc, cum, dt, x, dy) as float32 numpy arrays; ``cum`` negative
    and decreasing in i, as a cumulative log-decay."""
    rng = np.random.default_rng(seed)
    cc = rng.standard_normal((bcn, q, n), dtype=np.float32)
    bc = rng.standard_normal((bcn, q, n), dtype=np.float32)
    cum = -np.cumsum(_softplus(rng.standard_normal((bcn, q, h))), axis=1).astype(np.float32)
    dt = _softplus(rng.standard_normal((bcn, q, h))).astype(np.float32)
    x = rng.standard_normal((bcn, q, h, p), dtype=np.float32)
    dy = rng.standard_normal((bcn, q, h, p), dtype=np.float32)
    return cc, bc, cum, dt, x, dy


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _leaves(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]


# (bcn, q, n, h, p): the reference kernel test's shapes, ragged q, N and P,
# and one head
SHAPES = [
    (4, 16, 8, 8, 16),
    (2, 32, 16, 8, 8),
    (3, 64, 16, 4, 16),
    (2, 40, 20, 4, 24),
    (1, 70, 33, 3, 6),
    (2, 24, 8, 1, 16),
]


@pytest.mark.parametrize("shape", [(2, 7, 3, 2, 4), (1, 9, 2, 3, 2), (2, 5, 4, 1, 3)])
def test_backward_passes_gradcheck_in_float64(shape):
    args = _leaves(_mk(*shape)[:5], torch.float64)
    assert torch.autograd.gradcheck(lambda *a: ssd_intra(*a), args)


@pytest.mark.parametrize("shape", SHAPES[:3] + SHAPES[4:])
def test_backward_equals_autograd_through_the_plain_version_in_float64(shape):
    *arrays, dy = _mk(*shape, seed=1)
    args = _leaves(arrays, torch.float64)
    dy = torch.from_numpy(dy).double()
    got = torch.autograd.grad(ssd_intra(*args), args, dy)
    want = torch.autograd.grad(ssd_intra_plain(*args), args, dy)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64
        assert _rel(g, w.numpy()) <= F64_TOL, name


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_the_references_vjp(shape):
    *arrays, dy = _mk(*shape, seed=2)
    _, vjp = jax.vjp(ssd_intra_ref, *(jnp.asarray(a) for a in arrays))
    want = vjp(jnp.asarray(dy))
    args = _leaves(arrays)
    y = ssd_intra(*args)
    assert isinstance(y.grad_fn, SsdIntra._backward_cls)
    got = torch.autograd.grad(y, args, torch.from_numpy(dy))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32
        assert _rel(g, w) <= F32_TOL, name


def test_backward_keeps_each_inputs_dtype_with_x_in_bf16():
    *arrays, dy = _mk(2, 40, 20, 4, 24, seed=3)
    args = _leaves(arrays[:4]) + [torch.from_numpy(arrays[4]).bfloat16().requires_grad_()]
    y = ssd_intra(*args)
    assert y.dtype == torch.bfloat16
    dyb = torch.from_numpy(dy).bfloat16()
    got = torch.autograd.grad(y, args, dyb)
    assert [g.dtype for g in got] == [torch.float32] * 4 + [torch.bfloat16]
    # the fp32 adjoint on the same rounded operands
    want = ssd_intra_grads(*(a.detach().float() for a in args), dyb.float())
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g, w.numpy()) <= BF16_TOL, name


def test_backward_gives_only_the_gradients_asked_for():
    *arrays, dy = _mk(2, 16, 8, 4, 8, seed=4)
    cc, bc, cum, dt, x = (torch.from_numpy(a) for a in arrays)
    x.requires_grad_()
    ones = torch.ones_like(dt)  # the lean path's dt: no gradient
    (dx,) = torch.autograd.grad(ssd_intra(cc, bc, cum, ones, x), [x], torch.from_numpy(dy))
    full = ssd_intra_grads(cc, bc, cum, ones, x.detach(), torch.from_numpy(dy))
    assert torch.equal(dx, full[4])
    none = ssd_intra_grads(cc, bc, cum, ones, x.detach(), torch.from_numpy(dy),
                           (False, False, False, False, True))
    assert none[:4] == (None,) * 4 and torch.equal(none[4], full[4])


def test_serving_without_autograd_records_no_graph():
    arrays = _mk(1, 8, 4, 2, 4)[:5]
    args = _leaves(arrays)
    with torch.no_grad():
        y = ssd_intra(*args)
    assert y.grad_fn is None and not y.requires_grad


# --------------------------------------------------------------------------
# apply_ssm, default and lean, with its gradients
# --------------------------------------------------------------------------

def _ssm_case(seed=5, s=16):
    ref_cfg = replace(ref_get_smoke("mamba2-2.7b"), dtype="float32")
    cfg = ArchConfig(**asdict(ref_cfg))
    params = ref_init_params(jax.random.PRNGKey(3), ref_cfg)
    ref_p = jax.tree.map(lambda a: a[0], params["blocks"][0]["ssm"])
    # A_log, dt_bias and D away from their initial 0, 0, 1, so their
    # gradients are not degenerate
    rng = np.random.default_rng(seed)
    h = cfg.ssm_heads
    ref_p = {**ref_p, "A_log": jnp.asarray(0.5 * rng.standard_normal(h), jnp.float32),
             "dt_bias": jnp.asarray(0.5 * rng.standard_normal(h), jnp.float32),
             "D": jnp.asarray(1 + 0.5 * rng.standard_normal(h), jnp.float32)}
    p = set_trainable(ssm.SSM({k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}))
    x = rng.standard_normal((2, s, cfg.d_model), dtype=np.float32)
    w = rng.standard_normal((2, s, cfg.d_model), dtype=np.float32)
    return ref_cfg, cfg, ref_p, p, x, w


@pytest.mark.parametrize("lean", [False, True], ids=["default", "lean"])
def test_apply_ssm_and_its_gradients_match_the_reference(lean, monkeypatch):
    monkeypatch.setattr(ref_ssm, "_LEAN", lean)
    monkeypatch.setattr(ssm, "_LEAN", lean)
    ref_cfg, cfg, ref_p, p, x, w = _ssm_case()

    def ref_loss(params, xs):  # a fresh function: jit traces _LEAN anew
        return jnp.sum(ref_ssm.apply_ssm(params, xs, ref_cfg) * w)

    want_y = ref_ssm.apply_ssm(ref_p, jnp.asarray(x), ref_cfg)
    want_gp, want_gx = jax.grad(ref_loss, argnums=(0, 1))(ref_p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = ssm.apply_ssm(p, xt, cfg)
    assert _rel(y, want_y) <= F32_TOL
    names = list(ssm.SSM.names)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), [xt] + [getattr(p, k) for k in names])
    assert _rel(got[0], want_gx) <= F32_TOL
    for k, g in zip(names, got[1:]):
        assert _rel(g, want_gp[k]) <= F32_TOL, k


def test_lean_and_default_differ_only_in_rounding():
    _, cfg, _, p, x, _ = _ssm_case(seed=6)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        base = ssm.apply_ssm(p, xt, cfg)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ssm, "_LEAN", True)
            lean = ssm.apply_ssm(p, xt, cfg)
    assert _rel(lean, base.numpy()) <= F32_TOL


def test_lean_is_read_from_the_environment_at_import():
    code = "import repro_torch.models.ssm as m; print(m._LEAN)"
    out = {}
    for value in ("1", "0"):
        env = {**os.environ, "REPRO_SSD_LEAN": value,
               "PYTHONPATH": os.path.join(ROOT, "src")}
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              env=env, timeout=120)
        assert proc.returncode == 0, proc.stderr
        out[value] = proc.stdout.strip()
    assert out == {"1": "True", "0": "False"}


def test_gradients_stay_finite_where_the_references_overflow():
    """At a chunk of 256 with Mamba2's decays the exponent above the
    diagonal passes 88: the reference selects after ``exp`` and its
    gradients of cc, bc and cum are NaN; the port's adjoint and autograd
    through its plain version select first and stay finite."""
    *arrays, dy = _mk(1, 256, 16, 2, 8, seed=7)
    assert float(-arrays[2].min()) > 88.0
    _, vjp = jax.vjp(ssd_intra_ref, *(jnp.asarray(a) for a in arrays))
    ref = vjp(jnp.asarray(dy))
    assert [bool(np.isfinite(np.asarray(g)).all()) for g in ref] == [False] * 3 + [True] * 2
    args = _leaves(arrays)
    for fn in (ssd_intra, ssd_intra_plain):
        grads = torch.autograd.grad(fn(*args), args, torch.from_numpy(dy))
        assert all(bool(torch.isfinite(g).all()) for g in grads), fn.__name__
    # where the reference's are finite, the port's equal them
    got = torch.autograd.grad(ssd_intra(*args), args, torch.from_numpy(dy))
    for name, g, w in zip(NAMES[3:], got[3:], ref[3:]):
        assert _rel(g, w) <= F32_TOL, name
