"""The port's intra-chunk SSD term (``repro_torch.kernels.ssd_intra``) against
the reference's oracle ``ssd_intra_ref`` and its Pallas kernel in interpret
mode, on the CPU, where the wrapper takes its plain version.

Inputs are made with numpy from a seed and given to both packages.
Tolerances: fp32, max |port - ref| / max |ref| <= 1e-5 (the same formula,
sums in another order); everything in bf16, 5e-2 absolute and relative, as
the reference's own bf16 test; against the Pallas kernel 2e-4, as the
reference's kernel test.

The Hopper kernel itself runs only on the card; here :func:`_kernel_walk`
repeats its arithmetic in plain torch (its tile walk, its operand
splitting and its fold order) and is held to ``chip_smoke.py``'s limits
for the kernel: max |d| / max |ref| <= 1e-5 for fp32 x, <= 1e-2 for bf16 x
(a bf16 ulp of the output is 2^-8 of it).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_intra import ssd_intra_pallas, ssd_intra_ref
from repro.kernels.ssd_intra import traffic_model as ref_traffic_model
from repro_torch.engine.plan import SMEM_BUDGET
from repro_torch.kernels import ssd_intra as ssd_mod
from repro_torch.kernels.ssd_intra import (
    kernel_plan,
    kernel_smem_bytes,
    ssd_intra,
    ssd_intra_plain,
    traffic_model,
)

F32_REL = 1e-5
BF16_TOL = 5e-2
PALLAS_TOL = 2e-4
KERNEL_TOL = {"f32": 1e-5, "x_bf16": 1e-2}  # chip_smoke.py's limits for the kernel


def _softplus(a):
    return np.log1p(np.exp(a))


def _mk(bcn, q, n, h, p, seed=0, monotone=True):
    """(cc, bc, cum, dt, x) as float32 numpy arrays; ``cum`` is a
    cumulative log-decay, negative and decreasing in i, unless ``monotone``
    is false."""
    rng = np.random.default_rng(seed)
    cc = rng.standard_normal((bcn, q, n), dtype=np.float32)
    bc = rng.standard_normal((bcn, q, n), dtype=np.float32)
    steps = _softplus(rng.standard_normal((bcn, q, h))).astype(np.float32)
    if not monotone:  # a fifth of the steps rise (cum grows), the rest fall steeply
        mag = np.abs(rng.standard_normal((bcn, q, h)))
        rise = rng.random((bcn, q, h)) < 0.2
        steps = np.where(rise, -mag, 10.0 * mag).astype(np.float32)
    cum = -np.cumsum(steps, axis=1, dtype=np.float32)
    dt = _softplus(rng.standard_normal((bcn, q, h))).astype(np.float32)
    x = rng.standard_normal((bcn, q, h, p), dtype=np.float32)
    return cc, bc, cum, dt, x


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


# the four shapes of the reference's kernel test (bcn, q, n, h, p, head_block)
SHAPES = [
    (4, 16, 8, 8, 16, 4),
    (2, 32, 16, 8, 8, 8),
    (1, 8, 4, 16, 4, 8),
    (3, 64, 16, 4, 16, 2),
]


@pytest.mark.parametrize("bcn,q,n,h,p,hb", SHAPES)
def test_plain_matches_reference_oracle_f32(bcn, q, n, h, p, hb):
    args = _mk(bcn, q, n, h, p)
    got = ssd_intra(*(torch.from_numpy(a) for a in args), head_block=hb)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ssd_intra_ref(*(jnp.asarray(a) for a in args))) <= F32_REL


@pytest.mark.parametrize("bcn,q,n,h,p,hb", SHAPES)
def test_plain_matches_reference_oracle_bf16(bcn, q, n, h, p, hb):
    args = _mk(bcn, q, n, h, p, seed=1)
    ref = ssd_intra_ref(*(jnp.asarray(a, jnp.bfloat16) for a in args))
    got = ssd_intra(*(torch.from_numpy(a).to(torch.bfloat16) for a in args), head_block=hb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("bcn,q,n,h,p,hb", [(2, 16, 8, 8, 16, 4), (1, 8, 4, 4, 8, 2)])
def test_plain_matches_pallas_interpret(bcn, q, n, h, p, hb):
    args = _mk(bcn, q, n, h, p, seed=2)
    ref = ssd_intra_pallas(*(jnp.asarray(a) for a in args), head_block=hb, interpret=True)
    np.testing.assert_allclose(ssd_intra_plain(*(torch.from_numpy(a) for a in args)).numpy(),
                               np.asarray(ref), rtol=PALLAS_TOL, atol=PALLAS_TOL)


def test_causality():
    """Output at position i does not depend on inputs at j > i."""
    cc, bc, cum, dt, x = (torch.from_numpy(a) for a in _mk(1, 16, 8, 4, 8, seed=7))
    base = ssd_intra(cc, bc, cum, dt, x, head_block=4)
    x2, b2, dt2 = x.clone(), bc.clone(), dt.clone()
    x2[:, 12:] = 123.0
    b2[:, 12:] = -5.0
    dt2[:, 12:] = 9.0
    out2 = ssd_intra(cc, b2, cum, dt2, x2, head_block=4)
    assert torch.equal(base[:, :12], out2[:, :12])
    assert not torch.allclose(base[:, 12:], out2[:, 12:])


def test_cum_not_monotone_gives_no_nan():
    """exp(cum_i - cum_j) overflows above the diagonal here; the decay is
    selected before it is used, so nothing turns into NaN."""
    args = _mk(2, 32, 8, 4, 8, seed=3, monotone=False)
    cum = args[2]
    assert (np.diff(cum, axis=1) > 0).any() and (np.diff(cum, axis=1) < 0).any()
    seg = (cum[:, :, None, :] - cum[:, None, :, :]).transpose(0, 3, 1, 2)  # (b, h, i, j)
    assert seg[..., np.triu_indices(32, 1)[0], np.triu_indices(32, 1)[1]].max() > 89.0
    got = ssd_intra(*(torch.from_numpy(a) for a in args), head_block=4)
    ref = np.asarray(ssd_intra_ref(*(jnp.asarray(a) for a in args)))
    assert bool(torch.isfinite(got).all()) and np.isfinite(ref).all()
    assert _rel(got.numpy(), ref) <= F32_REL


@pytest.mark.parametrize("itemsize", [2, 4])
def test_traffic_model_is_the_reference(itemsize):
    for bcn in (1, 16, 1024):
        for q in (8, 64, 256):
            for n, h, p in ((4, 8, 16), (128, 80, 64), (16, 24, 32)):
                assert traffic_model(bcn, q, n, h, p, itemsize) == ref_traffic_model(
                    bcn, q, n, h, p, itemsize)


def test_cpu_tensors_take_the_plain_version():
    args = [torch.from_numpy(a) for a in _mk(2, 16, 8, 8, 16, seed=4)]
    before = ssd_intra.launches
    got = ssd_intra(*args)
    assert ssd_intra.launches == before == 0
    assert torch.equal(got, ssd_intra_plain(*args))


@pytest.mark.parametrize("bad,match", [
    ({"head_block": 3}, "does not divide"),
    ({"cum": torch.zeros(2, 16, 7)}, "cum and dt"),
    ({"bc": torch.zeros(2, 16, 4)}, "cc and bc"),
    ({"x": torch.zeros(2, 16, 8)}, "x must be"),
])
def test_wrapper_validates_like_the_reference(bad, match):
    args = dict(zip(("cc", "bc", "cum", "dt", "x"),
                    (torch.from_numpy(a) for a in _mk(2, 16, 8, 8, 16))))
    head_block = bad.pop("head_block", 8)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        ssd_intra(**args, head_block=head_block)


def test_kernel_plan_and_shared_memory():
    # Mamba2-2.7b: q=256, H=80, P=64, BC=64, x bf16 -> 64-row tiles (two
    # heads at once), 40 heads a CTA (512 CTAs), two CTAs an SM; fp32 X
    # tiles are twice as wide, so 32-row tiles (four heads at once) keep two
    # CTAs an SM
    assert kernel_plan(256, 80, 64, 2, bcn=64) == ssd_mod.SsdPlan(64, 40)
    assert kernel_plan(256, 80, 64, 4, bcn=64) == ssd_mod.SsdPlan(32, 40)
    # few chunks: fewer heads a CTA, so that every SM has a CTA
    assert kernel_plan(256, 80, 64, 2, bcn=2) == ssd_mod.SsdPlan(64, 4)
    assert kernel_plan(256, 80, 64, 2, bcn=2, sms=8) == ssd_mod.SsdPlan(64, 40)
    assert kernel_plan(256, 24, 64, 2, bcn=64).heads == 24  # all of H: 256 CTAs
    assert kernel_plan(256, 7, 64, 2, bcn=64).heads == 7  # no multiple of 2 divides 7
    assert kernel_plan(256, 6, 64, 4, bcn=64).heads == 6  # nor of 4 6
    # G (64 rows of 256 + 16 fp32) | cum_j, dt_j, cum_i of 2 heads, two
    # stages | two stages of 2 heads' X tiles (64 rows of 128 + 16 bytes)
    assert kernel_smem_bytes(256, 64, 64, 2) == 64 * 272 * 4 + 2 * 2 * 3 * 64 * 4 + 2 * 2 * 64 * 144
    assert kernel_smem_bytes(256, 64, 32, 4) == 32 * 264 * 4 + 2 * 4 * 3 * 32 * 4 + 2 * 4 * 32 * 288
    assert kernel_smem_bytes(200, 64, 16, 2) == 16 * 208 * 4 + 2 * 8 * 3 * 16 * 4 + 2 * 8 * 16 * 144
    assert kernel_smem_bytes(256, 64, 64, 4) > SMEM_BUDGET
    for itemsize in (2, 4):
        plan = kernel_plan(256, 80, 64, itemsize, bcn=64)
        assert 2 * kernel_smem_bytes(256, 64, plan.tile, itemsize) <= 228 * 1024 - 2 * 1024
    # small P: the Gram's two stages of C and B chunks set the ring's size
    assert kernel_smem_bytes(8, 6, 16, 2) == 16 * 16 * 4 + 2 * 8 * 3 * 16 * 4 + 2 * 8 * 16 * 144
    assert kernel_plan(8, 4, 16, 2, bcn=1000) == ssd_mod.SsdPlan(64, 4)
    assert kernel_plan(8, 4, 16, 2, bcn=64) == ssd_mod.SsdPlan(64, 2)
    # P=128: 4 row blocks x 2 column blocks fill the 8 warps; P=256 needs 32-row tiles
    assert kernel_plan(256, 24, 128, 2, bcn=64).tile == 64
    assert kernel_plan(256, 8, 256, 2, bcn=64).tile == 32 and not ssd_mod.valid_tile(256, 64)
    assert ssd_mod.heads_at_once(130, 32) == 1 and ssd_mod.heads_at_once(64, 16) == 8
    assert kernel_plan(2048, 8, 64, 2, bcn=8).tile == 16  # a long chunk: smaller tiles for the Gram
    with pytest.raises(ValueError, match="no tile fits"):
        kernel_plan(256, 8, 300, 2, bcn=1)
    with pytest.raises(ValueError, match="no tile fits"):
        kernel_plan(8192, 8, 64, 4, bcn=1)


# ---- the Hopper kernel's arithmetic, emulated -------------------------------


def _tf32_round(a: torch.Tensor) -> torch.Tensor:
    """``ring.cuh:round_tf32``: the fp32 bits plus 0x1000, low 13 bits cleared."""
    bits = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)


def _tf32_trunc(a: torch.Tensor) -> torch.Tensor:
    """What a tensor core reads of an fp32 operand: its low 13 bits dropped."""
    return (a.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split3(a: torch.Tensor):
    hi = _tf32_round(a)
    return hi, _tf32_trunc(a - hi)


def _mm3(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3xTF32, the small terms first (lo hi + hi lo + hi hi); exact products
    summed in float64, one fp32 partial."""
    (ah, al), (bh, bl) = _split3(a), _split3(b)
    terms = [(al, bh), (ah, bl), (ah, bh)]
    return sum(torch.einsum(eq, u.double(), v.double()) for u, v in terms).float()


def _kernel_walk(cc, bc, cum, dt, x, tile, out_dtype=None):
    """``csrc/ssd_intra.cu`` in plain torch: per i-tile, the Gram tiles of
    every j-tile at or below the diagonal as 3xTF32 over N chunks of ``GK``
    (a fresh partial a chunk, folded in fp32); per j-tile the weights
    ``G exp(cum_i - cum_j) dt_j`` selected on ``j <= i`` (the diagonal tile
    masked), split into bf16 hi and lo for bf16 x (two products against the
    exact bf16 X) or rounded as tf32 (3xTF32, fp32 x), a fresh partial a
    j-tile folded into the fp32 sums; the output in x's dtype (or
    ``out_dtype``)."""
    bcn, q, n = cc.shape
    h, p = x.shape[2:]
    out = torch.zeros((bcn, q, h, p), dtype=torch.float32)
    xf = x.float()
    for it in range(-(-q // tile)):
        i0, i1 = it * tile, min(q, (it + 1) * tile)
        acc = torch.zeros((bcn, i1 - i0, h, p), dtype=torch.float32)
        for jt in range(it + 1):
            j0, j1 = jt * tile, min(q, (jt + 1) * tile)
            g = torch.zeros((bcn, i1 - i0, j1 - j0), dtype=torch.float32)
            for k0 in range(0, n, ssd_mod.GK):
                ks = slice(k0, k0 + ssd_mod.GK)
                g = g + _mm3("bik,bjk->bij", cc[:, i0:i1, ks], bc[:, j0:j1, ks])
            seg = cum[:, i0:i1, None, :] - cum[:, None, j0:j1, :]
            causal = (torch.arange(i0, i1)[:, None] >= torch.arange(j0, j1)[None, :])
            w = torch.where(causal[None, :, :, None], g[..., None] * torch.exp(seg)
                            * dt[:, None, j0:j1, :], 0.0)
            xj = xf[:, j0:j1]
            if x.dtype == torch.float32:
                part = _mm3("bijh,bjhp->bihp", w, xj)
            else:
                hi = w.to(torch.bfloat16).float()
                lo = (w - hi).to(torch.bfloat16).float()
                part = sum(torch.einsum("bijh,bjhp->bihp", u.double(), xj.double())
                           for u in (lo, hi)).float()
            acc = acc + part
        out[:, i0:i1] = acc
    return out.to(out_dtype or x.dtype)


# ragged q (off every tile), N (off the Gram's chunk and off 4), P (off 8 and 64)
WALK_SHAPES = [(2, 40, 20, 4, 24), (1, 70, 33, 3, 6), (2, 16, 32, 2, 64)]


def _walk_args(bcn, q, n, h, p, mix, seed, steep):
    cc, bc, cum, dt, x = _mk(bcn, q, n, h, p, seed=seed)
    if steep:  # exp(cum_i - cum_j) overflows above the diagonal
        cum = cum * 40.0
    t = [torch.from_numpy(a) for a in (cc, bc, cum, dt, x)]
    if mix == "x_bf16":
        t[4] = t[4].to(torch.bfloat16)
    return (cc, bc, cum, dt, x), t


@pytest.mark.parametrize("steep", [False, True])
@pytest.mark.parametrize("mix", ["f32", "x_bf16"])
@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_kernel_walk_matches_reference_oracle(shape, tile, mix, steep):
    """The kernel's walk and operand splits against ``ssd_intra_ref``."""
    arrays, t = _walk_args(*shape, mix, seed=sum(shape) + tile, steep=steep)
    if mix == "x_bf16":
        ref = ssd_intra_ref(*(jnp.asarray(a) for a in arrays[:4]),
                            jnp.asarray(arrays[4], jnp.bfloat16))
    else:
        ref = ssd_intra_ref(*(jnp.asarray(a) for a in arrays))
    got = _kernel_walk(*t, tile)
    assert got.dtype == t[4].dtype and bool(torch.isfinite(got).all())
    assert _rel(got.float().numpy(), np.asarray(ref, np.float32)) <= KERNEL_TOL[mix]


@pytest.mark.parametrize("mix", ["f32", "x_bf16"])
@pytest.mark.parametrize("shape", [(2, 40, 20, 4, 24), (1, 70, 33, 2, 6)])
def test_kernel_walk_matches_pallas_interpret(shape, mix):
    """The same walk (64-row tiles, the served plan's) against the Pallas
    kernel in interpret mode, with steep decay."""
    arrays, t = _walk_args(*shape, mix, seed=11, steep=True)
    x_jax = jnp.asarray(arrays[4], jnp.bfloat16 if mix == "x_bf16" else jnp.float32)
    ref = ssd_intra_pallas(*(jnp.asarray(a) for a in arrays[:4]), x_jax,
                           head_block=shape[3], interpret=True)
    got = _kernel_walk(*t, 64)
    assert _rel(got.float().numpy(), np.asarray(ref, np.float32)) <= KERNEL_TOL[mix]


def test_kernel_walk_needs_the_lo_part():
    """The bf16 mix keeps fp32 weights: W rounded to bf16 once (no lo
    part) is a different function. Before the output is rounded, the
    split walk stays within 1e-5 of the fp32 sums; the weights rounded once
    are 100x further off."""
    arrays, t = _walk_args(2, 64, 32, 4, 64, "x_bf16", seed=5, steep=False)
    xb = np.asarray(t[4].float())  # x as bf16 holds it
    want = np.asarray(ssd_intra_ref(*(jnp.asarray(a) for a in arrays[:4]), jnp.asarray(xb)))
    got = _kernel_walk(*t, 64, out_dtype=torch.float32).numpy()
    g = torch.einsum("bin,bjn->bij", t[0], t[1])
    seg = t[2][:, :, None, :] - t[2][:, None, :, :]
    causal = torch.ones((64, 64), dtype=torch.bool).tril()
    w = torch.where(causal[None, :, :, None], g[..., None] * torch.exp(seg) * t[3][:, None], 0.0)
    once = torch.einsum("bijh,bjhp->bihp", w.to(torch.bfloat16).float(), t[4].float()).numpy()
    assert _rel(got, want) <= F32_REL
    assert _rel(once, want) > 100 * _rel(got, want)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tile", [16, 64])
@pytest.mark.parametrize("shape", [(2, 64, 32, 4, 64), (1, 100, 20, 3, 24)])
def test_cancelling_operands_separate_the_lo_product(shape, tile):
    """``chip_smoke.py``'s card check that the bf16 mix keeps fp32 weights,
    here on the emulated walk: on ``ssd_cancelling`` operands the hi + lo
    products, output in bf16, read within ``LO_TOL`` (1e-2) of the fp32
    sums over the odd rows, and the weights rounded to bf16 once read above
    it."""
    cs = _chip_smoke()
    args = cs.ssd_cancelling(torch.Generator().manual_seed(sum(shape)), *shape, device="cpu")
    reading, control = cs.ssd_lo_readings(args, _kernel_walk(*args, tile))
    assert reading <= cs.LO_TOL < control
