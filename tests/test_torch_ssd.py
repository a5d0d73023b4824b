"""The port's intra-chunk SSD term (``repro_torch.kernels.ssd_intra``) against
the reference's oracle ``ssd_intra_ref`` and its Pallas kernel in interpret
mode, on the CPU, where the wrapper takes its plain version.

Inputs are made with numpy from a seed and given to both packages.
Tolerances: fp32, max |port - ref| / max |ref| <= 1e-5 (the same formula,
sums in another order); everything in bf16, 5e-2 absolute and relative, as
the reference's own bf16 test; against the Pallas kernel 2e-4, as the
reference's kernel test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_intra import ssd_intra_pallas, ssd_intra_ref
from repro.kernels.ssd_intra import traffic_model as ref_traffic_model
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
    # Mamba2-2.7b: q=256, H=80, P=64 -> 64-row tiles, 20 heads a CTA, two CTAs an SM
    assert kernel_plan(256, 80, 64) == ssd_mod.SsdPlan(64, 20)
    assert kernel_plan(256, 24, 64).heads == 12 and kernel_plan(256, 7, 64).heads == 7
    assert kernel_smem_bytes(256, 64, 64) == (256 * 68 + 4 * 64 + 64 * 68 + 64 * 64) * 4
    assert 2 * kernel_smem_bytes(256, 64, 64) <= 228 * 1024 - 2 * 1024
    assert kernel_plan(8, 4, 16) == ssd_mod.SsdPlan(64, 4)
    assert kernel_plan(256, 24, 128).tile == 32  # P=128: 4-row x 4-column units fill 256 threads
    assert kernel_plan(2048, 8, 64).tile == 16  # a long chunk: smaller tiles for the Gram
    with pytest.raises(ValueError, match="no tile fits"):
        kernel_plan(256, 8, 300)
