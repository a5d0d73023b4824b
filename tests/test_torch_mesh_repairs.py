"""The repairs the production meshes asked of the port, on the CPU.

* MoE's ``assign`` counts each expert's choices with a buffer of fixed
  shape (an ``index_add_``) and ``dispatch`` sends the dropped choices to a
  spare row: the same integers and the same buffer, bit for bit, as the
  ``bincount`` and the boolean-mask scatter they replace (re-stated here),
  and both now run on shape-only (fake) tensors, which a count whose
  length depends on the ids cannot;
* ``ssd_intra`` takes any number of heads: ``mamba2-2.7b``'s SSD at H = 20
  (its 80 heads on a tp of 4) against the reference's einsum path, where
  a ``head_block`` of 8 used to refuse it; a ``head_block`` given is still
  validated as the reference's;
* the attention projection's check of whole heads, which decides whether
  the flattened product is laid out before it is unflattened.

The dry run's cells at production width are in
``tests/test_torch_dryrun_cells.py``; the sharded steps on (2, 2) meshes in
``tests/test_torch_mesh_train*.py``.
"""

from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_smoke as ref_get_smoke
from repro.models import init_params as ref_init_params
from repro.models import ssm as ref_ssm
from repro_torch import convert
from repro_torch.kernels.ssd_intra import ssd_intra, ssd_intra_plain
from repro_torch.models import ArchConfig, attention, moe, ssm

F32_TOL = 1e-4


def _old_assign(ids: torch.Tensor, e: int, cap: int):
    """``assign`` as it was, on a ``bincount``."""
    flat = ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(flat.numel()) - starts[flat[order]]
    pos = pos.reshape(ids.shape)
    return pos, pos < cap


def _old_dispatch(xf, ids, pos, keep, e, cap):
    """``dispatch`` as it was, scattering the kept choices by a mask."""
    t, d = xf.shape
    k = ids.shape[1]
    slots = (ids * cap + pos)[keep]
    tokens = torch.arange(t).repeat_interleave(k).reshape(t, k)[keep]
    xe = torch.zeros((e * cap, d), dtype=xf.dtype)
    xe[slots] = xf[tokens]
    return xe.reshape(e, cap, d)


def _routing(t: int, k: int, e: int, seed: int):
    rng = np.random.default_rng(seed)
    # skewed towards the low ids so that queues overflow
    probs = torch.softmax(torch.from_numpy(rng.standard_normal((t, e))).float() * 3
                          - torch.arange(e) / 4, -1)
    return torch.topk(probs, k)[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,k,e,cap", [(300, 2, 4, 128), (333, 2, 16, 8), (64, 8, 64, 256),
                                       (7, 2, 5, 1)])
def test_assign_and_dispatch_are_the_old_bits(t, k, e, cap, dtype):
    ids = _routing(t, k, e, seed=t + k + e)
    pos, keep = moe.assign(ids, e, cap)
    old_pos, old_keep = _old_assign(ids, e, cap)
    assert torch.equal(pos, old_pos) and torch.equal(keep, old_keep)
    xf = torch.from_numpy(np.random.default_rng(t).standard_normal((t, 8))).to(dtype)
    got = moe.dispatch(xf, ids, pos, keep, e, cap)
    assert got.shape == (e, cap, 8) and got.is_contiguous()
    assert torch.equal(got, _old_dispatch(xf, ids, pos, keep, e, cap))


def test_assign_dispatch_and_combine_run_on_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode

    t, k, e, d = 4096, 8, 64, 32
    cap = moe.capacity(t, k, e)
    with FakeTensorMode():
        probs = torch.softmax(torch.zeros(t, e), -1)
        gates, ids = torch.topk(probs, k)
        pos, keep = moe.assign(ids, e, cap)
        xe = moe.dispatch(torch.zeros(t, d), ids, pos, keep, e, cap)
        y = moe.combine(xe, moe.Routing(probs, gates, ids), pos, keep)
        aux = moe.aux_loss(moe.Routing(probs, gates, ids), e)
    assert (pos.shape, keep.shape, xe.shape, y.shape, aux.shape) == (
        (t, k), (t, k), (e, cap, d), (t, d), ())


# --------------------------------------------------------------------------
# ssd_intra at any number of heads
# --------------------------------------------------------------------------

def _mk(bcn, q, n, h, p, seed):
    rng = np.random.default_rng(seed)
    cum = np.cumsum(-np.abs(rng.standard_normal((bcn, q, h))) * 0.1, axis=1)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((bcn, q, n)), rng.standard_normal((bcn, q, n)), cum,
        np.abs(rng.standard_normal((bcn, q, h))) * 0.1, rng.standard_normal((bcn, q, h, p)))]


def test_ssd_intra_takes_twenty_heads():
    args = _mk(2, 16, 8, 20, 16, seed=1)
    assert torch.equal(ssd_intra(*args), ssd_intra_plain(*args))
    assert torch.equal(ssd_intra(*args, head_block=4), ssd_intra_plain(*args))
    with pytest.raises(ValueError, match="head_block 8 does not divide H=20"):
        ssd_intra(*args, head_block=8)


def test_mamba2_ssd_at_twenty_heads_matches_the_reference():
    ref_cfg = replace(ref_get_smoke("mamba2-2.7b"), dtype="float32", d_model=160)
    cfg = ArchConfig(**asdict(ref_cfg))
    assert cfg.ssm_heads == ref_cfg.ssm_heads == 20
    params = ref_init_params(jax.random.PRNGKey(7), ref_cfg)
    model = convert.lm_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    ref_p = jax.tree.map(lambda a: a[0], params["blocks"][0]["ssm"])
    x = np.random.default_rng(8).standard_normal((2, 32, cfg.d_model), dtype=np.float32)
    want = np.asarray(jax.jit(ref_ssm.apply_ssm, static_argnums=2)(ref_p, jnp.asarray(x),
                                                                    ref_cfg))
    before = ssd_intra.launches
    got = ssm.apply_ssm(model.blocks[0].ssm, torch.from_numpy(x), cfg).numpy()
    assert ssd_intra.launches == before
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()


# --------------------------------------------------------------------------
# the projection's check of whole heads
# --------------------------------------------------------------------------

@pytest.fixture
def mesh_16x16():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    try:
        yield make_production_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("placements,heads,whole", [
    (("R", "S2"), 16, True), (("R", "S2"), 2, False), (("R", "S2"), 12, False),
    (("S2", "S2"), 256, True), (("S2", "S2"), 32, False), (("S0", "S1"), 2, True),
    (("S0", "R"), 6, True),
])
def test_the_projection_sees_whole_heads(mesh_16x16, placements, heads, whole):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pl = tuple(Replicate() if p == "R" else Shard(int(p[1])) for p in placements)
    with FakeTensorMode():
        y = DTensor.from_local(torch.zeros(256, 4096, 1024), mesh_16x16, pl, run_check=False)
    assert attention._splits_whole_heads(y, heads) is whole
    assert attention._splits_whole_heads(torch.zeros(2, 3, 4), 3)
