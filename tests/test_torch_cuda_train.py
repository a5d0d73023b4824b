"""The training path on the card: ``SsdIntra``'s gradients through the
Hopper kernel and the model's gradients through it, at small shapes.

Every test here needs a CUDA device and skips without one; whether a card
exists is decided inside the ``card`` fixture, never at import. The file
imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py

Matmuls run in full fp32 (TF32 off). Tolerances: the five gradients of the
term against autograd through ``ssd_intra_plain`` on the same inputs (the
same formula in fp32, summed in other orders) within 1e-5 of each
gradient's largest magnitude, 1e-2 with x in bf16 (dx is rounded to bf16);
the smoke model's loss and gradients through the kernel against the same
model with the plain version swapped in within 1e-4 (the kernel's forward
differs from the plain version's in its last bits); the three remat modes
within 1e-6 of one another.
"""

import functools
import tempfile
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import list_steps
from repro_torch.configs import get_smoke
from repro_torch.kernels.ssd_intra import ssd_intra, ssd_intra_plain
from repro_torch.models import init_params, loss_fn, set_trainable
from repro_torch.models import ssm as ssm_mod

pytestmark = pytest.mark.cuda

TOL = {"f32": 1e-5, "x_bf16": 1e-2}
MODEL_TOL = 1e-4
REMAT_TOL = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want) -> float:
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    return float((got.float() - want.float()).abs().max()) / max(float(want.abs().max()), 1e-30)


def _ssd_inputs(bcn, q, n, h, p, mix, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)

    sp = torch.nn.functional.softplus
    cc, bc = t(bcn, q, n), t(bcn, q, n)
    cum = -torch.cumsum(sp(t(bcn, q, h)), 1)
    dt = sp(t(bcn, q, h))
    x, dy = t(bcn, q, h, p), t(bcn, q, h, p)
    if mix == "x_bf16":
        x, dy = x.bfloat16(), dy.bfloat16()
    return (cc, bc, cum, dt, x), dy


# (bcn, q, n, h, p): the train shape's head dimension with fewer chunks,
# ragged q and P, the smoke config's shape, one head
SHAPES = [(2, 256, 128, 8, 64), (3, 100, 48, 6, 32), (4, 8, 16, 8, 16), (2, 64, 16, 1, 24)]


@pytest.mark.parametrize("mix", ["f32", "x_bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_ssd_intra_gradients_match_autograd_through_the_plain_version(card, shape, mix):
    args, dy = _ssd_inputs(*shape, mix, card, seed=sum(shape))
    leaves = [a.clone().requires_grad_() for a in args]
    before = ssd_intra.launches
    got = torch.autograd.grad(ssd_intra(*leaves), leaves, dy)
    assert ssd_intra.launches == before + 1  # the backward launches nothing
    plain = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad(ssd_intra_plain(*plain), plain, dy)
    for name, g, w in zip(("dcc", "dbc", "dcum", "ddt", "dx"), got, want):
        assert _rel(g, w) <= TOL[mix], name


def _smoke_model(card, remat="full"):
    cfg = replace(get_smoke("mamba2-2.7b"), dtype="float32", remat=remat)
    model = set_trainable(init_params(cfg, generator=torch.Generator(device="cuda")
                                      .manual_seed(1), device=card))
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), device=card,
                           generator=torch.Generator(device="cuda").manual_seed(2))
    return cfg, model, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def _grads(model, cfg, batch):
    leaves = dict(model.named_parameters())
    loss, _ = loss_fn(model, cfg, batch)
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def test_model_gradients_through_the_kernel_match_the_plain_version(card, monkeypatch):
    cfg, model, batch = _smoke_model(card)
    loss, grads = _grads(model, cfg, batch)
    monkeypatch.setattr(ssm_mod, "ssd_intra", ssd_intra_plain)
    plain_loss, plain = _grads(model, cfg, batch)
    assert abs(float(loss) - float(plain_loss)) <= MODEL_TOL * abs(float(plain_loss))
    for k, g in grads.items():
        assert _rel(g, plain[k]) <= MODEL_TOL, k


def test_remat_modes_agree_and_launch_the_kernel_again_in_the_recompute(card):
    out, launches = {}, {}
    for remat in ("none", "full", "dots"):
        cfg, model, batch = _smoke_model(card, remat)
        before = ssd_intra.launches
        out[remat] = _grads(model, cfg, batch)
        launches[remat] = ssd_intra.launches - before
    n = cfg.n_layers
    assert launches == {"none": n, "full": 2 * n, "dots": 2 * n}
    for remat in ("full", "dots"):
        assert abs(float(out[remat][0]) - float(out["none"][0])) <= REMAT_TOL
        for k, g in out[remat][1].items():
            assert _rel(g, out["none"][1][k]) <= REMAT_TOL, (remat, k)


def test_the_loop_trains_and_checkpoints_on_the_card(card):
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.training import LoopConfig, TrainLoop, build_train_step, init_train_state

    cfg = get_smoke("mamba2-2.7b")
    state = init_train_state(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    with tempfile.TemporaryDirectory() as td:
        loop = TrainLoop(build_train_step(cfg), DataConfig(cfg.vocab_size, 64, 4),
                         LoopConfig(total_steps=6, ckpt_every=3, ckpt_dir=td),
                         batch_fn=functools.partial(synthetic_batch, device="cuda"))
        before = ssd_intra.launches
        state, stats = loop.run(state)
        assert list_steps(td) == [3, 6]
    assert int(state.step) == 6 and stats.steps_done == 6
    assert ssd_intra.launches - before == 6 * 2 * cfg.n_layers
    assert all(np.isfinite(stats.losses))
    assert all(p.device.type == "cuda" for p in state.params.parameters())
