"""The port's training half of the model (``loss_fn``, the gradients,
``_remat``) and its train step (``build_train_step``) against the
reference's ``repro.models.loss_fn``, ``jax.value_and_grad`` and
``repro.training.build_train_step`` on the CPU.

Both packages start from the same state: the reference draws it,
``convert.lm_from_numpy`` and ``convert.train_state_from_numpy`` carry it
across. Batches are made with numpy from a seed. Tolerances, in fp32: the
loss within 1e-5 relative; each parameter's gradient within 1e-4 of the
largest magnitude of the reference's gradient of that leaf (sums in other
orders over a few layers). A leaf the loss does not read has a zero
gradient in both packages.

Through a router the comparison holds only where the routing cannot
differ (ROADMAP, Queue 1 item 15b): the hidden states reaching a router
differ between the packages by about 1e-6, so the port's smallest margin
over the run (the k-th against the (k+1)-th probability) is asserted at or
above ``MODEL_MARGIN`` (1e-4) first, as ``tests/test_torch_moe.py`` does.

Adam's first update is ``lr * sign(g)`` (plus decay), so a gradient that
is rounding noise may flip sign legitimately: the updated parameters are
compared only where the reference's gradient exceeds the gradient
tolerance, within 1e-6 of the leaf's largest magnitude plus 1e-5 of the
step's size ``lr`` (which is all of a leaf that starts at zero, as
``A_log`` does: there a gradient of 1e-7 against an ``eps`` of 1e-8 moves
its update by 1e-5 of lr for a relative change of 1e-4 in the gradient).
"""

from contextlib import contextmanager
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_smoke as ref_get_smoke
from repro.models import init_params as ref_init_params
from repro.models import loss_fn as ref_loss_fn
from repro.models.sharding import NULL
from repro.training import build_train_step as ref_build_train_step
from repro.training import init_train_state as ref_init_train_state
from repro_torch import convert
from repro_torch.models import ArchConfig, blocks, forward, loss_fn, moe, set_trainable
from repro_torch.training import build_train_step, init_train_state

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-6
STEP_TOL = 1e-5
REMAT_TOL = 1e-6
MODEL_MARGIN = 1e-4
B, S = 2, 16
#: As in tests/test_torch_moe.py: at this seed the MoE models' routers keep
#: their margins above MODEL_MARGIN.
BATCH_SEED = 6
LR = 1e-3


def _port_cfg(ref_cfg) -> ArchConfig:
    return ArchConfig(**asdict(ref_cfg))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed=BATCH_SEED, b=B, s=S) -> dict:
    """A training batch as numpy arrays: tokens (or a stub frontend's
    embeddings) and labels, for the encoder-decoder model decoder tokens
    and their labels."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend != "none":
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = "dec_labels" if cfg.is_encdec else "labels"
    if cfg.is_encdec:
        out["dec_tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out[labels] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return out


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _by_name(tree, cfg) -> dict:
    """A reference pytree shaped like the parameters (gradients, moments),
    keyed by the port's parameter names."""
    return {k: p.detach().numpy()
            for k, p in convert.lm_from_numpy(_numpy(tree), cfg, device="cpu").named_parameters()}


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@contextmanager
def _margins():
    """Every ``apply_moe`` call of the port's layers, watched: the list
    receives each call's smallest router margin."""
    seen = []
    real = blocks.apply_moe

    def watched(p, x, cfg, *args, **kw):
        seen.append(float(moe.routing_stats(p, x.detach(), cfg)[1]))
        return real(p, x, cfg, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocks, "apply_moe", watched)
        yield seen


def _precondition(name, margins):
    if margins:
        assert min(margins) >= MODEL_MARGIN, (
            f"{name}: the router's smallest margin {min(margins):.2e} is below "
            f"{MODEL_MARGIN}: a difference of 1e-6 could change a choice")


def _port_grads(model, cfg, batch):
    leaves = dict(model.named_parameters())
    loss, aux = loss_fn(model, cfg, _torch_batch(batch))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss, aux, {k: torch.zeros_like(p) if g is None else g
                       for (k, p), g in zip(leaves.items(), grads)}


# --------------------------------------------------------------------------
# loss_fn and every gradient, on all ten smoke configs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCH_NAMES)
def run(request):
    name = request.param
    ref_cfg = replace(ref_get_smoke(name), dtype="float32")
    cfg = _port_cfg(ref_cfg)
    params = ref_init_params(jax.random.PRNGKey(3), ref_cfg)
    batch = _batch(cfg)
    (ref_loss, ref_aux), ref_grads = jax.value_and_grad(ref_loss_fn, has_aux=True)(
        params, ref_cfg, _jax_batch(batch))
    model = set_trainable(convert.lm_from_numpy(_numpy(params), cfg, device="cpu"))
    with _margins() as seen:
        loss, aux, grads = _port_grads(model, cfg, batch)
    return {"name": name, "cfg": cfg, "batch": batch, "model": model,
            "ref": (float(ref_loss), {k: float(v) for k, v in ref_aux.items()},
                    _by_name(ref_grads, cfg)),
            "got": (loss, aux, grads), "margins": seen}


def test_loss_matches_the_reference(run):
    _precondition(run["name"], run["margins"])
    ref_loss, ref_aux, _ = run["ref"]
    loss, aux, _ = run["got"]
    assert loss.dtype == torch.float32 and loss.requires_grad
    nll, moe_aux = float(aux["nll"].detach()), float(aux["aux"].detach())
    assert abs(float(loss.detach()) - ref_loss) <= LOSS_TOL * abs(ref_loss)
    assert abs(nll - ref_aux["nll"]) <= LOSS_TOL * abs(ref_aux["nll"])
    assert abs(moe_aux - ref_aux["aux"]) <= LOSS_TOL * max(abs(ref_aux["aux"]), 1.0)
    assert (ref_aux["aux"] > 0) == bool(run["margins"])  # an aux loss exactly where MoE is


def test_every_gradient_matches_the_reference(run):
    _precondition(run["name"], run["margins"])
    want = run["ref"][2]
    grads = run["got"][2]
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert g.dtype == run["model"].get_parameter(k).dtype
        if not np.abs(want[k]).any():  # a leaf the loss does not read
            assert not bool(g.abs().any()), k
            continue
        assert _rel(g, want[k]) <= GRAD_TOL, k


def test_the_fp32_leaves_train_too(run):
    grads = run["got"][2]
    for k, p in run["model"].named_parameters():
        assert p.requires_grad, k
    fp32 = [k for k in grads if k.rsplit(".", 1)[1] in ("router", "A_log", "D", "dt_bias")]
    assert all(bool(grads[k].abs().any()) for k in fp32)


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mamba2-2.7b", "jamba-v0.1-52b", "whisper-tiny"])
def test_the_three_remat_modes_give_the_same_gradients(name):
    base = replace(ref_get_smoke(name), dtype="float32")
    params = _numpy(ref_init_params(jax.random.PRNGKey(3), base))
    batch = _batch(_port_cfg(base))
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = _port_cfg(replace(base, remat=remat))
        model = set_trainable(convert.lm_from_numpy(params, cfg, device="cpu"))
        out[remat] = _port_grads(model, cfg, batch)
    for remat in ("full", "dots"):
        assert abs(float(out[remat][0].detach()) - float(out["none"][0].detach())) <= REMAT_TOL
        for k, g in out[remat][2].items():
            assert _rel(g, out["none"][2][k].numpy()) <= REMAT_TOL, (remat, k)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_remat_checkpoints_each_group_only_under_autograd(remat, monkeypatch):
    cfg = _port_cfg(replace(ref_get_smoke("jamba-v0.1-52b"), dtype="float32", remat=remat))
    params = _numpy(ref_init_params(jax.random.PRNGKey(3), replace(ref_get_smoke(
        "jamba-v0.1-52b"), dtype="float32")))
    model = set_trainable(convert.lm_from_numpy(params, cfg, device="cpu"))
    calls = []
    real = blocks.checkpoint

    def counted(fn, *args, **kw):
        calls.append(kw.get("context_fn") is not None)
        return real(fn, *args, **kw)

    monkeypatch.setattr(blocks, "checkpoint", counted)
    batch = _torch_batch(_batch(cfg))
    forward(model, cfg, batch)  # serving: no checkpoint
    assert calls == []
    loss_fn(model, cfg, batch)
    groups = -(-cfg.n_layers // cfg.block_period)
    assert calls == ([] if remat == "none" else [remat == "dots"] * groups)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def _steps(name, microbatches):
    ref_cfg = replace(ref_get_smoke(name), dtype="float32")
    cfg = _port_cfg(ref_cfg)
    ref_state = ref_init_train_state(jax.random.PRNGKey(4), ref_cfg)
    state = convert.train_state_from_numpy(_numpy(ref_state), cfg, device="cpu")
    batch = _batch(cfg, b=4)
    ref_step = ref_build_train_step(ref_cfg, NULL, microbatches=microbatches,
                                    lr_fn=lambda s: jnp.float32(LR) + 0 * s)
    ref_new, ref_metrics = jax.jit(ref_step)(ref_state, _jax_batch(batch))
    ref_grads = jax.grad(lambda p: ref_loss_fn(p, ref_cfg, _jax_batch(batch))[0])(
        ref_state.params)
    step = build_train_step(cfg, microbatches=microbatches,
                            lr_fn=lambda s: torch.tensor(LR) + 0 * s)
    with _margins() as seen:
        new, metrics = step(state, _torch_batch(batch))
    _precondition(name, seen)
    return cfg, ref_new, ref_metrics, _by_name(ref_grads, cfg), new, metrics


@pytest.mark.parametrize("name,microbatches", [("mamba2-2.7b", 1), ("mamba2-2.7b", 2),
                                               ("olmoe-1b-7b", 1)])
def test_train_step_matches_the_reference(name, microbatches):
    cfg, ref_new, ref_metrics, ref_grads, new, metrics = _steps(name, microbatches)
    assert int(new.step) == int(ref_new.step) == 1
    assert int(new.opt.step) == 1
    for key in ("loss", "grad_norm", "clip_scale", "lr"):
        assert abs(float(metrics[key]) - float(ref_metrics[key])) <= LOSS_TOL * abs(
            float(ref_metrics[key])), key
    want = _by_name(ref_new.params, cfg)
    moments = {"m": _by_name(ref_new.opt.m, cfg), "v": _by_name(ref_new.opt.v, cfg)}
    for k, p in new.params.named_parameters():
        g = np.abs(ref_grads[k])
        sure = g > GRAD_TOL * max(float(g.max()), 1e-30)
        got = p.detach().numpy()
        limit = PARAM_TOL * float(np.abs(want[k]).max()) + STEP_TOL * LR
        assert float(np.abs(got - want[k])[sure].max(initial=0.0)) <= limit, k
        for which, ref_m in moments.items():
            m = getattr(new.opt, which)[k].numpy()
            assert _rel(torch.from_numpy(m), ref_m[k]) <= GRAD_TOL, (which, k)


def test_train_state_from_numpy_carries_every_leaf():
    ref_cfg = replace(ref_get_smoke("jamba-v0.1-52b"), dtype="float32")
    cfg = _port_cfg(ref_cfg)
    ref_state = _numpy(ref_init_train_state(jax.random.PRNGKey(4), ref_cfg))
    state = convert.train_state_from_numpy(ref_state, cfg, device="cpu")
    names = [k for k, _ in state.params.named_parameters()]
    assert list(state.opt.m) == list(state.opt.v) == names
    assert state.opt.master is None
    assert int(state.step) == int(state.opt.step) == 0
    want = _by_name(ref_state.params, cfg)
    for k, p in state.params.named_parameters():
        assert p.requires_grad and np.array_equal(p.detach().numpy(), want[k]), k
        assert state.opt.m[k].shape == p.shape and not bool(state.opt.m[k].any()), k


def test_a_frozen_model_does_not_train():
    cfg = _port_cfg(replace(ref_get_smoke("mamba2-2.7b"), dtype="float32"))
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    set_trainable(state.params, False)
    with pytest.raises(ValueError, match="ask for no gradient"):
        build_train_step(cfg)(state, _torch_batch(_batch(cfg)))


def test_a_batch_that_does_not_split_raises():
    cfg = _port_cfg(replace(ref_get_smoke("mamba2-2.7b"), dtype="float32"))
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="not a multiple"):
        build_train_step(cfg, microbatches=3)(state, _torch_batch(_batch(cfg)))


def test_training_on_the_card_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = _port_cfg(ref_get_smoke("mamba2-2.7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg, generator=torch.Generator().manual_seed(0))
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "mamba2-2.7b", "--smoke", "--steps", "1"])


def test_steps_lower_the_loss_on_a_fixed_batch():
    cfg = _port_cfg(replace(ref_get_smoke("mamba2-2.7b"), dtype="float32"))
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    step = build_train_step(cfg, lr_fn=lambda s: torch.tensor(1e-2))
    batch = _torch_batch(_batch(cfg))
    losses = []
    for _ in range(5):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert int(state.step) == 5 and losses[-1] < losses[0]
