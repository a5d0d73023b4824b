"""The port's training substrate (``repro_torch.optim``, ``data``,
``checkpoint``, ``training.loop``) against the reference's on the CPU.

Inputs are made with numpy from a seed and given to both packages.
Tolerances: AdamW in fp32 within 1e-6 of each leaf's largest magnitude
(the same operations, rounded alike); a bf16 parameter or moment within one
bf16 ulp (their bit patterns at most 1 apart), since both round the same
fp32 value and the fp32 values differ in their last bits; the schedules
within 1e-6 of the peak. The data cannot be the reference's (JAX's PRNG
is not reproduced), so it is held to the reference's properties: the same
bigram table, deterministic and resumable, labels shifted, and the share of
chained tokens within 0.03 of ``structure`` (3 standard deviations over
2,040 draws). Checkpoints are held to the reference's on-disk format: the
reference's checksum of the same arrays, and each package reading what the
other wrote. The reference's four loop tests are ported, each on a copy of
one state (the step updates its state in place).
"""

import copy
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_latest as ref_restore_latest
from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.checkpoint.manager import _checksum as ref_checksum
from repro.data.pipeline import _bigram_table as ref_bigram_table
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import cosine_schedule as ref_cosine_schedule
from repro.optim import linear_warmup as ref_linear_warmup
from repro_torch.checkpoint import CheckpointManager, list_steps, restore_latest, save_checkpoint
from repro_torch.checkpoint.manager import _checksum
from repro_torch.configs import get_smoke
from repro_torch.data import DataConfig, batch_iterator, synthetic_batch
from repro_torch.data.pipeline import _bigram_table
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule, linear_warmup
from repro_torch.training import LoopConfig, TrainLoop, build_train_step, init_train_state

F32_TOL = 1e-6
SCHEDULE_TOL = 1e-6
CHAIN_TOL = 0.03


def _tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _bits(a) -> np.ndarray:
    """A bf16 array's bit patterns as int32 (sign-magnitude made monotone)."""
    if isinstance(a, torch.Tensor):
        u = a.detach().view(torch.int16).numpy().view(np.uint16)
    else:
        u = np.asarray(a).view(np.uint16)
    u = u.astype(np.int32)
    return np.where(u & 0x8000, -(u & 0x7FFF), u)


def _close(got: torch.Tensor, want) -> None:
    """fp32 within F32_TOL of the largest magnitude; bf16 within one ulp."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    if got.dtype == torch.bfloat16:
        assert want.dtype == jnp.bfloat16
        assert int(np.abs(_bits(got) - _bits(want)).max(initial=0)) <= 1
    else:
        w = want.astype(np.float32)
        assert float(np.abs(got.numpy() - w).max()) <= F32_TOL * max(float(np.abs(w).max()), 1.0)


def _problem(dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (5, 7), "b": (7,), "e": (3, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (0.3 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ({k: jnp.asarray(v, jdt) for k, v in params.items()},
            {k: _tensor(v, dtype) for k, v in params.items()},
            [({k: jnp.asarray(v, jdt) for k, v in g.items()},
              {k: _tensor(v, dtype) for k, v in g.items()}) for g in grads])


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

CASES = {
    "fp32": dict(dtype=torch.float32),
    "fp32_clipped": dict(dtype=torch.float32, clip_norm=0.2),
    "bf16": dict(dtype=torch.bfloat16),
    "bf16_moments": dict(dtype=torch.bfloat16, moment_dtype=torch.bfloat16),
    "bf16_master": dict(dtype=torch.bfloat16, keep_master=True),
    "fp32_schedule_lr": dict(dtype=torch.float32, lr="schedule"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_adamw_matches_the_reference(case):
    opts = CASES[case]
    dtype = opts["dtype"]
    moment_dtype = opts.get("moment_dtype", torch.float32)
    keep_master = opts.get("keep_master", False)
    clip_norm = opts.get("clip_norm", 1.0)
    ref_p, p, grads = _problem(dtype)
    ref_state = ref_adamw_init(ref_p, keep_master=keep_master,
                               moment_dtype=jnp.bfloat16 if moment_dtype == torch.bfloat16
                               else jnp.float32)
    state = adamw_init(p, keep_master=keep_master, moment_dtype=moment_dtype)
    for i, (ref_g, g) in enumerate(grads):
        if opts.get("lr") == "schedule":
            ref_lr, lr = ref_cosine_schedule(i, 0.05, 2, 10), cosine_schedule(i, 0.05, 2, 10)
        else:
            ref_lr = lr = 0.01
        ref_p, ref_state, ref_m = ref_adamw_update(ref_p, ref_g, ref_state, ref_lr,
                                                   clip_norm=clip_norm)
        p, state, metrics = adamw_update(p, g, state, lr, clip_norm=clip_norm)
        for key in ("grad_norm", "clip_scale"):
            assert abs(float(metrics[key]) - float(ref_m[key])) <= F32_TOL * float(ref_m[key])
        assert int(state.step) == int(ref_state.step) == i + 1
        for k in p:
            assert p[k].dtype == dtype and state.m[k].dtype == moment_dtype
            _close(p[k], ref_p[k])
            _close(state.m[k], ref_state.m[k])
            _close(state.v[k], ref_state.v[k])
            if keep_master:
                _close(state.master[k], ref_state.master[k])
    if case == "fp32_clipped":
        assert float(metrics["clip_scale"]) < 1.0


def test_adamw_updates_in_place_after_reading_every_gradient():
    _, p, grads = _problem(torch.float32)
    before = {k: v.clone() for k, v in p.items()}
    state = adamw_init(p)
    m_ids = {k: id(v) for k, v in state.m.items()}
    out, new, _ = adamw_update(p, grads[0][1], state, 0.01)
    assert out is p and {k: id(v) for k, v in new.m.items()} == m_ids
    assert all(not torch.equal(p[k], before[k]) for k in p)
    with pytest.raises(ValueError, match="missing or unexpected"):
        adamw_update(p, {"w": grads[1][1]["w"]}, new, 0.01)
    assert int(new.step) == 1


def test_adamw_clipping():
    p = {"w": torch.ones(4)}
    _, _, metrics = adamw_update(p, {"w": torch.full((4,), 100.0)}, adamw_init(p), 0.1,
                                 clip_norm=1.0)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert float(metrics["clip_scale"]) == pytest.approx(1 / 200.0)


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 5), (0, 1), (20, 20)])
def test_schedules_match_the_reference(warmup, total):
    for s in range(total + 5):
        assert abs(float(linear_warmup(s, warmup, 0.3)) - float(ref_linear_warmup(s, warmup, 0.3))
                   ) <= SCHEDULE_TOL * 0.3
        got = cosine_schedule(torch.tensor(s, dtype=torch.int32), 0.3, warmup, total)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(ref_cosine_schedule(s, 0.3, warmup, total))
                   ) <= SCHEDULE_TOL * 0.3


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seed", [(100, 7), (50, 3), (50_280, 0)])
def test_the_bigram_table_is_the_references(vocab, seed):
    assert np.array_equal(_bigram_table(vocab, seed), ref_bigram_table(vocab, seed))


def test_data_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=4, seed=7)
    b1 = synthetic_batch(cfg, 5, device="cpu")
    b2 = synthetic_batch(cfg, 5, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"]) and torch.equal(b1["labels"], b2["labels"])
    it = batch_iterator(cfg, start_step=5, device="cpu")
    step, b3 = next(it)
    assert step == 5 and torch.equal(b1["tokens"], b3["tokens"])
    assert next(it)[0] == 6
    assert not torch.equal(synthetic_batch(cfg, 6, device="cpu")["tokens"], b1["tokens"])
    other = DataConfig(vocab_size=100, seq_len=32, global_batch=4, seed=8)
    assert not torch.equal(synthetic_batch(other, 5, device="cpu")["tokens"], b1["tokens"])
    assert b1["tokens"].dtype == torch.int64 and b1["tokens"].shape == (4, 32)
    assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < 100


def test_labels_are_shifted_tokens():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=2, seed=0)
    b = synthetic_batch(cfg, 1, device="cpu")
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert torch.equal(b["labels"][:, -1], b["tokens"][:, 0])  # wraps at the end


@pytest.mark.parametrize("structure", [1.0, 0.8, 0.3])
def test_the_chain_share_is_near_structure(structure):
    cfg = DataConfig(vocab_size=50, seq_len=256, global_batch=8, seed=3, structure=structure)
    toks = synthetic_batch(cfg, 0, device="cpu")["tokens"].numpy()
    table = _bigram_table(50, 3)
    chained = (toks[:, 1:] == table[toks[:, :-1]]).mean()
    # a noise token matches the chain by chance one time in V
    expect = structure + (1 - structure) / 50
    assert abs(chained - expect) <= CHAIN_TOL


def test_data_on_the_card_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_batch(DataConfig(vocab_size=10, seq_len=4, global_batch=1), 0)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _tree():
    return {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "nested": {"b": torch.linspace(-1, 3, 4).to(torch.bfloat16)},
        "step": torch.tensor(3, dtype=torch.int32),
    }


def _ref_tree():
    t = _tree()
    return {"a": jnp.asarray(t["a"].numpy()),
            "nested": {"b": jnp.asarray(t["nested"]["b"].float().numpy(), jnp.bfloat16)},
            "step": jnp.asarray(3, jnp.int32)}


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip():
    with tempfile.TemporaryDirectory() as td:
        tree = _tree()
        save_checkpoint(td, 3, tree)
        step, restored = restore_latest(td, tree)
        assert step == 3
        assert _same(restored["a"], tree["a"]) and _same(restored["step"], tree["step"])
        assert _same(restored["nested"]["b"], tree["nested"]["b"])


def test_checkpoint_integrity_check():
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, 1, _tree())
        path = os.path.join(td, "step_1", "arrays.npz")
        data = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(data[:len(data) // 2])
        with pytest.raises(Exception):
            restore_latest(td, _tree())


def test_checkpoint_detects_changed_content():
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, 1, _tree())
        path = os.path.join(td, "step_1", "arrays.npz")
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        arrays["a"] = arrays["a"] + 1
        np.savez(path, **arrays)
        with pytest.raises(IOError, match="integrity"):
            restore_latest(td, _tree())


def test_checkpoint_missing_leaf_raises():
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, 1, {"a": torch.ones(2)})
        with pytest.raises(KeyError, match="missing leaf"):
            restore_latest(td, _tree())


def test_checkpoint_keep_k_gc():
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _tree())
        assert list_steps(td) == [3, 4] and mgr.saved_steps == [3, 4]


def test_checkpoint_async_save_snapshots_before_an_in_place_update():
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td, keep=3)
        tree = _tree()
        want = copy.deepcopy(tree)
        mgr.save_async(7, tree)
        tree["a"].add_(100.0)  # the optimizer's in-place update, while the thread writes
        tree["nested"]["b"].mul_(2)
        mgr.wait()
        step, restored = mgr.restore_latest(_tree())
        assert step == 7
        assert _same(restored["a"], want["a"]) and _same(restored["nested"]["b"],
                                                         want["nested"]["b"])


def test_atomicity_no_partial_dirs():
    with tempfile.TemporaryDirectory() as td:
        os.makedirs(os.path.join(td, "step_9.tmp"))
        assert list_steps(td) == []
        assert restore_latest(td, _tree()) == (None, None)


def test_checksum_equals_the_references():
    arrays = {"a": np.arange(10_000, dtype=np.float32).reshape(100, 100),
              "b": np.ones((3,), np.uint16), "c/d": np.asarray(5, np.int32)}
    assert _checksum(arrays) == ref_checksum(arrays)


def test_the_port_reads_what_the_reference_wrote():
    with tempfile.TemporaryDirectory() as td:
        ref_save_checkpoint(td, 11, _ref_tree(), extra={"note": "reference"})
        step, restored = restore_latest(td, _tree())
        assert step == 11
        want = _tree()
        assert _same(restored["a"], want["a"]) and _same(restored["step"], want["step"])
        assert _same(restored["nested"]["b"], want["nested"]["b"])


def test_the_reference_reads_what_the_port_wrote():
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, 12, _tree())
        step, restored = ref_restore_latest(td, _ref_tree())
        assert step == 12
        want = _ref_tree()
        for k in ("a", "step"):
            assert np.array_equal(np.asarray(restored[k]), np.asarray(want[k]))
        b = np.asarray(restored["nested"]["b"])
        assert b.dtype == ml_dtypes.bfloat16
        assert np.array_equal(b.view(np.uint16), np.asarray(want["nested"]["b"]).view(np.uint16))


def test_a_train_state_round_trips():
    cfg = get_smoke("mamba2-2.7b")
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, 0, state)
        _, restored = restore_latest(td, state)
    assert type(restored) is type(state) and restored.params is not state.params
    for (k, p), (k2, q) in zip(state.params.named_parameters(),
                               restored.params.named_parameters()):
        assert k == k2 and _same(p.detach(), q.detach()) and q.requires_grad
        assert _same(state.opt.m[k], restored.opt.m[k])
    assert restored.opt.master is None and _same(restored.step, state.step)


# --------------------------------------------------------------------------
# the fault-tolerant loop (the reference's four tests, ported)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_setup():
    cfg = get_smoke("qwen2-1.5b")
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    step = build_train_step(cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    return cfg, state, step, data


def _loop(step, data, **kw) -> TrainLoop:
    return TrainLoop(step, data, LoopConfig(**kw),
                     batch_fn=functools.partial(synthetic_batch, device="cpu"))


def test_loop_trains_and_checkpoints(tiny_setup):
    cfg, state, step, data = tiny_setup
    with tempfile.TemporaryDirectory() as td:
        loop = _loop(step, data, total_steps=8, ckpt_every=4, ckpt_dir=td)
        state2, stats = loop.run(copy.deepcopy(state))
        assert stats.steps_done == 8
        assert int(state2.step) == 8
        assert list_steps(td) == [4, 8]


def test_loop_recovers_from_failure(tiny_setup):
    cfg, state, step, data = tiny_setup
    with tempfile.TemporaryDirectory() as td, tempfile.TemporaryDirectory() as td2:
        crashed = {"n": 0}

        def fail(s):
            if s == 6 and crashed["n"] == 0:
                crashed["n"] = 1
                raise RuntimeError("injected node failure")

        loop = _loop(step, data, total_steps=10, ckpt_every=5, ckpt_dir=td)
        state2, stats = loop.run(copy.deepcopy(state), fail_injector=fail)
        assert stats.restarts == 1
        assert int(state2.step) == 10  # resumed from step-5 ckpt, finished
        clean, _ = _loop(step, data, total_steps=10, ckpt_every=5, ckpt_dir=td2).run(
            copy.deepcopy(state))
    for (k, p), q in zip(state2.params.named_parameters(), clean.params.parameters()):
        a, b = p.detach().float(), q.detach().float()
        assert float((a - b).abs().max()) <= F32_TOL * max(float(b.abs().max()), 1.0), k


def test_loop_gives_up_after_max_restarts(tiny_setup):
    cfg, state, step, data = tiny_setup
    with tempfile.TemporaryDirectory() as td:
        def always_fail(s):
            raise RuntimeError("hard failure")

        loop = _loop(step, data, total_steps=4, ckpt_every=2, ckpt_dir=td, max_restarts=2)
        with pytest.raises(RuntimeError):
            loop.run(copy.deepcopy(state), fail_injector=always_fail)
        assert loop.stats.restarts == 3  # 2 allowed + the final raise


def test_loop_resumes_across_instances(tiny_setup):
    cfg, state, step, data = tiny_setup
    with tempfile.TemporaryDirectory() as td:
        _loop(step, data, total_steps=6, ckpt_every=3, ckpt_dir=td).run(copy.deepcopy(state))
        loop2 = _loop(step, data, total_steps=9, ckpt_every=3, ckpt_dir=td)
        state2, stats2 = loop2.run(copy.deepcopy(state))
        assert int(state2.step) == 9
        assert stats2.steps_done == 3  # only 6->9 executed


def test_a_restart_without_a_checkpoint_keeps_the_state_and_starts_at_zero(tiny_setup):
    cfg, state, step, data = tiny_setup
    with tempfile.TemporaryDirectory() as td:
        seen = []

        def fail(s):
            seen.append(s)
            if len(seen) == 2:  # at step 1, before any checkpoint
                raise RuntimeError("injected")

        loop = _loop(step, data, total_steps=3, ckpt_every=10, ckpt_dir=td)
        state2, stats = loop.run(copy.deepcopy(state), fail_injector=fail)
        assert seen == [0, 1, 0, 1, 2] and stats.restarts == 1
        # the reference's quirk: the state was not rolled back, so the step
        # counter holds every step taken
        assert stats.steps_done == 4 and int(state2.step) == 4
