"""The port's dense decoders (``repro_torch.models`` on the four dense
configs) against the reference's ``repro.models`` on the CPU.

Both packages compute on the same weights: the reference draws them
(``init_params``; the QKV biases drawn as zeros are replaced by random
ones, so ``qwen2-1.5b``'s adds show), ``convert.lm_from_numpy`` carries
them across. Tokens are made with numpy from a seed. Each reference result
is computed once a module (fixture ``run``): forward in both modes at every
position, and STEPS decode steps. Tolerances, on max |port - ref| / max
|ref| over the real vocabulary's logits (the padded columns hold -1e30):
1e-4 in fp32 and 5e-2 in bf16, as ``tests/test_torch_mamba2.py``. The port's
own dualities (prefill against train, decode against train) hold to 1e-4
in fp32.
"""

from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_decode_state as ref_init_decode_state
from repro.models import init_params as ref_init_params
from repro_torch import configs, convert
from repro_torch.models import (
    ArchConfig,
    attention,
    decode_step,
    forward,
    init_decode_state,
    init_params,
)

NAMES = ("qwen2-1.5b", "deepseek-coder-33b", "yi-34b", "nemotron-4-340b")
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DUAL_TOL = 1e-4
B, S, STEPS = 2, 16, 16


def _rel(got: torch.Tensor, want) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _biased(params, cfg, seed: int):
    """The reference's parameters with random QKV biases where it has them."""
    if not cfg.qkv_bias:
        return params
    rng = np.random.default_rng(seed)
    attn = params["blocks"][0]["attn"]
    for k in ("bq", "bk", "bv"):
        attn[k] = jnp.asarray(rng.standard_normal(attn[k].shape, dtype=np.float32) * 0.5,
                              attn[k].dtype)
    return params


@pytest.fixture(scope="module", params=[(n, d) for n in NAMES for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    name, dtype = request.param
    ref_cfg = replace(ref_get_smoke(name), dtype=dtype)
    cfg = ArchConfig(**asdict(ref_cfg))
    params = _biased(ref_init_params(jax.random.PRNGKey(3), ref_cfg), cfg, 4)
    model = convert.lm_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    fwd = jax.jit(ref_forward, static_argnums=1, static_argnames=("mode",))
    ref = {mode: np.asarray(fwd(params, ref_cfg, {"tokens": jnp.asarray(tokens)}, mode=mode)[0],
                            np.float32) for mode in ("train", "prefill")}
    state = ref_init_decode_state(params, ref_cfg, B, S)
    step = jax.jit(ref_decode_step, static_argnums=1)
    ref_steps = []
    for t in range(STEPS):
        lg, state = step(params, ref_cfg, state, jnp.asarray(tokens[:, t:t + 1]))
        ref_steps.append(np.asarray(lg, np.float32))
    return {"name": name, "dtype": dtype, "cfg": cfg, "params": params, "model": model,
            "tokens": tokens, "ref": ref, "ref_steps": ref_steps}


def _tokens(run) -> torch.Tensor:
    return torch.from_numpy(run["tokens"]).long()


# --------------------------------------------------------------------------
# configuration and conversion
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_dense_configs_are_ported(name):
    assert name in configs.PORTED
    cfg = configs.get_config(name)
    assert cfg.family == "dense" and cfg.n_kv_heads < cfg.n_heads and cfg.d_ff


def test_converted_parameters_are_the_reference_leaves(run):
    model, params, cfg = run["model"], run["params"], run["cfg"]
    names = dict(model.named_parameters())
    per_layer = {"attn": 4 + 3 * cfg.qkv_bias, "mlp": 2 + (cfg.act == "silu_glu")}
    untied = 0 if cfg.tie_embeddings else 1
    assert len(names) == 2 + untied + cfg.n_layers * (2 + sum(per_layer.values()))
    for part in per_layer:
        for key, leaf in params["blocks"][0][part].items():
            for layer in range(cfg.n_layers):
                got = names[f"blocks.{layer}.{part}.{key}"]
                assert not got.requires_grad
                assert np.array_equal(got.float().numpy(), np.asarray(leaf[layer], np.float32))
    for key, leaf in params["embed"].items():
        assert np.array_equal(getattr(model.embed, key).float().numpy(),
                              np.asarray(leaf, np.float32))


# --------------------------------------------------------------------------
# forward and decode against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_all_positions(run, mode):
    cfg = run["cfg"]
    got, aux = forward(run["model"], cfg, {"tokens": _tokens(run)}, mode=mode)
    assert got.shape == (B, S, cfg.padded_vocab) and float(aux) == 0.0
    v = cfg.vocab_size
    assert bool((got[..., v:] == -1e30).all())
    assert _rel(got[..., :v], run["ref"][mode][..., :v]) <= TOL[run["dtype"]]


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_last_position(run, mode):
    cfg = run["cfg"]
    got, _ = forward(run["model"], cfg, {"tokens": _tokens(run)}, mode=mode,
                     logits_positions="last")
    assert got.shape == (B, 1, cfg.padded_vocab)
    v = cfg.vocab_size
    assert _rel(got[..., :v], run["ref"][mode][:, -1:, :v]) <= TOL[run["dtype"]]


def test_forward_takes_positions(run):
    """Explicit positions 0..S-1 are the default; shifted ones move RoPE and
    the mask as the reference's do."""
    cfg, tokens = run["cfg"], _tokens(run)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)) + np.array([[0], [3]], np.int32)
    default, _ = forward(run["model"], cfg, {"tokens": tokens})
    same, _ = forward(run["model"], cfg, {"tokens": tokens,
                                          "positions": torch.arange(S).expand(B, S)})
    assert torch.equal(default, same)
    got, _ = forward(run["model"], cfg, {"tokens": tokens, "positions": torch.from_numpy(pos)})
    want, _ = jax.jit(ref_forward, static_argnums=1)(
        run["params"], replace(ref_get_smoke(run["name"]), dtype=run["dtype"]),
        {"tokens": jnp.asarray(run["tokens"]), "positions": jnp.asarray(pos)})
    v = cfg.vocab_size
    assert _rel(got[..., :v], np.asarray(want, np.float32)[..., :v]) <= TOL[run["dtype"]]


def test_decode_steps(run):
    cfg = run["cfg"]
    state = init_decode_state(run["model"], cfg, B, S)
    assert all(isinstance(c, attention.KVCache) and c.k.shape == (B, S, cfg.n_kv_heads, cfg.hd)
               for c in state["caches"])
    v = cfg.vocab_size
    for t in range(STEPS):
        lg, state = decode_step(run["model"], cfg, state, _tokens(run)[:, t:t + 1])
        assert lg.shape == (B, 1, cfg.padded_vocab)
        assert _rel(lg[..., :v], run["ref_steps"][t][..., :v]) <= TOL[run["dtype"]]
    assert all(int(c.length) == STEPS for c in state["caches"])


# --------------------------------------------------------------------------
# the port's own dualities (fp32)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_train(name):
    cfg = replace(configs.get_smoke(name), dtype="float32")
    model = init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=torch.Generator().manual_seed(2))
    train, _ = forward(model, cfg, {"tokens": tokens})
    v = cfg.vocab_size
    pre, _ = forward(model, cfg, {"tokens": tokens}, mode="prefill")
    assert _rel(pre[..., :v], train[..., :v].numpy()) <= DUAL_TOL
    state = init_decode_state(model, cfg, 1, S)
    steps = []
    for t in range(S):
        lg, state = decode_step(model, cfg, state, tokens[:, t:t + 1])
        steps.append(lg[:, 0])
    assert _rel(torch.stack(steps, 1)[..., :v], train[..., :v].numpy()) <= DUAL_TOL


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def test_init_params_draws_the_reference_distributions():
    cfg = configs.get_smoke("qwen2-1.5b")
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    layer = model.blocks[0]
    assert layer.ssm is None and layer.attn.wq.shape == (cfg.d_model, cfg.n_heads, cfg.hd)
    assert layer.attn.wk.shape == (cfg.d_model, cfg.n_kv_heads, cfg.hd)
    assert all(float(getattr(layer.attn, b).abs().max()) == 0 for b in ("bq", "bk", "bv"))
    assert layer.mlp.wg.shape == (cfg.d_model, cfg.d_ff)
    assert abs(float(layer.attn.wq.float().std()) - cfg.d_model ** -0.5) < 0.03
    assert abs(float(layer.attn.wo.float().std()) - cfg.n_heads ** -0.5) < 0.05
    nemo = configs.get_smoke("nemotron-4-340b")
    mlp = init_params(nemo, generator=torch.Generator(), device="cpu").blocks[1].mlp
    assert mlp.wg is None and mlp.wi.shape == (nemo.d_model, nemo.d_ff)


def test_entry_points_reject_embeds():
    """Since the stub frontends are ported, ``embeds`` are no longer
    refused: as in the reference, they win over ``tokens`` whenever a batch
    carries them, on a decoder-only model without a frontend too, and a
    config with a frontend reads them (``KeyError`` without)."""
    name = "yi-34b"
    ref_cfg = replace(ref_get_smoke(name), dtype="float32")
    cfg = ArchConfig(**asdict(ref_cfg))
    params = ref_init_params(jax.random.PRNGKey(3), ref_cfg)
    model = convert.lm_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    rng = np.random.default_rng(7)
    embeds = rng.standard_normal((1, 8, cfg.d_model), dtype=np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    got, _ = forward(model, cfg, {"tokens": torch.from_numpy(tokens).long(),
                                  "embeds": torch.from_numpy(embeds)})
    want, _ = ref_forward(params, ref_cfg, {"tokens": jnp.asarray(tokens),
                                            "embeds": jnp.asarray(embeds)})
    v = cfg.vocab_size
    assert _rel(got[..., :v], np.asarray(want)[..., :v]) <= TOL["float32"]
    from_tokens, _ = forward(model, cfg, {"tokens": torch.from_numpy(tokens).long()})
    assert not torch.equal(got, from_tokens)
    with pytest.raises(KeyError, match="embeds"):
        forward(model, replace(cfg, frontend="vision_stub"),
                {"tokens": torch.zeros((1, 8), dtype=torch.long)})
