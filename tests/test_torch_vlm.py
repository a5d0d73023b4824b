"""The port's VLM backbone (``qwen2-vl-72b``'s smoke config: GQA 4 heads on
2 with QKV biases, M-RoPE, a stub vision frontend whose inputs are patch
embeddings) against the reference's ``repro.models`` on the CPU, and the
registry's ten names against the reference's.

Both packages compute on the same weights: the reference draws them
(``init_params``; the QKV biases drawn as zeros are replaced by random
ones, so the adds show), ``convert.lm_from_numpy`` carries them across.
Patch embeddings and tokens are made with numpy from a seed. Each reference
result is computed once a module (fixture ``run``). Tolerances, on max
|port - ref| / max |ref| over the real vocabulary's logits (the padded
columns hold -1e30): 1e-4 in fp32 and 5e-2 in bf16, as
``tests/test_torch_dense_lm.py``; cross-attention alone 1e-5 in fp32.

As in the reference, ``embeds`` win over ``tokens`` whenever a batch
carries them, for any model; M-RoPE's three-section positions (B, S, 3)
cannot pass through ``forward`` (the reference raises in both modes; the
port raises ``ValueError``), so the model serves on (B, S) positions,
where M-RoPE is RoPE.
"""

from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.models import attention as ref_attn
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

NAME = "qwen2-vl-72b"
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ATTN_TOL = 1e-5
B, S, STEPS = 2, 16, 8


def _rel(got: torch.Tensor, want) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _cfgs(dtype: str = "float32", name: str = NAME):
    ref = replace(ref_get_smoke(name), dtype=dtype)
    return ref, ArchConfig(**asdict(ref))


def _biased(params, seed: int):
    rng = np.random.default_rng(seed)
    for pos in params["blocks"]:
        attn = pos["attn"]
        for k in ("bq", "bk", "bv"):
            attn[k] = jnp.asarray(rng.standard_normal(attn[k].shape, dtype=np.float32) * 0.5,
                                  attn[k].dtype)
    return params


def _models(dtype: str, name: str = NAME):
    ref_cfg, cfg = _cfgs(dtype, name)
    params = ref_init_params(jax.random.PRNGKey(3), ref_cfg)
    if cfg.qkv_bias:
        params = _biased(params, 4)
    model = convert.lm_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return ref_cfg, cfg, params, model


def _embeds(cfg, dtype="float32", seed: int = 5) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model), dtype=np.float32)
    return x.astype(jnp.dtype(dtype))


FWD = jax.jit(ref_forward, static_argnums=1, static_argnames=("mode", "logits_positions"))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def run(request):
    dtype = request.param
    ref_cfg, cfg, params, model = _models(dtype)
    embeds = _embeds(cfg, dtype)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    ref = {mode: np.asarray(FWD(params, ref_cfg, {"embeds": jnp.asarray(embeds)}, mode=mode)[0],
                            np.float32) for mode in ("train", "prefill")}
    state = ref_init_decode_state(params, ref_cfg, B, S)
    step = jax.jit(ref_decode_step, static_argnums=1)
    ref_steps = []
    for t in range(STEPS):
        lg, state = step(params, ref_cfg, state, jnp.asarray(tokens[:, t:t + 1]))
        ref_steps.append(np.asarray(lg, np.float32))
    return {"dtype": dtype, "ref_cfg": ref_cfg, "cfg": cfg, "params": params, "model": model,
            "embeds": embeds, "tokens": tokens, "ref": ref, "ref_steps": ref_steps}


def _port_embeds(run) -> torch.Tensor:
    return convert.tensor_from_numpy(run["embeds"], "cpu")


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_every_name_gives_the_reference_configs(name):
    assert configs.ARCH_NAMES == ARCH_NAMES and name in configs.PORTED
    assert asdict(configs.get_config(name)) == asdict(ref_get_config(name))
    assert asdict(configs.get_smoke(name)) == asdict(ref_get_smoke(name))
    for get, ref_get in ((configs.get_config, ref_get_config),
                         (configs.get_smoke, ref_get_smoke)):
        assert get(name).param_count() == ref_get(name).param_count()


def test_qwen2_vl_is_ported():
    cfg = configs.get_config(NAME)
    assert cfg.family == "vlm" and cfg.frontend == "vision_stub" and cfg.mrope
    assert cfg.qkv_bias and cfg.n_kv_heads < cfg.n_heads and not cfg.is_encdec
    smoke = configs.get_smoke(NAME)
    assert (smoke.n_heads, smoke.n_kv_heads) == (4, 2)


def test_converted_parameters_are_the_reference_leaves(run):
    model, params, cfg = run["model"], run["params"], run["cfg"]
    names = dict(model.named_parameters())
    assert len(names) == 3 + cfg.n_layers * (2 + 7 + 3)  # table, head, final norm; layers
    assert sum(t.numel() for t in names.values()) == sum(
        leaf.size for leaf in jax.tree.leaves(params))
    for part in ("attn", "mlp"):
        for key, leaf in params["blocks"][0][part].items():
            for layer in range(cfg.n_layers):
                got = names[f"blocks.{layer}.{part}.{key}"]
                assert np.array_equal(got.float().numpy(), np.asarray(leaf[layer], np.float32))


# --------------------------------------------------------------------------
# cross-attention on a GQA config with QKV biases
# --------------------------------------------------------------------------

def test_cross_attention_against_the_reference():
    """``kv_override`` on qwen2-vl's smoke widths: 4 query heads read 2
    given kv heads, Q carries its bias, K and V carry none."""
    ref_cfg, cfg = _cfgs()
    rng = np.random.default_rng(1)
    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    tree = {k: (rng.standard_normal(shape, dtype=np.float32) / np.sqrt(fan)).astype(np.float32)
            for k, shape, fan in (("wq", (d, h, hd), d), ("wk", (d, kv, hd), d),
                                  ("wv", (d, kv, hd), d), ("wo", (h, hd, d), h * hd),
                                  ("bq", (h, hd), 4), ("bk", (kv, hd), 4), ("bv", (kv, hd), 4))}
    x = rng.standard_normal((B, S, d), dtype=np.float32)
    k_enc = rng.standard_normal((B, 24, kv, hd), dtype=np.float32)
    v_enc = rng.standard_normal((B, 24, kv, hd), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want = ref_attn.attention({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x),
                              ref_cfg, jnp.asarray(pos),
                              kv_override=(jnp.asarray(k_enc), jnp.asarray(v_enc)))
    p = attention.Attention({k: torch.from_numpy(v) for k, v in tree.items()})
    got = attention.attention(p, torch.from_numpy(x), cfg, torch.from_numpy(pos),
                              kv_override=(torch.from_numpy(k_enc), torch.from_numpy(v_enc)))
    assert _rel(got, want) <= ATTN_TOL


# --------------------------------------------------------------------------
# forward from embeds, and decode, against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_from_embeds(run, mode):
    cfg = run["cfg"]
    got, aux = forward(run["model"], cfg, {"embeds": _port_embeds(run)}, mode=mode)
    assert got.shape == (B, S, cfg.padded_vocab) and float(aux) == 0.0
    assert got.dtype == run["model"].embed.table.dtype
    v = cfg.vocab_size
    assert bool((got[..., v:] == -1e30).all())
    assert _rel(got[..., :v], run["ref"][mode][..., :v]) <= TOL[run["dtype"]]


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_last_position(run, mode):
    cfg = run["cfg"]
    got, _ = forward(run["model"], cfg, {"embeds": _port_embeds(run)}, mode=mode,
                     logits_positions="last")
    assert got.shape == (B, 1, cfg.padded_vocab)
    v = cfg.vocab_size
    assert _rel(got[..., :v], run["ref"][mode][:, -1:, :v]) <= TOL[run["dtype"]]


def test_forward_takes_shifted_positions(run):
    """(B, S) positions from an offset move M-RoPE (here RoPE) and the mask
    as the reference's do."""
    cfg = run["cfg"]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)) + np.array([[0], [3]], np.int32)
    want = FWD(run["params"], run["ref_cfg"],
               {"embeds": jnp.asarray(run["embeds"]), "positions": jnp.asarray(pos)})[0]
    got, _ = forward(run["model"], cfg, {"embeds": _port_embeds(run),
                                         "positions": torch.from_numpy(pos)})
    v = cfg.vocab_size
    assert _rel(got[..., :v], np.asarray(want, np.float32)[..., :v]) <= TOL[run["dtype"]]


def test_decode_steps(run):
    """Decode reads tokens (the stub frontend feeds only the prompt)."""
    cfg = run["cfg"]
    state = init_decode_state(run["model"], cfg, B, S)
    v = cfg.vocab_size
    tokens = torch.from_numpy(run["tokens"]).long()
    for t in range(STEPS):
        lg, state = decode_step(run["model"], cfg, state, tokens[:, t:t + 1])
        assert _rel(lg[..., :v], run["ref_steps"][t][..., :v]) <= TOL[run["dtype"]]
    assert all(int(c.length) == STEPS for c in state["caches"])


def test_embeds_win_over_tokens(run):
    """A batch with both reads the embeds, in both packages."""
    cfg = run["cfg"]
    tokens = run["tokens"]
    got, _ = forward(run["model"], cfg, {"embeds": _port_embeds(run),
                                         "tokens": torch.from_numpy(tokens).long()})
    alone, _ = forward(run["model"], cfg, {"embeds": _port_embeds(run)})
    assert torch.equal(got, alone)
    want = FWD(run["params"], run["ref_cfg"], {"embeds": jnp.asarray(run["embeds"]),
                                               "tokens": jnp.asarray(tokens)})[0]
    assert np.array_equal(np.asarray(want, np.float32), run["ref"]["train"])


def test_a_frontend_needs_embeds():
    """A config with a frontend reads ``embeds`` even where the batch has
    only tokens: ``KeyError`` in both packages."""
    ref_cfg, cfg, params, model = _models("float32")
    tokens = np.zeros((B, S), np.int32)
    with pytest.raises(KeyError, match="embeds"):
        ref_forward(params, ref_cfg, {"tokens": jnp.asarray(tokens)})
    with pytest.raises(KeyError, match="embeds"):
        forward(model, cfg, {"tokens": torch.from_numpy(tokens).long()})


# --------------------------------------------------------------------------
# positions, dtypes and refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_three_section_positions_raise(mode):
    ref_cfg, cfg, params, model = _models("float32")
    embeds = _embeds(cfg)
    pos = np.stack([np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))] * 3, -1)
    with pytest.raises((ValueError, TypeError)):
        ref_forward(params, ref_cfg, {"embeds": jnp.asarray(embeds),
                                      "positions": jnp.asarray(pos)}, mode=mode)
    with pytest.raises(ValueError, match=r"positions of shape \(2, 16, 3\)"):
        forward(model, cfg, {"embeds": torch.from_numpy(embeds),
                             "positions": torch.from_numpy(pos)}, mode=mode)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_fp32_embeds_on_a_bf16_model(mode):
    """fp32 patch embeddings on the bf16 model: the activations stay fp32
    (every product promoted, as ``jnp.einsum`` promotes) and the logits are
    fp32, as the reference's."""
    ref_cfg, cfg, params, model = _models("bfloat16")
    embeds = _embeds(cfg, "float32")
    want = FWD(params, ref_cfg, {"embeds": jnp.asarray(embeds)}, mode=mode)[0]
    got, _ = forward(model, cfg, {"embeds": torch.from_numpy(embeds)}, mode=mode)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    v = cfg.vocab_size
    assert _rel(got[..., :v], np.asarray(want)[..., :v]) <= TOL["float32"]


def test_bf16_embeds_on_an_fp32_model_raise():
    """The reference's layer scan would turn its bf16 carry into fp32 and
    raises; so does the port."""
    ref_cfg, cfg, params, model = _models("float32")
    embeds = _embeds(cfg, "bfloat16")
    with pytest.raises(TypeError, match="carry"):
        ref_forward(params, ref_cfg, {"embeds": jnp.asarray(embeds)})
    with pytest.raises(ValueError, match="keeps its dtype"):
        forward(model, cfg, {"embeds": convert.tensor_from_numpy(embeds, "cpu")})


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "mamba2-2.7b"])
def test_embeds_in_another_dtype_on_ssm_or_moe_layers_raise(name):
    """The port promotes in attention, the MLP and the logits only; an MoE
    or SSM layer takes the model's dtype (``docs/PORT.md``)."""
    _, cfg = _cfgs("bfloat16", name)
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    embeds = torch.zeros((1, 256, cfg.d_model))
    with pytest.raises(ValueError, match="SSM or MoE layers"):
        forward(model, cfg, {"embeds": embeds})
    got, _ = forward(model, cfg, {"embeds": embeds.bfloat16()})
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got[..., :cfg.vocab_size]).all())
