"""The port's Mamba2 serving path (``repro_torch.models``, ``repro_torch.configs``)
against the reference's ``repro.models`` on the CPU, where the SSD kernel's
wrapper takes its plain version.

Both packages compute on the same weights: the reference draws them
(``init_params``), ``convert.lm_from_numpy`` carries them across. Inputs are
made with numpy from a seed. Tolerances, on max |port - ref| / max |ref|
over the real vocabulary's logits: 1e-4 in fp32 (sums in other orders over
two layers); 5e-2 in bf16, which covers the reference rounding the
intra-chunk weights ``w_ij`` to bf16 (``ssm.py:145``) where the port keeps
them in fp32, and bf16 roundings that XLA fuses away on the CPU. The
port's own duality check (decode against forward) holds to 1e-4 in fp32
and to the reference test's 0.12 in bf16 (``tests/test_archs.py``).
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
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_decode_state as ref_init_decode_state
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro.models import ssm as ref_ssm
from repro_torch import configs, convert
from repro_torch.kernels.ssd_intra import ssd_intra
from repro_torch.models import (
    ArchConfig,
    decode_step,
    forward,
    init_decode_state,
    init_params,
)
from repro_torch.models import layers, ssm
from repro_torch.models.blocks import init_stack_cache

F32_TOL = 1e-4
BF16_TOL = 5e-2
DUAL_BF16_TOL = 0.12
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}
B, S, STEPS = 2, 16, 8
NAME = "mamba2-2.7b"


def _rel(got: torch.Tensor, want) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _port_cfg(ref_cfg) -> ArchConfig:
    return ArchConfig(**asdict(ref_cfg))


def _smoke(dtype: str):
    return replace(ref_get_smoke(NAME), dtype=dtype)


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def run(request):
    """The reference's model in one dtype, its converted copy, and both
    packages' logits: forward at all positions, and STEPS decode steps."""
    ref_cfg = _smoke(request.param)
    cfg = _port_cfg(ref_cfg)
    params = ref_init_params(jax.random.PRNGKey(3), ref_cfg)
    model = convert.lm_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    ref_all, _ = jax.jit(ref_forward, static_argnums=1)(
        params, ref_cfg, {"tokens": jnp.asarray(tokens)})
    state = ref_init_decode_state(params, ref_cfg, B, S)
    ref_steps = []
    step = jax.jit(ref_decode_step, static_argnums=1)
    for t in range(STEPS):
        lg, state = step(params, ref_cfg, state, jnp.asarray(tokens[:, t:t + 1]))
        ref_steps.append(np.asarray(lg, np.float32))
    return {"dtype": request.param, "ref_cfg": ref_cfg, "cfg": cfg, "params": params,
            "model": model, "tokens": tokens, "ref_all": np.asarray(ref_all, np.float32),
            "ref_steps": ref_steps}


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_arch_config_arithmetic_is_the_reference(name, smoke):
    ref = ref_get_smoke(name) if smoke else ref_get_config(name)
    cfg = _port_cfg(ref)
    assert (cfg.padded_vocab, cfg.d_inner, cfg.ssm_heads, cfg.block_period) == (
        ref.padded_vocab, ref.d_inner, ref.ssm_heads, ref.block_period)
    if ref.n_heads or ref.head_dim:  # an attention-free config has no head size
        assert cfg.hd == ref.hd
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    for layer in range(cfg.n_layers):
        assert cfg.is_attn_layer(layer) == ref.is_attn_layer(layer)
        assert cfg.is_moe_layer(layer) == ref.is_moe_layer(layer)


@pytest.mark.parametrize("name", configs.PORTED)
def test_registry_gives_the_reference_configs(name):
    assert asdict(configs.get_config(name)) == asdict(ref_get_config(name))
    assert asdict(configs.get_smoke(name)) == asdict(ref_get_smoke(name))
    assert configs.get_config(name).param_count() == ref_get_config(name).param_count()
    assert configs.ARCH_NAMES == ARCH_NAMES


@pytest.mark.parametrize("name", ["whisper-tiny", "qwen2-vl-72b"])
def test_other_archs_wait_for_their_layers(name):
    """The two names that waited for their layers (the encoder-decoder and
    the VLM backbone) are ported: the registry gives the reference's
    configs for them too."""
    assert name in configs.PORTED
    assert asdict(configs.get_config(name)) == asdict(ref_get_config(name))
    assert asdict(configs.get_smoke(name)) == asdict(ref_get_smoke(name))


def test_unknown_arch_is_a_key_error():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("mamba3")


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64, dtype=np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.standard_normal(64, dtype=np.float32)
    want = ref_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = layers.apply_norm(layers.Norm({k: torch.from_numpy(v) for k, v in p.items()}),
                            torch.from_numpy(x))
    assert _rel(got, want) <= 1e-6


def test_embed_tokens_and_masked_logits():
    cfg = _port_cfg(ref_get_smoke(NAME))
    rng = np.random.default_rng(1)
    table = rng.standard_normal((cfg.padded_vocab, cfg.d_model), dtype=np.float32)
    ids = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    emb = layers.Embedding({"table": torch.from_numpy(table)})
    x = layers.embed_tokens(emb, torch.from_numpy(ids).long())
    ref_p = {"table": jnp.asarray(table)}
    assert np.array_equal(x.numpy(), np.asarray(ref_layers.embed_tokens(ref_p, ids)))
    got = layers.logits(emb, x, vocab_size=cfg.vocab_size)
    want = np.asarray(ref_layers.logits(ref_p, jnp.asarray(x.numpy()), vocab_size=cfg.vocab_size))
    assert got.shape == (2, 7, cfg.padded_vocab)
    assert bool((got[..., cfg.vocab_size:] == -1e30).all())
    assert (want[..., cfg.vocab_size:] == -1e30).all()
    assert _rel(got[..., :cfg.vocab_size], want[..., :cfg.vocab_size]) <= 1e-6


def test_causal_conv_and_gated_norm():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 12), dtype=np.float32)
    w = rng.standard_normal((4, 12), dtype=np.float32)
    want = ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w))
    assert _rel(ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w)), want) <= 1e-6
    z = rng.standard_normal((2, 9, 12), dtype=np.float32)
    scale = rng.standard_normal(12, dtype=np.float32)
    want = ref_ssm._gated_norm(jnp.asarray(x), jnp.asarray(z), jnp.asarray(scale))
    got = ssm._gated_norm(torch.from_numpy(x), torch.from_numpy(z), torch.from_numpy(scale))
    assert _rel(got, want) <= 1e-6


# --------------------------------------------------------------------------
# the mixer
# --------------------------------------------------------------------------

def _layer0(run):
    ref_p = jax.tree.map(lambda a: a[0], run["params"]["blocks"][0]["ssm"])
    return ref_p, run["model"].blocks[0].ssm


def _hidden(run, seed, s=S):
    jdt = jnp.bfloat16 if run["dtype"] == "bfloat16" else jnp.float32
    x = np.random.default_rng(seed).standard_normal((B, s, run["cfg"].d_model), dtype=np.float32)
    xj = jnp.asarray(x, jdt)
    return xj, torch.from_numpy(np.asarray(xj, np.float32)).to(getattr(torch, run["dtype"]))


def test_apply_ssm(run):
    ref_p, p = _layer0(run)
    xj, x = _hidden(run, 10)
    want = jax.jit(ref_ssm.apply_ssm, static_argnums=2)(ref_p, xj, run["ref_cfg"])
    before = ssd_intra.launches
    got = ssm.apply_ssm(p, x, run["cfg"])
    assert ssd_intra.launches == before  # CPU tensors: the plain version
    assert got.dtype == x.dtype
    assert _rel(got, want) <= TOL[run["dtype"]]


def test_apply_ssm_decode(run):
    ref_p, p = _layer0(run)
    xj, x = _hidden(run, 11, s=4)
    cache = ssm.init_ssm_cache(run["cfg"], B, x.dtype, "cpu")
    ref_cache = ref_ssm.init_ssm_cache(run["ref_cfg"], B, xj.dtype)
    ref_step = jax.jit(ref_ssm.apply_ssm_decode, static_argnums=3)
    for t in range(4):
        want, ref_cache = ref_step(ref_p, xj[:, t:t + 1], ref_cache, run["ref_cfg"])
        got, cache = ssm.apply_ssm_decode(p, x[:, t:t + 1], cache, run["cfg"])
        assert _rel(got, want) <= TOL[run["dtype"]]
    assert _rel(cache.state, ref_cache.state) <= TOL[run["dtype"]]
    assert _rel(cache.conv, ref_cache.conv) <= TOL[run["dtype"]]
    assert int(cache.length) == 4


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def test_forward_all_positions(run):
    cfg = run["cfg"]
    got, aux = forward(run["model"], cfg, {"tokens": torch.from_numpy(run["tokens"]).long()})
    assert got.shape == (B, S, cfg.padded_vocab) and float(aux) == 0.0
    v = cfg.vocab_size
    assert bool((got[..., v:] == -1e30).all())
    assert _rel(got[..., :v], run["ref_all"][..., :v]) <= TOL[run["dtype"]]


def test_forward_prefill_last_position(run):
    cfg = run["cfg"]
    tokens = torch.from_numpy(run["tokens"]).long()
    got, _ = forward(run["model"], cfg, {"tokens": tokens}, mode="prefill",
                     logits_positions="last")
    assert got.shape == (B, 1, cfg.padded_vocab)
    v = cfg.vocab_size
    assert _rel(got[..., :v], run["ref_all"][:, -1:, :v]) <= TOL[run["dtype"]]
    full, _ = forward(run["model"], cfg, {"tokens": tokens}, mode="train")
    assert _rel(got[..., :v], full[:, -1:, :v].float().numpy()) <= 1e-6


def test_decode_steps(run):
    cfg = run["cfg"]
    state = init_decode_state(run["model"], cfg, B, S)
    v = cfg.vocab_size
    for t in range(STEPS):
        lg, state = decode_step(run["model"], cfg, state,
                                torch.from_numpy(run["tokens"][:, t:t + 1]).long())
        assert lg.shape == (B, 1, cfg.padded_vocab)
        assert _rel(lg[..., :v], run["ref_steps"][t][..., :v]) <= TOL[run["dtype"]]


def test_decode_matches_forward(run):
    """The port's duality check: recurrent decode against the chunked
    forward on one shared prefix, both in the port."""
    cfg = run["cfg"]
    tokens = torch.from_numpy(run["tokens"]).long()
    par, _ = forward(run["model"], cfg, {"tokens": tokens})
    state = init_decode_state(run["model"], cfg, B, S)
    steps = []
    for t in range(S):
        lg, state = decode_step(run["model"], cfg, state, tokens[:, t:t + 1])
        steps.append(lg[:, 0])
    seq = torch.stack(steps, dim=1)
    v = cfg.vocab_size
    tol = F32_TOL if run["dtype"] == "float32" else DUAL_BF16_TOL
    assert _rel(seq[..., :v], par[..., :v].float().numpy()) <= tol


def test_converted_parameters_are_the_reference_leaves(run):
    model, params = run["model"], run["params"]
    names = dict(model.named_parameters())
    assert len(names) == 2 + 12 * run["cfg"].n_layers  # table, final norm; norm1 + 11 SSM leaves
    for layer in range(run["cfg"].n_layers):
        for key, leaf in params["blocks"][0]["ssm"].items():
            got = names[f"blocks.{layer}.ssm.{key}"]
            assert not got.requires_grad
            assert np.array_equal(got.float().numpy(), np.asarray(leaf[layer], np.float32))
    assert np.array_equal(model.embed.table.float().numpy(),
                          np.asarray(params["embed"]["table"], np.float32))


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def test_init_params_runs_on_the_card_unless_asked():
    cfg = configs.get_smoke(NAME)
    if torch.cuda.is_available():
        gen = torch.Generator(device="cuda").manual_seed(0)
        assert init_params(cfg, generator=gen).embed.table.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, generator=torch.Generator().manual_seed(0))
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert model.embed.table.dtype == torch.bfloat16
    assert model.embed.table.shape == (cfg.padded_vocab, cfg.d_model)
    assert len(model.blocks) == cfg.n_layers
    # the reference's distributions: N(0, 1/fan_in) projections, 0.02 embedding
    assert abs(float(model.blocks[0].ssm.wx.float().std()) - cfg.d_model ** -0.5) < 0.02
    assert abs(float(model.embed.table.float().std()) - 0.02) < 0.002


def test_entry_points_reject_what_waits():
    cfg = configs.get_smoke(NAME)
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    with pytest.raises(ValueError, match="mode"):
        forward(model, cfg, tokens, mode="decode")
    with pytest.raises(ValueError, match="logits_positions"):
        forward(model, cfg, tokens, logits_positions="first")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        forward(model, cfg, {"tokens": torch.zeros((1, 12), dtype=torch.long)})
    with pytest.raises(ValueError, match="the config is encoder-decoder, the model "
                                         "decoder-only"):
        forward(model, replace(cfg, is_encdec=True), tokens)
    with pytest.raises(ValueError, match="layer 0: the config asks for FFN 'moe', the model's "
                                         "layer holds 'none'"):
        forward(model, replace(cfg, n_experts=4, top_k=2, moe_every=2), tokens)
    with pytest.raises(ValueError, match="layer 0: the call needs cross-attention, the model's "
                                         "layer holds none"):
        init_stack_cache(model.blocks, replace(cfg, is_encdec=True), 1, 8, torch.bfloat16)
