"""The port's encoder-decoder model (``whisper-tiny``'s smoke config:
layernorm, GELU, tied embeddings, 2 encoder and 2 decoder layers,
cross-attention) against the reference's ``repro.models`` on the CPU.

Both packages compute on the same weights: the reference draws them
(``init_params``), ``convert.lm_from_numpy`` carries them across. Frame
embeddings and decoder tokens are made with numpy from a seed. Each
reference result is computed once a module (fixture ``run``). Tolerances,
on max |port - ref| / max |ref| over the real vocabulary's logits (the
padded columns hold -1e30): 1e-4 in fp32 and 5e-2 in bf16, as
``tests/test_torch_dense_lm.py``; cross-attention alone 1e-5 in fp32, as
``tests/test_torch_attention.py``. The port's own duality (token-by-token
decode against teacher-forced train logits) holds to 1e-4 in fp32.

Properties of the reference that the port reproduces (``docs/PORT.md``):
under ``mode="prefill"`` the encoder runs causally; ``decode_step`` without
``cross_kv`` skips cross-attention; cross-attention reads the encoder's
states as K and V (``xattn``'s ``wk``/``wv`` are parameters nothing reads).
"""

from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_decode_state as ref_init_decode_state
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro.models.model import _encoder_kv as ref_encoder_kv
from repro_torch import configs, convert
from repro_torch.models import (
    ArchConfig,
    attention,
    blocks,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    layers,
)
from repro_torch.models.model import LM, _encoder_kv

NAME = "whisper-tiny"
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ATTN_TOL = 1e-5
DUAL_TOL = 1e-4
B, S_ENC, S_DEC, STEPS = 2, 16, 8, 3


def _rel(got: torch.Tensor, want) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _cfgs(dtype: str = "float32", **kw):
    ref = replace(ref_get_smoke(NAME), dtype=dtype, **kw)
    return ref, ArchConfig(**asdict(ref))


def _frames(cfg, seed: int = 5, s: int = S_ENC) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, s, cfg.d_model), dtype=np.float32)


def _dec_tokens(cfg, seed: int = 6, s: int = S_DEC) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s)).astype(np.int32)


def _port_batch(frames, dec) -> dict:
    return {"embeds": convert.tensor_from_numpy(frames, "cpu"),
            "dec_tokens": torch.from_numpy(dec).long()}


def _ref_batch(frames, dec) -> dict:
    return {"embeds": jnp.asarray(frames), "dec_tokens": jnp.asarray(dec)}


def _ref_cross_kv(params, ref_cfg, frames):
    """The reference's own encoder-decoder decode recipe
    (``tests/test_archs.py``): the encoder in ``train`` mode, unmasked,
    then ``enc_norm`` and ``_encoder_kv``."""
    x = jnp.asarray(frames)
    pos = jnp.broadcast_to(jnp.arange(x.shape[1], dtype=jnp.int32), x.shape[:2])
    enc, _ = ref_blocks.apply_stack(params["encoder"], x, ref_cfg, pos, causal=False)
    return ref_encoder_kv(ref_cfg, ref_layers.apply_norm(params["enc_norm"], enc))


def _port_cross_kv(model, cfg, frames):
    x = convert.tensor_from_numpy(frames, "cpu")
    pos = torch.arange(x.shape[1], dtype=torch.int32).expand(x.shape[:2])
    with torch.no_grad():
        enc, _ = blocks.apply_stack(model.encoder, x, cfg, pos, causal=False)
    return _encoder_kv(cfg, layers.apply_norm(model.enc_norm, enc))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def run(request):
    dtype = request.param
    ref_cfg, cfg = _cfgs(dtype)
    params = ref_init_params(jax.random.PRNGKey(3), ref_cfg)
    model = convert.lm_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    frames = _frames(cfg).astype(jnp.dtype(dtype))
    dec = _dec_tokens(cfg)
    fwd = jax.jit(ref_forward, static_argnums=1, static_argnames=("mode", "logits_positions"))
    ref = {mode: np.asarray(fwd(params, ref_cfg, _ref_batch(frames, dec), mode=mode)[0],
                            np.float32) for mode in ("train", "prefill")}
    step = jax.jit(ref_decode_step, static_argnums=1)
    cross = _ref_cross_kv(params, ref_cfg, frames)
    steps = {}
    for case, kv in (("cross", cross), ("none", None)):
        state = ref_init_decode_state(params, ref_cfg, B, S_DEC)
        steps[case] = []
        for t in range(STEPS):
            lg, state = step(params, ref_cfg, state, jnp.asarray(dec[:, t:t + 1]), cross_kv=kv)
            steps[case].append(np.asarray(lg, np.float32))
    return {"dtype": dtype, "ref_cfg": ref_cfg, "cfg": cfg, "params": params, "model": model,
            "frames": frames, "dec": dec, "ref": ref, "ref_steps": steps}


# --------------------------------------------------------------------------
# configuration, conversion, initialization
# --------------------------------------------------------------------------

def test_whisper_is_ported():
    assert NAME in configs.PORTED
    cfg = configs.get_config(NAME)
    assert cfg.is_encdec and cfg.frontend == "audio_stub" and cfg.dec_layers == 4
    assert cfg.norm == "layernorm" and cfg.act == "gelu" and cfg.tie_embeddings


def test_converted_parameters_are_the_reference_leaves(run):
    """Every leaf of the reference's pytree, by its path, in the port's
    model; ``xattn``'s ``wk``/``wv`` too, though nothing reads them."""
    model, params, cfg = run["model"], run["params"], run["cfg"]
    names = dict(model.named_parameters())
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if keys[0] in ("encoder", "decoder"):
            pos, *rest = keys[1:]
            period = len(params[keys[0]])
            for g in range(leaf.shape[0]):
                want[".".join([keys[0], str(g * period + pos), *rest])] = np.asarray(leaf[g])
        else:
            want[".".join(map(str, keys))] = np.asarray(leaf)
    assert set(names) == set(want)
    assert {f"decoder.{i}.xattn.{k}" for i in range(cfg.dec_layers) for k in ("wk", "wv")} <= (
        set(names))
    assert not any(n.startswith("encoder.") and ".xattn." in n for n in names)
    for n, leaf in want.items():
        assert not names[n].requires_grad
        assert names[n].dtype == convert.tensor_from_numpy(leaf, "cpu").dtype
        assert np.array_equal(names[n].float().numpy(), np.asarray(leaf, np.float32)), n


def test_init_params_builds_the_encoder_decoder():
    _, cfg = _cfgs()
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    ref = ref_init_params(jax.random.PRNGKey(0), _cfgs()[0])
    assert model.is_encdec and model.blocks is None
    assert len(model.encoder) == cfg.n_layers and len(model.decoder) == cfg.dec_layers
    assert all(p.xattn is None and p.norm_x is None for p in model.encoder)
    assert all(p.xattn.wk.shape == (cfg.d_model, cfg.n_kv_heads, cfg.hd) for p in model.decoder)
    assert model.enc_norm.bias is not None and model.embed.head is None
    assert sum(t.numel() for t in model.parameters()) == sum(
        leaf.size for leaf in jax.tree.leaves(ref))
    xw = model.decoder[0].xattn.wq
    assert abs(float(xw.std()) - cfg.d_model ** -0.5) < 0.03


# --------------------------------------------------------------------------
# cross-attention and the encoder's K/V
# --------------------------------------------------------------------------

def _attn_tree(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads

    def w(*shape, fan):
        return (rng.standard_normal(shape, dtype=np.float32) / np.sqrt(fan)).astype(np.float32)

    p = {"wq": w(d, h, hd, fan=d), "wk": w(d, kv, hd, fan=d), "wv": w(d, kv, hd, fan=d),
         "wo": w(h, hd, d, fan=h * hd)}
    if cfg.qkv_bias:
        p.update(bq=w(h, hd, fan=4), bk=w(kv, hd, fan=4), bv=w(kv, hd, fan=4))
    return p


def test_cross_attention_against_the_reference():
    ref_cfg, cfg = _cfgs()
    tree = _attn_tree(cfg, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S_DEC, cfg.d_model), dtype=np.float32)
    kv = rng.standard_normal((B, S_ENC, cfg.n_kv_heads, cfg.hd), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S_DEC, dtype=np.int32), (B, S_DEC)).copy()
    want = ref_attn.attention({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x),
                              ref_cfg, jnp.asarray(pos), kv_override=(jnp.asarray(kv),) * 2)
    p = attention.Attention({k: torch.from_numpy(v) for k, v in tree.items()})
    t_kv = torch.from_numpy(kv)
    got = attention.attention(p, torch.from_numpy(x), cfg, torch.from_numpy(pos),
                              kv_override=(t_kv, t_kv))
    assert _rel(got, want) <= ATTN_TOL
    # no mask and no RoPE: the positions and ``causal`` change nothing
    other = attention.attention(p, torch.from_numpy(x), cfg, torch.zeros((B, S_DEC)),
                                causal=True, kv_override=(t_kv, t_kv))
    assert torch.equal(got, other)


def test_cross_attention_reads_no_kv_weights():
    """The reference's cross-attention discards its projected K and V: the
    port's result does not move when ``wk``/``wv`` do."""
    _, cfg = _cfgs()
    tree = _attn_tree(cfg, 3)
    p = attention.Attention({k: torch.from_numpy(v) for k, v in tree.items()})
    x = torch.randn((B, S_DEC, cfg.d_model), generator=torch.Generator().manual_seed(0))
    kv = torch.randn((B, S_ENC, cfg.n_kv_heads, cfg.hd), generator=torch.Generator())
    before = attention.attention(p, x, cfg, torch.zeros((B, S_DEC)), kv_override=(kv, kv))
    p.wk.mul_(-3.0)
    p.wv.add_(1.0)
    assert torch.equal(before, attention.attention(p, x, cfg, torch.zeros((B, S_DEC)),
                                                   kv_override=(kv, kv)))


@pytest.mark.parametrize("head_dim", [16, 8], ids=["d/kv=hd", "sliced"])
def test_encoder_kv_bit_for_bit(head_dim):
    ref_cfg, cfg = _cfgs(head_dim=head_dim)
    enc = _frames(cfg, seed=7)
    want_k, want_v = ref_encoder_kv(ref_cfg, jnp.asarray(enc))
    got_k, got_v = _encoder_kv(cfg, torch.from_numpy(enc))
    assert got_k is got_v and want_k is want_v
    assert got_k.shape == (B, S_ENC, cfg.n_kv_heads, head_dim)
    assert np.array_equal(got_k.numpy(), np.asarray(want_k))


# --------------------------------------------------------------------------
# forward and decode against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward(run, mode):
    cfg = run["cfg"]
    got, aux = forward(run["model"], cfg, _port_batch(run["frames"], run["dec"]), mode=mode)
    assert got.shape == (B, S_DEC, cfg.padded_vocab) and float(aux) == 0.0
    assert got.dtype == run["model"].embed.table.dtype
    v = cfg.vocab_size
    assert bool((got[..., v:] == -1e30).all())
    assert _rel(got[..., :v], run["ref"][mode][..., :v]) <= TOL[run["dtype"]]


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_last_position(run, mode):
    cfg = run["cfg"]
    got, _ = forward(run["model"], cfg, _port_batch(run["frames"], run["dec"]), mode=mode,
                     logits_positions="last")
    assert got.shape == (B, 1, cfg.padded_vocab)
    v = cfg.vocab_size
    assert _rel(got[..., :v], run["ref"][mode][:, -1:, :v]) <= TOL[run["dtype"]]


def test_train_and_prefill_differ_as_in_the_reference(run):
    """The prefill encoder is causal, the train encoder is not: the two
    modes' logits differ in both packages, by about as much."""
    cfg, v = run["cfg"], run["cfg"].vocab_size
    train, _ = forward(run["model"], cfg, _port_batch(run["frames"], run["dec"]))
    pre, _ = forward(run["model"], cfg, _port_batch(run["frames"], run["dec"]), mode="prefill")
    got = float((train - pre)[..., :v].abs().max())
    want = float(np.abs(run["ref"]["train"] - run["ref"]["prefill"])[..., :v].max())
    assert want > 1e-2 and abs(got - want) <= 0.1 * want


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_prefill_encoder_is_causal(mode):
    """A change to the last frame leaves the first encoder row unchanged
    under ``prefill`` and moves it under ``train``, in both packages."""
    ref_cfg, cfg = _cfgs()
    params = ref_init_params(jax.random.PRNGKey(3), ref_cfg)
    model = convert.lm_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    frames = _frames(cfg)
    moved = frames.copy()
    moved[:, -1] += 1.0
    pos = np.broadcast_to(np.arange(S_ENC, dtype=np.int32), (B, S_ENC)).copy()
    rows = {}
    for name, x in (("frames", frames), ("moved", moved)):
        want, _ = ref_blocks.apply_stack(params["encoder"], jnp.asarray(x), ref_cfg,
                                         jnp.asarray(pos), mode=mode, causal=False)
        with torch.no_grad():
            got, _ = blocks.apply_stack(model.encoder, torch.from_numpy(x), cfg,
                                        torch.from_numpy(pos), mode=mode, causal=False)
        assert _rel(got, want) <= ATTN_TOL * 10
        rows[name] = (np.asarray(want)[:, 0], got[:, 0].numpy())
    for i in range(2):
        same = np.array_equal(rows["frames"][i], rows["moved"][i])
        assert same == (mode == "prefill")


@pytest.mark.parametrize("case", ["cross", "none"])
def test_decode_steps(run, case):
    """Three steps with the encoder's ``cross_kv`` against the reference's,
    and three without it, where both skip cross-attention."""
    cfg = run["cfg"]
    kv = _port_cross_kv(run["model"], cfg, run["frames"]) if case == "cross" else None
    state = init_decode_state(run["model"], cfg, B, S_DEC)
    assert len(state["caches"]) == cfg.dec_layers
    assert all(c.k.shape == (B, S_DEC, cfg.n_kv_heads, cfg.hd) for c in state["caches"])
    v = cfg.vocab_size
    dec = torch.from_numpy(run["dec"]).long()
    for t in range(STEPS):
        lg, state = decode_step(run["model"], cfg, state, dec[:, t:t + 1], cross_kv=kv)
        assert lg.shape == (B, 1, cfg.padded_vocab)
        assert _rel(lg[..., :v], run["ref_steps"][case][t][..., :v]) <= TOL[run["dtype"]]
    assert all(int(c.length) == STEPS for c in state["caches"])
    if case == "none":
        assert _rel(torch.from_numpy(run["ref_steps"]["cross"][0][..., :v].copy()),
                    run["ref_steps"]["none"][0][..., :v]) > 1e-3


def test_decode_matches_train():
    """The port's duality in fp32: teacher-forced train logits against
    token-by-token decode with the same encoder states."""
    _, cfg = _cfgs()
    model = init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    frames = _frames(cfg, seed=8)
    dec = torch.from_numpy(_dec_tokens(cfg, seed=9, s=cfg.max_target_len)).long()
    train, _ = forward(model, cfg, _port_batch(frames, dec.numpy()))
    kv = _port_cross_kv(model, cfg, frames)
    state = init_decode_state(model, cfg, B, cfg.max_target_len)
    steps = []
    for t in range(cfg.max_target_len):
        lg, state = decode_step(model, cfg, state, dec[:, t:t + 1], cross_kv=kv)
        steps.append(lg[:, 0])
    v = cfg.vocab_size
    assert _rel(torch.stack(steps, 1)[..., :v], train[..., :v].numpy()) <= DUAL_TOL


# --------------------------------------------------------------------------
# dtypes and refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model_dtype,embeds_dtype", [("bfloat16", "float32"),
                                                      ("float32", "bfloat16")])
def test_embeds_in_another_dtype_raise_as_in_the_reference(model_dtype, embeds_dtype):
    """Either way the reference's scan over the layers would change its
    carry's dtype (the encoder on bf16 frames in an fp32 model; the bf16
    decoder on fp32 encoder states) and raises; the port raises too."""
    ref_cfg, cfg = _cfgs(model_dtype)
    params = ref_init_params(jax.random.PRNGKey(3), ref_cfg)
    model = convert.lm_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    frames = _frames(cfg).astype(jnp.dtype(embeds_dtype))
    with pytest.raises(TypeError, match="carry"):
        ref_forward(params, ref_cfg, _ref_batch(frames, _dec_tokens(cfg)))
    with pytest.raises(ValueError, match="keeps its dtype"):
        forward(model, cfg, _port_batch(frames, _dec_tokens(cfg)))


@pytest.mark.parametrize("model_dtype,kv_dtype", [("bfloat16", "float32"),
                                                  ("float32", "bfloat16")])
def test_cross_kv_in_another_dtype(model_dtype, kv_dtype):
    """fp32 ``cross_kv`` under a bf16 decoder raises in both packages; bf16
    ``cross_kv`` under an fp32 decoder is promoted, as the reference
    promotes it."""
    ref_cfg, cfg = _cfgs(model_dtype)
    params = ref_init_params(jax.random.PRNGKey(3), ref_cfg)
    model = convert.lm_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    kv = np.random.default_rng(4).standard_normal((B, S_ENC, cfg.n_kv_heads, cfg.hd),
                                                  dtype=np.float32).astype(jnp.dtype(kv_dtype))
    tok = _dec_tokens(cfg)[:, :1]
    ref_state = ref_init_decode_state(params, ref_cfg, B, S_DEC)
    state = init_decode_state(model, cfg, B, S_DEC)
    t_kv = convert.tensor_from_numpy(kv, "cpu")
    if model_dtype == "bfloat16":
        with pytest.raises(TypeError, match="carry"):
            ref_decode_step(params, ref_cfg, ref_state, jnp.asarray(tok),
                            cross_kv=(jnp.asarray(kv),) * 2)
        with pytest.raises(ValueError, match="keeps its dtype"):
            decode_step(model, cfg, state, torch.from_numpy(tok).long(), cross_kv=(t_kv, t_kv))
        return
    want, _ = ref_decode_step(params, ref_cfg, ref_state, jnp.asarray(tok),
                              cross_kv=(jnp.asarray(kv),) * 2)
    got, _ = decode_step(model, cfg, state, torch.from_numpy(tok).long(), cross_kv=(t_kv, t_kv))
    assert got.dtype == torch.float32
    v = cfg.vocab_size
    assert _rel(got[..., :v], np.asarray(want)[..., :v]) <= TOL["float32"]


def test_model_and_config_must_agree():
    """An encoder-decoder config on a decoder-only model, or the reverse,
    raises ``ValueError`` at every entry point."""
    _, cfg = _cfgs()
    encdec = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    dense_cfg = configs.get_smoke("qwen2-1.5b")
    dense = init_params(dense_cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="the config is decoder-only, the model encoder-decoder"):
        forward(encdec, dense_cfg, {"tokens": tokens})
    with pytest.raises(ValueError, match="the config is encoder-decoder, the model decoder-only"):
        forward(dense, replace(dense_cfg, is_encdec=True, dec_layers=2),
                {"tokens": tokens, "dec_tokens": tokens})
    with pytest.raises(ValueError, match="the config is decoder-only"):
        init_decode_state(encdec, dense_cfg, 1, 8)
    with pytest.raises(ValueError, match="the config is encoder-decoder"):
        decode_step(dense, replace(dense_cfg, is_encdec=True), {"caches": []}, tokens[:, :1])
    with pytest.raises(ValueError, match="blocks, or encoder, enc_norm and decoder"):
        LM(encdec.embed, encdec.final_norm, encdec.decoder, encoder=encdec.encoder,
           enc_norm=encdec.enc_norm, decoder=encdec.decoder)
    with pytest.raises(ValueError, match="blocks, or encoder, enc_norm and decoder"):
        LM(encdec.embed, encdec.final_norm, encoder=encdec.encoder)


def test_a_layer_without_cross_attention_refuses_cross_kv():
    _, cfg = _cfgs()
    model = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.zeros((1, 4, cfg.d_model))
    kv = torch.zeros((1, 4, cfg.n_kv_heads, cfg.hd))
    pos = torch.arange(4).expand(1, 4)
    with pytest.raises(ValueError, match="layer 0: the call needs cross-attention, the model's "
                                         "layer holds none"):
        blocks.apply_layer(model.encoder[0], x, cfg, 0, pos, cross_kv=(kv, kv))
    with pytest.raises(ValueError, match="layer 0: the call needs cross-attention"):
        blocks.init_stack_cache(model.encoder, cfg, 1, 8, torch.float32)
    with pytest.raises(ValueError, match="norm_x with xattn"):
        blocks.Layer(model.decoder[0].norm1, attn=model.decoder[0].attn,
                     norm_x=model.decoder[0].norm_x)
    # decode skips cross-attention on a layer without it, as the reference does
    plain = replace(cfg, is_encdec=False)
    caches = blocks.init_stack_cache(model.encoder, plain, 1, 8, torch.float32)
    got, _ = blocks.apply_stack_decode(model.encoder, caches, x[:, :1], cfg, cross_kv=(kv, kv))
    caches = blocks.init_stack_cache(model.encoder, plain, 1, 8, torch.float32)
    want, _ = blocks.apply_stack_decode(model.encoder, caches, x[:, :1], cfg)
    assert torch.equal(got, want)
