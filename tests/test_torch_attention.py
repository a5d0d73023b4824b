"""The port's dense-decoder layers (``repro_torch.models.layers`` RoPE and
MLP, ``repro_torch.models.attention``) against the reference's on the CPU.

Every case runs on each of the four dense smoke configs (GQA: 4 query heads
on 2 kv heads; ``qwen2-1.5b`` with its QKV biases). Weights and inputs are
made with numpy from a seed, in fp32, and go through both packages. The
tolerance is max |port - ref| / max |ref| <= 1e-5: fp32 sums in other
orders. ``flash_attention`` runs at ``q_chunk = kv_chunk = 4`` on 16
positions, so 6 of its 16 blocks are fully masked; the M-RoPE branch runs
both text-only (one position a token) and with three distinct sections.
"""

from dataclasses import asdict, replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro_torch.models import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers

NAMES = ("qwen2-1.5b", "deepseek-coder-33b", "yi-34b", "nemotron-4-340b")
ACTS = ("silu_glu", "sq_relu", "gelu")
TOL = 1e-5
B, S = 2, 16


def _rel(got: torch.Tensor, want) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _cfgs(name: str, **kw):
    ref = replace(ref_get_smoke(name), dtype="float32", **kw)
    return ref, ArchConfig(**asdict(ref))


def _both(tree: dict):
    """A dict of numpy arrays as the reference's pytree and as torch tensors."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _attn_params(cfg, seed: int):
    rng = np.random.default_rng(seed)
    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads

    def w(*shape, fan):
        return (rng.standard_normal(shape, dtype=np.float32) / np.sqrt(fan)).astype(np.float32)

    p = {"wq": w(d, h, hd, fan=d), "wk": w(d, kv, hd, fan=d), "wv": w(d, kv, hd, fan=d),
         "wo": w(h, hd, d, fan=h * hd)}
    if cfg.qkv_bias:  # random, not the zeros init draws, so the adds show
        p.update(bq=w(h, hd, fan=4), bk=w(kv, hd, fan=4), bv=w(kv, hd, fan=4))
    ref, port = _both(p)
    return ref, attn.Attention(port)


def _hidden(cfg, seed: int, s: int = S) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, s, cfg.d_model), dtype=np.float32)


def _positions(kind: str, s: int = S) -> np.ndarray:
    """0..S-1, or each sequence from its own offset (a continued prompt)."""
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s))
    return (pos + np.array([[0], [5]], np.int32)) if kind == "offset" else pos.copy()


@pytest.mark.parametrize("name", NAMES)
def test_the_smoke_configs_are_gqa(name):
    _, cfg = _cfgs(name)
    assert 1 <= cfg.n_kv_heads < cfg.n_heads and cfg.n_heads % cfg.n_kv_heads == 0
    assert cfg.qkv_bias == (name == "qwen2-1.5b")


@pytest.mark.parametrize("name", NAMES)
def test_rope_freqs(name):
    ref, cfg = _cfgs(name)
    want = ref_layers.rope_freqs(cfg.hd, cfg.rope_theta)
    assert _rel(layers.rope_freqs(cfg.hd, cfg.rope_theta), want) <= 1e-6


#: (M-RoPE, positions): three distinct sections are M-RoPE's input only
ROPE_CASES = [(False, "text"), (False, "offset"), (True, "text"), (True, "offset"),
              (True, "sections")]


@pytest.mark.parametrize("mrope,positions", ROPE_CASES,
                         ids=[f"{'mrope' if m else 'rope'}-{p}" for m, p in ROPE_CASES])
@pytest.mark.parametrize("name", NAMES)
def test_apply_rope(name, mrope, positions):
    ref, cfg = _cfgs(name)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, cfg.n_heads, cfg.hd), dtype=np.float32)
    if positions == "sections":  # temporal / height / width differ
        pos = rng.integers(0, 64, (B, S, 3)).astype(np.int32)
    else:
        pos = _positions(positions)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), cfg.rope_theta, mrope)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), cfg.rope_theta, mrope)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("name", NAMES)
def test_mrope_on_text_is_rope(name):
    _, cfg = _cfgs(name)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, S, cfg.n_heads, cfg.hd), dtype=np.float32))
    pos = torch.from_numpy(_positions("offset"))
    assert torch.equal(layers.apply_rope(x, pos, cfg.rope_theta, True),
                       layers.apply_rope(x, pos, cfg.rope_theta, False))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("name", NAMES)
def test_apply_mlp(name, act):
    ref, cfg = _cfgs(name, act=act)
    rng = np.random.default_rng(3)
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": rng.standard_normal((d, f), dtype=np.float32) / np.sqrt(d),
         "wo": rng.standard_normal((f, d), dtype=np.float32) / np.sqrt(f)}
    if act == "silu_glu":
        p["wg"] = rng.standard_normal((d, f), dtype=np.float32) / np.sqrt(d)
    ref_p, port_p = _both({k: v.astype(np.float32) for k, v in p.items()})
    x = _hidden(cfg, 4) * 2
    want = ref_layers.apply_mlp(ref_p, jnp.asarray(x), ref)
    assert _rel(layers.apply_mlp(layers.MLP(port_p), torch.from_numpy(x), cfg), want) <= TOL


def test_gelu_is_the_tanh_form():
    ref, cfg = _cfgs("nemotron-4-340b", act="gelu")
    p = {"wi": np.eye(64, 256, dtype=np.float32) * 3, "wo": np.eye(256, 64, dtype=np.float32)}
    x = np.linspace(-4, 4, 2 * 4 * 64, dtype=np.float32).reshape(2, 4, 64)
    got = layers.apply_mlp(layers.MLP(_both(p)[1]), torch.from_numpy(x), cfg)
    exact = torch.nn.functional.gelu(torch.from_numpy(x) * 3)
    assert _rel(got, ref_layers.apply_mlp(_both(p)[0], jnp.asarray(x), ref)) <= TOL
    assert float((got - exact).abs().max()) > 1e-4  # the erf form would not match


@pytest.mark.parametrize("positions", ["text", "offset"])
@pytest.mark.parametrize("name", NAMES)
def test_attention(name, positions):
    ref, cfg = _cfgs(name)
    ref_p, p = _attn_params(cfg, 5)
    x, pos = _hidden(cfg, 6), _positions(positions)
    want = ref_attn.attention(ref_p, jnp.asarray(x), ref, jnp.asarray(pos))
    got = attn.attention(p, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("name", NAMES)
def test_attention_prefill(name):
    ref, cfg = _cfgs(name)
    ref_p, p = _attn_params(cfg, 7)
    x, pos = _hidden(cfg, 8), _positions("text")
    want, (wk, wv) = ref_attn.attention_prefill(ref_p, jnp.asarray(x), ref, jnp.asarray(pos))
    got, (k, v) = attn.attention_prefill(p, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    assert k.shape == (B, S, cfg.n_kv_heads, cfg.hd)
    for a, b in ((got, want), (k, wk), (v, wv)):
        assert _rel(a, b) <= TOL
    assert _rel(got, attn.attention(p, torch.from_numpy(x), cfg, torch.from_numpy(pos))) <= TOL


@pytest.mark.parametrize("positions", ["text", "offset"])
@pytest.mark.parametrize("name", NAMES)
def test_flash_attention_small_chunks(name, positions):
    ref, cfg = _cfgs(name)
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, S, cfg.n_heads, cfg.hd), dtype=np.float32)
    k, v = (rng.standard_normal((B, S, cfg.n_kv_heads, cfg.hd), dtype=np.float32)
            for _ in range(2))
    pos = _positions(positions)
    want = ref_attn.flash_attention(*map(jnp.asarray, (q, k, v, pos)), ref, q_chunk=4,
                                    kv_chunk=4)
    got = attn.flash_attention(*map(torch.from_numpy, (q, k, v, pos)), cfg, q_chunk=4,
                               kv_chunk=4)
    assert _rel(got, want) <= TOL
    whole = attn.flash_attention(*map(torch.from_numpy, (q, k, v, pos)), cfg)  # one block
    assert _rel(got, whole.numpy()) <= TOL


def test_flash_attention_refuses_a_ragged_length():
    _, cfg = _cfgs("qwen2-1.5b")
    q = torch.zeros((1, 12, cfg.n_heads, cfg.hd))
    kv = torch.zeros((1, 12, cfg.n_kv_heads, cfg.hd))
    with pytest.raises(ValueError, match="multiples of the chunks"):
        attn.flash_attention(q, kv, kv, torch.zeros((1, 12), dtype=torch.int32), cfg,
                             q_chunk=8, kv_chunk=8)


def test_kv_heads_are_interleaved_not_tiled():
    """q head h reads kv head h // groups (``jnp.repeat``); tiling would
    give it kv head h % n_kv, which only differs when n_kv < n_heads."""
    _, cfg = _cfgs("yi-34b")
    k = torch.arange(cfg.n_kv_heads, dtype=torch.float32).reshape(1, 1, -1, 1)
    groups = cfg.n_heads // cfg.n_kv_heads
    assert k.repeat_interleave(groups, dim=2).flatten().tolist() == [
        h // groups for h in range(cfg.n_heads)]
    assert k.repeat_interleave(groups, dim=2).flatten().tolist() != \
        k.repeat(1, 1, groups, 1).flatten().tolist()


@pytest.mark.parametrize("name", NAMES)
def test_attention_decode_step_by_step(name):
    ref, cfg = _cfgs(name)
    ref_p, p = _attn_params(cfg, 10)
    steps, max_len = 6, 8
    x = _hidden(cfg, 11, s=steps)
    ref_cache = ref_attn.init_cache(ref, B, max_len, jnp.float32)
    cache = attn.init_cache(cfg, B, max_len, torch.float32, "cpu")
    assert cache.k.shape == (B, max_len, cfg.n_kv_heads, cfg.hd) and int(cache.length) == 0
    for t in range(steps):
        want, ref_cache = ref_attn.attention_decode(ref_p, jnp.asarray(x[:, t:t + 1]),
                                                    ref_cache, ref)
        got, cache = attn.attention_decode(p, torch.from_numpy(x[:, t:t + 1]), cache, cfg)
        assert got.shape == (B, 1, cfg.d_model)
        assert _rel(got, want) <= TOL
        assert int(cache.length) == int(ref_cache.length) == t + 1
    assert _rel(cache.k, ref_cache.k) <= TOL and _rel(cache.v, ref_cache.v) <= TOL
    # the last step against full attention over the same prefix
    full = attn.attention(p, torch.from_numpy(x), cfg, torch.from_numpy(_positions("text", steps)))
    assert _rel(got, full[:, -1:].numpy()) <= TOL


def test_attention_decode_takes_one_token():
    _, cfg = _cfgs("qwen2-1.5b")
    _, p = _attn_params(cfg, 12)
    cache = attn.init_cache(cfg, B, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="one token"):
        attn.attention_decode(p, torch.zeros((B, 2, cfg.d_model)), cache, cfg)
