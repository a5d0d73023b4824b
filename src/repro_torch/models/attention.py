"""GQA attention: train/prefill (full causal), cross-attention on an
encoder's states (``kv_override``), and single-token decode with a KV
cache. The port of ``repro/models/attention.py`` without its sharding
policies (the mesh layer waits for ROADMAP Queue 1 item 15f).

The numerics follow the reference's casts one by one: Q, K and V in the
activations' dtype, scores scaled in it and then taken to fp32, the causal
mask built from ``positions`` with masked scores set to -1e30, probabilities
cast back to the activations' dtype before the PV product. Grouped K/V heads
are expanded with ``repeat_interleave`` (``jnp.repeat``): q head ``h`` reads
kv head ``h // groups``. Products of two dtypes are taken in the promoted
one, as ``jnp.einsum`` takes them.

Under ``kv_override`` K and V are the given encoder states, unroped and
unmasked. The reference projects K and V there too and discards them; the
port projects Q alone (``docs/PORT.md``).

The decode cache is written in place (``index_copy_`` at ``length``; the
port serves without autograd), where the reference returns new arrays: the
caches of the state a step was given are the caches of the state it
returns (``docs/PORT.md``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import ArchConfig
from .layers import Params, apply_rope, dense_init, einsum, matmul

#: The score a masked position gets, as in the reference.
MASKED = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, n_kv, hd)
    v: torch.Tensor  # (B, S_max, n_kv, hd)
    length: torch.Tensor  # () int32: the filled prefix's length


class Attention(Params):
    """``wq`` (d, H, hd), ``wk``/``wv`` (d, n_kv, hd), ``wo`` (H, hd, d);
    with ``qkv_bias`` also ``bq`` (H, hd) and ``bk``/``bv`` (n_kv, hd)."""

    names = ("wq", "wk", "wv", "wo")
    optional = ("bq", "bk", "bv")


def init_attn(gen: torch.Generator, cfg: ArchConfig, dtype, device="cuda") -> Attention:
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads, hd), in_axis=0, dtype=dtype, device=device),
        "wk": dense_init(gen, (d, cfg.n_kv_heads, hd), in_axis=0, dtype=dtype, device=device),
        "wv": dense_init(gen, (d, cfg.n_kv_heads, hd), in_axis=0, dtype=dtype, device=device),
        "wo": dense_init(gen, (cfg.n_heads, hd, d), in_axis=0, dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dtype, device=device)
    return Attention(p)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matmul."""
    d, h, k = w.shape
    return matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def _q(p: Attention, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    q = _proj(x, p.wq)
    return q + p.bq if cfg.qkv_bias else q


def _qkv(p: Attention, cfg: ArchConfig, x: torch.Tensor):
    k, v = _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qkv_bias:
        k = k + p.bk
        v = v + p.bv
    return _q(p, cfg, x), k, v


def _out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one matmul."""
    return matmul(out.flatten(-2), wo.reshape(-1, wo.shape[-1]))


def _groups(cfg: ArchConfig) -> int:
    return cfg.n_heads // max(cfg.n_kv_heads, 1)


def attention(p: Attention, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor | None,
              *, causal: bool = True,
              kv_override: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """Full (train) attention. x: (B, S, D) -> (B, S, D).

    ``kv_override`` supplies an encoder's K and V, (B, S_enc, n_kv, hd), for
    cross-attention: no RoPE, no mask (``positions`` and ``causal`` are not
    read)."""
    if kv_override is not None:
        q = _q(p, cfg, x)
        k, v = kv_override
        causal = False
    else:
        q, k, v = _qkv(p, cfg, x)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    groups = _groups(cfg)
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    scale = cfg.hd ** -0.5
    scores = (einsum("bqhk,bshk->bhqs", q, k) * scale).float()
    if causal:
        mask = positions[:, None, :, None] >= torch.arange(k.shape[1], device=x.device)
        scores = torch.where(mask, scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = einsum("bhqs,bshk->bqhk", probs, v)
    return _out(out, p.wo)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                    cfg: ArchConfig, *, q_chunk: int = 1024, kv_chunk: int = 1024,
                    causal: bool = True) -> torch.Tensor:
    """Double-blocked streaming-softmax attention, for long prefills: score
    blocks of (B, H, q_chunk, kv_chunk) instead of (B, H, S, S). q: (B, Sq,
    H, hd); k/v: (B, Sk, n_kv, hd). Every block is computed, as the
    reference's scans compute it: a fully masked one adds exactly zero."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    groups = h // max(cfg.n_kv_heads, 1)
    scale = hd ** -0.5
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, sk)
    if sq % q_chunk or sk % kv_chunk:
        raise ValueError(f"flash_attention: lengths {sq} and {sk} are not multiples of the "
                         f"chunks {q_chunk} and {kv_chunk}")
    kv_pos = torch.arange(sk, device=q.device)
    outs = []
    for qs in range(0, sq, q_chunk):
        q_blk, posq = q[:, qs:qs + q_chunk], positions[:, qs:qs + q_chunk]
        m = torch.full((b, h, q_chunk), -torch.inf, dtype=torch.float32, device=q.device)
        denom = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, q_chunk, h, hd), dtype=torch.float32, device=q.device)
        for ks in range(0, sk, kv_chunk):
            k_blk, v_blk = k[:, ks:ks + kv_chunk], v[:, ks:ks + kv_chunk]
            if groups > 1:
                k_blk = k_blk.repeat_interleave(groups, dim=2)
                v_blk = v_blk.repeat_interleave(groups, dim=2)
            s = (torch.einsum("bqhk,bshk->bhqs", q_blk, k_blk) * scale).float()
            if causal:
                mask = posq[:, None, :, None] >= kv_pos[ks:ks + kv_chunk]
                s = torch.where(mask, s, MASKED)
            m_new = torch.maximum(m, s.amax(dim=-1))
            pr = torch.exp(s - m_new[..., None])
            if causal:
                # a fully masked row (a kv block after the q block) adds
                # exactly zero: exp(-1e30 - (-1e30)) would give 1
                pr = pr * mask
            corr = torch.exp(m - m_new)
            denom = corr * denom + pr.sum(dim=-1)
            pv = torch.einsum("bhqs,bshk->bqhk", pr.to(v_blk.dtype), v_blk).float()
            acc = corr.transpose(1, 2)[..., None] * acc + pv
            m = m_new
        outs.append((acc / denom.clamp_min(1e-30).transpose(1, 2)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def attention_prefill(p: Attention, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                      *, q_chunk: int = 1024, kv_chunk: int = 1024
                      ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Prefill: flash attention; returns (output, (k, v)) for a cache fill."""
    q, k, v = _qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    out = flash_attention(q, k, v, positions, cfg, q_chunk=q_chunk, kv_chunk=kv_chunk)
    return _out(out, p.wo), (k, v)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device="cuda") -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def attention_decode(p: Attention, x: torch.Tensor, cache: KVCache, cfg: ArchConfig
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B, 1, D); the cache holds ``length`` valid
    entries. The new K/V is written at ``length`` (in place); attention runs
    over the whole cache with positions after ``length`` masked. No host
    sync: ``length`` stays on the device."""
    b, one, _ = x.shape
    if one != 1:
        raise ValueError(f"attention_decode takes one token a sequence, got {one}")
    pos = cache.length.expand(b, 1)
    q, k_new, v_new = _qkv(p, cfg, x)
    q = apply_rope(q, pos, cfg.rope_theta, cfg.mrope)
    k_new = apply_rope(k_new, pos, cfg.rope_theta, cfg.mrope)
    at = cache.length.view(1).long()
    ck = cache.k.index_copy_(1, at, k_new.to(cache.k.dtype))
    cv = cache.v.index_copy_(1, at, v_new.to(cache.v.dtype))
    groups = _groups(cfg)
    qg = q.reshape(b, 1, cfg.n_kv_heads, groups, cfg.hd)
    scale = cfg.hd ** -0.5
    scores = (einsum("bqhgk,bshk->bhgqs", qg, ck) * scale).float()
    valid = torch.arange(ck.shape[1], device=x.device) <= cache.length
    scores = torch.where(valid, scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = einsum("bhgqs,bshk->bqhgk", probs, cv).reshape(b, 1, cfg.n_heads, cfg.hd)
    return _out(out, p.wo), KVCache(ck, cv, cache.length + 1)
