"""GQA attention: train/prefill (full causal), cross-attention on an
encoder's states (``kv_override``), and single-token decode with a KV
cache. The port of ``repro/models/attention.py``, with its two sharding
policies (``sh``, :mod:`repro_torch.models.sharding`):

  head_tp  — q/kv heads sharded over 'tp' (kv replicated when
             n_kv_heads < tp, the standard Megatron GQA treatment);
  context  — heads intact, *sequence* sharded over 'tp' for the attention
             math (context parallelism) — used when n_heads % tp != 0.

Decode KV caches are sharded over the sequence axis ('sp') by default
(:func:`cache_spec`); under either policy the decode core then stays on
each rank's part of them and the parts' softmaxes are combined,
flash-decoding style (:func:`_decode_seq_sharded`).

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
returns (``docs/PORT.md``). Under a mesh the cache is updated out of
place (a select at ``length``) and laid out by :func:`cache_spec`, as the
reference's ``dynamic_update_slice`` and constraint update it.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .config import ArchConfig
from .layers import Params, apply_rope, dense_init, einsum, matmul, row_parallel_out
from .sharding import NULL, Sharding, grad_as_input, local_map, reduce_local

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


def _proj_spec(sh: Sharding, heads: int):
    """Weight spec for (d, H, hd) projections under the active policy."""
    if sh.attn == "head_tp" and heads % max(sh.tp_size, 1) == 0:
        return ("fsdp", "tp", None)
    return (("fsdp", "tp"), None, None)  # context: fully FSDP, heads intact


def _wo_spec(sh: Sharding, cfg: ArchConfig):
    """Weight spec for the (H, hd, d) output projection."""
    if sh.attn == "head_tp" and cfg.n_heads % max(sh.tp_size, 1) == 0:
        return ("tp", None, "fsdp")
    return (None, None, ("fsdp", "tp"))


def _act_specs(sh: Sharding, cfg: ArchConfig):
    """(q_spec, kv_spec) activation constraints for (B, S, H, hd)."""
    if sh.attn == "head_tp":
        q_spec = ("dp", None, "tp", None)
        kv_spec = (
            ("dp", None, "tp", None)
            if cfg.n_kv_heads % max(sh.tp_size, 1) == 0
            else ("dp", None, None, None)  # kv replicated across tp
        )
    else:  # context parallel: shard the sequence
        q_spec = ("dp", "sp", None, None)
        kv_spec = ("dp", None, None, None)
    return q_spec, kv_spec


def _proj(x: torch.Tensor, w: torch.Tensor, spec, sh: Sharding) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matmul. DTensor may split the
    (B, S, H*hd) product over mesh dims whose size does not divide the
    heads, and such a product cannot be unflattened: it is then laid out by
    the activation ``spec`` (B, S, H, hd) first, and else left as it is
    (a constraint would sum a partial product before the RoPE, not after).
    The flattened weight's gradient comes back split as the weight is, for
    the same reason."""
    d, h, k = w.shape
    y = matmul(x, grad_as_input(w.reshape(d, h * k)))
    if not _splits_whole_heads(y, h):
        y = sh.constrain(y, *spec[:3])
    return y.unflatten(-1, (h, k))


def _splits_whole_heads(y: torch.Tensor, h: int) -> bool:
    """Whether the mesh dims that split ``y``'s last dim split it in whole
    heads (always, for a plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(y, DTensor):
        return True
    ways = [y.device_mesh.size(i) for i, p in enumerate(y.placements)
            if isinstance(p, Shard) and p.dim == y.ndim - 1]
    return all(type(p) is Shard or not p.is_shard() for p in y.placements) and h % math.prod(
        ways) == 0


def _q(p: Attention, cfg: ArchConfig, x: torch.Tensor, sh: Sharding) -> torch.Tensor:
    q = _proj(x, sh.constrain(p.wq, *_proj_spec(sh, cfg.n_heads)), _act_specs(sh, cfg)[0], sh)
    return q + p.bq if cfg.qkv_bias else q


def _qkv(p: Attention, cfg: ArchConfig, x: torch.Tensor, sh: Sharding):
    kv, kv_spec = _proj_spec(sh, cfg.n_kv_heads), _act_specs(sh, cfg)[1]
    k = _proj(x, sh.constrain(p.wk, *kv), kv_spec, sh)
    v = _proj(x, sh.constrain(p.wv, *kv), kv_spec, sh)
    if cfg.qkv_bias:
        k = k + p.bk
        v = v + p.bv
    return _q(p, cfg, x, sh), k, v


def _out(out: torch.Tensor, wo: torch.Tensor, cfg: ArchConfig, sh: Sharding) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one matmul, on the whole sequence
    (gathered under ``context``: a product that flattens (batch, sequence)
    with the sequence split fails DTensor's sharding rules); both flattened
    operands' gradients come back laid out as they are (see :func:`_proj`).
    Under ``head_tp`` the weight is gathered over fsdp first, as FSDP
    gathers it, and the product is :func:`layers.row_parallel_out`: the
    backward computes each rank's heads' gradient where it stands."""
    q_spec = _act_specs(sh, cfg)[0]
    head_tp = _wo_spec(sh, cfg)[0] == "tp"
    out = grad_as_input(sh.constrain(out, q_spec[0], None, *q_spec[2:]).flatten(-2))
    wo = grad_as_input(sh.constrain(wo, *_wo_spec(sh, cfg)).reshape(-1, wo.shape[-1]))
    if head_tp:
        return row_parallel_out(out, sh.constrain(wo, "tp", None), sh)
    return sh.constrain(matmul(out, wo), "dp", None, None)


def _groups(cfg: ArchConfig) -> int:
    return cfg.n_heads // max(cfg.n_kv_heads, 1)


def attention(p: Attention, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor | None,
              *, causal: bool = True,
              kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
              sh: Sharding = NULL) -> torch.Tensor:
    """Full (train) attention. x: (B, S, D) -> (B, S, D).

    ``kv_override`` supplies an encoder's K and V, (B, S_enc, n_kv, hd), for
    cross-attention: no RoPE, no mask (``positions`` and ``causal`` are not
    read)."""
    if kv_override is not None:
        q = _q(p, cfg, x, sh)
        k, v = kv_override
        causal = False
    else:
        q, k, v = _qkv(p, cfg, x, sh)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    q_spec, kv_spec = _act_specs(sh, cfg)
    q, k, v = sh.constrain(q, *q_spec), sh.constrain(k, *kv_spec), sh.constrain(v, *kv_spec)
    groups = _groups(cfg)
    if groups > 1:
        k = sh.constrain(k.repeat_interleave(groups, dim=2), *q_spec)
        v = sh.constrain(v.repeat_interleave(groups, dim=2), *q_spec)
    core = functools.partial(_core, scale=cfg.hd ** -0.5, dtype=x.dtype)
    args = (q, k, v) + ((positions,) if causal else ())
    out = local_map(sh, core, _core_specs(sh, q_spec)[:len(args)], 0)(*args)
    return _out(out, p.wo, cfg, sh)


def _core_specs(sh: Sharding, q_spec) -> tuple:
    """The specs of (q, k, v, positions) for attention's core on local
    shards: each rank's batch rows and heads (head_tp), or its query
    positions (context), K and V whole there."""
    kv_core = q_spec if sh.attn == "head_tp" else ("dp", None, None, None)
    return tuple(sh.spec(*d) for d in (q_spec, kv_core, kv_core, q_spec[:2]))


def _core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor | None = None,
          *, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, hd) on k and v (B, Sk, H, hd),
    causal by ``positions`` (B, Sq) where given: (B, Sq, H, hd)."""
    scores = (einsum("bqhk,bshk->bhqs", q, k) * scale).float()
    if positions is not None:
        mask = positions[:, None, :, None] >= torch.arange(k.shape[1], device=q.device)
        scores = torch.where(mask, scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return einsum("bhqs,bshk->bqhk", probs, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                    cfg: ArchConfig, *, q_chunk: int = 1024, kv_chunk: int = 1024,
                    causal: bool = True) -> torch.Tensor:
    """Double-blocked streaming-softmax attention, for long prefills: score
    blocks of (B, H, q_chunk, kv_chunk) instead of (B, H, S, S). q: (B, Sq,
    H, hd); k/v: (B, Sk, n_kv, hd). Every block is computed, as the
    reference's scans compute it: a fully masked one adds exactly zero.
    Query head ``h`` reads kv head ``h // (H / k's heads)``.

    A serving path (no autograd): each score block is scaled, masked and
    exponentiated in place, one fp32 block at a time where each step would
    make another, and each q block's result is written into one output,
    with no list to join; the same ops in the same order as out of
    place."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    groups = h // k.shape[2]
    scale = hd ** -0.5
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, sk)
    if sq % q_chunk or sk % kv_chunk:
        raise ValueError(f"flash_attention: lengths {sq} and {sk} are not multiples of the "
                         f"chunks {q_chunk} and {kv_chunk}")
    kv_pos = torch.arange(sk, device=q.device)
    out = torch.empty_like(q)
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
            s = torch.einsum("bqhk,bshk->bhqs", q_blk, k_blk).mul_(scale).float()
            if causal:
                mask = posq[:, None, :, None] >= kv_pos[ks:ks + kv_chunk]
                s.masked_fill_(~mask, MASKED)
            m_new = torch.maximum(m, s.amax(dim=-1))
            pr = s.sub_(m_new[..., None]).exp_()
            if causal:
                # a fully masked row (a kv block after the q block) adds
                # exactly zero: exp(-1e30 - (-1e30)) would give 1
                pr.mul_(mask)
            corr = torch.exp(m - m_new)
            denom = corr * denom + pr.sum(dim=-1)
            pv = torch.einsum("bhqs,bshk->bqhk", pr.to(v_blk.dtype), v_blk).float()
            acc = corr.transpose(1, 2)[..., None] * acc + pv
            m = m_new
        out[:, qs:qs + q_chunk] = acc / denom.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out


def attention_prefill(p: Attention, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                      *, q_chunk: int = 1024, kv_chunk: int = 1024, sh: Sharding = NULL
                      ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Prefill: flash attention; returns (output, (k, v)) for a cache fill."""
    q, k, v = _qkv(p, cfg, x, sh)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    q_spec, kv_spec = _act_specs(sh, cfg)
    q, k, v = sh.constrain(q, *q_spec), sh.constrain(k, *kv_spec), sh.constrain(v, *kv_spec)
    flash = functools.partial(flash_attention, cfg=cfg, q_chunk=q_chunk, kv_chunk=kv_chunk)
    if sh.mesh is None:
        return _out(flash(q, k, v, positions), p.wo, cfg, sh), (k, v)
    # on local shards, K and V expanded to the query's heads first so that
    # a rank's heads find theirs
    groups = _groups(cfg)
    ke, ve = k, v
    if groups > 1:
        ke = sh.constrain(k.repeat_interleave(groups, dim=2), *q_spec)
        ve = sh.constrain(v.repeat_interleave(groups, dim=2), *q_spec)
    out = local_map(sh, flash, _core_specs(sh, q_spec), 0)(q, ke, ve, positions)
    return _out(out, p.wo, cfg, sh), (k, v)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device="cuda") -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def cache_spec(cfg: ArchConfig, sh: Sharding):
    """KV cache sharding: sequence-sharded ('sp') by default — the flash-
    decoding layout — falling back to head sharding when configured."""
    if sh.decode_cache == "heads" and cfg.n_kv_heads % max(sh.tp_size, 1) == 0:
        return ("dp", None, "tp", None)
    return ("dp", "sp", None, None)


def attention_decode(p: Attention, x: torch.Tensor, cache: KVCache, cfg: ArchConfig, *,
                     sh: Sharding = NULL) -> tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B, 1, D); the cache holds ``length`` valid
    entries. The new K/V is written at ``length`` (in place); attention runs
    over the whole cache with positions after ``length`` masked. No host
    sync: ``length`` stays on the device."""
    b, one, _ = x.shape
    if one != 1:
        raise ValueError(f"attention_decode takes one token a sequence, got {one}")
    pos = cache.length.expand(b, 1)
    q, k_new, v_new = _qkv(p, cfg, x, sh)
    q = apply_rope(q, pos, cfg.rope_theta, cfg.mrope)
    k_new = apply_rope(k_new, pos, cfg.rope_theta, cfg.mrope)
    at = cache.length.view(1).long()
    core = functools.partial(_decode_core, groups=_groups(cfg), scale=cfg.hd ** -0.5,
                             dtype=x.dtype)
    spec = cache_spec(cfg, sh)
    if sh.mesh is None:
        ck = cache.k.index_copy_(1, at, k_new.to(cache.k.dtype))
        cv = cache.v.index_copy_(1, at, v_new.to(cache.v.dtype))
        out = core(q, ck, cv, cache.length)
    elif spec[1] == "sp":
        ck, cv, out = _decode_seq_sharded(q, k_new, v_new, cache, sh.spec(*spec), core, sh)
    else:
        # out of place, as a select at ``length``: DTensor's sharding rules
        # do not cover index_copy in every PyTorch release
        at_length = torch.arange(cache.k.shape[1], device=x.device)[:, None, None] == cache.length
        ck = sh.constrain(torch.where(at_length, k_new.to(cache.k.dtype), cache.k), *spec)
        cv = sh.constrain(torch.where(at_length, v_new.to(cache.v.dtype), cache.v), *spec)
        # a head-sharded cache: each rank's batch rows over all heads (the
        # cache's heads gathered over tp) and the whole sequence
        rows = sh.spec("dp", None, None, None)
        out = local_map(sh, core, (rows, rows, rows, ()), 0)(q, ck, cv, cache.length)
    y = sh.constrain(matmul(out.flatten(-2), p.wo.reshape(-1, p.wo.shape[-1])), "dp", None, None)
    return y, KVCache(ck, cv, cache.length + 1)


def _decode_seq_sharded(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                        cache: KVCache, spec, core, sh: Sharding):
    """The decode step on a cache split over its sequence (flash decoding):
    each rank writes the new K and V into its own positions (a select,
    which changes the shard that holds ``length`` alone), attends its batch
    rows' query to its own positions (each masked by its global position),
    and the ranks that split the sequence combine their softmaxes:
    (new cache K, new cache V, the output (B, 1, H, hd))."""
    seq = sh.split_dims(tuple(cache.k.shape), spec, 1)
    pos_spec = (spec[1],)
    kv_pos = sh.place(torch.arange(cache.k.shape[1], device=q.device), pos_spec)
    rows = sh.spec("dp", None, None, None)

    def write(old: torch.Tensor, new: torch.Tensor, kv_pos: torch.Tensor,
              length: torch.Tensor) -> torch.Tensor:
        return torch.where((kv_pos == length)[:, None, None], new.to(old.dtype), old)

    put = local_map(sh, write, (spec, rows, pos_spec, ()), 0)
    ck, cv = put(cache.k, k_new, kv_pos, cache.length), put(cache.v, v_new, kv_pos, cache.length)
    attend = functools.partial(core, combine=functools.partial(reduce_local, sh, dims=seq))
    out = local_map(sh, attend, (rows, spec, spec, (), pos_spec), 0)(q, ck, cv, cache.length,
                                                                     kv_pos)
    return ck, cv, out


def _decode_core(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, length: torch.Tensor,
                 kv_pos: torch.Tensor | None = None, *, groups: int, scale: float,
                 dtype: torch.dtype, combine=None) -> torch.Tensor:
    """One query position's attention (q: (B, 1, H, hd)) over the cache's
    positions up to ``length``: (B, 1, H, hd); q head ``h`` reads kv head
    ``h // groups``.

    With ``combine`` the cache holds a part of the positions, ``kv_pos``
    (their global positions), and ``combine(x, op)`` reduces ``x`` by
    ``op`` over the ranks that hold the others: each part's softmax output
    is weighted by its share ``exp(m - max m) * l / sum(...)`` of the
    whole softmax's sum (``m`` its largest score, ``l`` its sum of
    ``exp(score - m)``) and the parts are summed in fp32. A part with no
    valid position weighs 0, and a lone part weighs exactly 1."""
    b, _, kv, hd = q.shape[0], q.shape[1], ck.shape[2], q.shape[3]
    qg = q.reshape(b, 1, kv, groups, hd)
    scores = (einsum("bqhgk,bshk->bhgqs", qg, ck) * scale).float()
    if kv_pos is None:
        kv_pos = torch.arange(ck.shape[1], device=q.device)
    valid = kv_pos <= length
    scores = torch.where(valid, scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = einsum("bhgqs,bshk->bqhgk", probs, cv)
    if combine is not None:
        m = scores.amax(dim=-1, keepdim=True)
        share = torch.exp(m - combine(m, "max")) * torch.exp(scores - m).sum(dim=-1, keepdim=True)
        share = (share / combine(share, "sum")).permute(0, 3, 1, 2, 4)  # (b, 1, kv, groups, 1)
        out = combine(out.float() * share, "sum").to(dtype)
    return out.reshape(b, 1, kv * groups, hd)
