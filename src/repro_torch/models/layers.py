"""Shared neural layers of the language models: initializers, norms, rotary
embeddings (RoPE and M-RoPE), token embedding, the stub frontend's input
(``embed_vectors``) and logits, and the MLP. The port of
``repro/models/layers.py``.

Parameters live in :class:`Params` modules whose parameter names are the
reference's dict keys, so a reference pytree converts leaf by leaf
(:func:`repro_torch.convert.lm_from_numpy`). They are created without
gradients, for serving; :func:`set_trainable` gives every floating leaf
one, for training. f32 where numerically sensitive, the config's dtype
elsewhere, as in the reference.

A product of two dtypes (activations from ``embeds`` in another dtype than
the weights) is taken in the promoted dtype, as ``jnp.einsum`` takes it
(:func:`matmul`, :func:`einsum`); ``torch.matmul`` would raise.
"""

from __future__ import annotations

import functools
import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .config import ArchConfig
from .sharding import NULL, Sharding, grad_as_input, local_map, reduce_local


class Params(nn.Module):
    """A module holding named tensors as parameters without gradients;
    ``names`` lists the keys it must have, ``optional`` those it may have,
    ``fp32`` those held in fp32 whatever the model's dtype."""

    names: tuple[str, ...] = ()
    optional: tuple[str, ...] = ()
    fp32: tuple[str, ...] = ()

    def __init__(self, tensors: Mapping[str, torch.Tensor]):
        super().__init__()
        missing = set(self.names) - set(tensors)
        extra = set(tensors) - set(self.names) - set(self.optional)
        if missing or extra:
            raise ValueError(f"{type(self).__name__}: missing {sorted(missing)}, "
                             f"unexpected {sorted(extra)}")
        for name in self.optional:
            if name not in tensors:
                self.register_parameter(name, None)
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def __contains__(self, name: str) -> bool:
        return getattr(self, name, None) is not None


def set_trainable(module: nn.Module, on: bool = True) -> nn.Module:
    """Every floating parameter of ``module`` (the fp32 ones too: the
    router, ``A_log``, ``D``, ``dt_bias``) asks for a gradient, or with
    ``on=False`` none does; returns ``module``."""
    for p in module.parameters():
        if p.is_floating_point():
            p.requires_grad_(on)
    return module


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the dtype the two promote to."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def row_parallel_out(y: torch.Tensor, wo: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """An output projection ``y @ wo`` whose contraction tp splits (y's
    last dim on each rank's tp share, wo's rows over tp), laid out
    ``("dp", None, None)``: attention's under ``head_tp``, the SSM's and
    the MLP's. Under a mesh the output's gradient is summed over the ranks
    that hold a part of it (the residual's pending sum) and laid out as
    the output: the backward then computes each rank's own share of y's
    gradient where it stands, where DTensor's rules would compute it whole
    on every rank and hand it back pending a sum. The weight comes laid
    out by the caller: attention's and the SSM's gathered over fsdp, as
    FSDP gathers it; the MLP's kept split (:func:`apply_mlp`)."""
    return grad_as_input(sh.constrain(matmul(y, wo), "dp", None, None), summed=True)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands in the dtype they promote to."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)


def dense_init(gen: torch.Generator, shape, in_axis: int = -2, dtype=torch.bfloat16,
               device="cuda") -> torch.Tensor:
    """N(0, 1/fan_in) in f32, cast to ``dtype`` (the reference's distribution;
    its bits come from ``jax.random`` and cannot be reproduced)."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    # scaled in place: one f32 copy of a 256,000-row head at a time, not two
    return _normal(gen, shape, device).mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    return (_normal(gen, shape, device) * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

class Norm(Params):
    """rmsnorm (``scale``) or layernorm (``scale`` and ``bias``)."""

    names = ("scale",)
    optional = ("bias",)


def init_norm(cfg: ArchConfig, dtype, device="cuda") -> Norm:
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return Norm(p)


def apply_norm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm or layernorm over the last dim, in fp32. Without autograd
    (serving) the fp32 copy of ``x`` is normed in place, the same ops in the
    same order: one fp32 temporary the size of ``x`` where each step would
    make another, as XLA fuses them."""
    dtype = x.dtype
    xf = x.float()
    # in place only on a copy of x, and only where no backward reads a step
    in_place = xf is not x and not torch.is_grad_enabled()
    if "bias" in p:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        if in_place:
            out = xf.sub_(mu).mul_(torch.rsqrt(var + eps)).mul_(p.scale.float()).add_(
                p.bias.float())
        else:
            out = (xf - mu) * torch.rsqrt(var + eps)
            out = out * p.scale.float() + p.bias.float()
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        if in_place:
            out = xf.mul_(torch.rsqrt(ms + eps)).mul_(p.scale.float())
        else:
            out = xf * torch.rsqrt(ms + eps) * p.scale.float()
    return out.to(dtype)


# --------------------------------------------------------------------------
# rotary embeddings (RoPE + M-RoPE)
# --------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope: bool = False) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integers, or (..., S, 3) for
    M-RoPE (temporal/height/width sections; text repeats one position three
    times, which reduces exactly to standard RoPE)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    if mrope:
        if positions.dim() == x.dim() - 2:  # text-only: expand to 3 sections
            positions = torch.stack([positions] * 3, dim=-1)
        # frequency bands split into 3 sections (t/h/w), qwen2-vl style
        n = freqs.shape[0]
        s1, s2 = n // 3, 2 * n // 3
        section = torch.tensor([0] * s1 + [1] * (s2 - s1) + [2] * (n - s2), device=x.device)
        pos = positions.float()[..., section]  # (..., S, hd/2): each band's position
        angles = pos[..., None, :] * freqs  # (..., S, 1, hd/2)
    else:
        angles = positions[..., None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# embedding + logits
# --------------------------------------------------------------------------

class Embedding(Params):
    """The token table ``(padded_vocab, d_model)`` and, untied, the head
    ``(d_model, padded_vocab)``."""

    names = ("table",)
    optional = ("head",)


def init_embedding(gen: torch.Generator, cfg: ArchConfig, dtype, device="cuda") -> Embedding:
    v = cfg.padded_vocab
    p = {"table": embed_init(gen, (v, cfg.d_model), dtype, device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, v), dtype=dtype, device=device)
    return Embedding(p)


def embed_tokens(p: Embedding, ids: torch.Tensor, *, sh: Sharding = NULL) -> torch.Tensor:
    """The rows of the token table. Under a mesh each rank takes the rows
    of the words it holds (:func:`_vocab_parallel_take`)."""
    if sh.mesh is None:
        return p.table[ids]
    return sh.constrain(_vocab_parallel_take(p.table, ids, sh), "dp", None, None)


def _vocab_parallel_take(table: torch.Tensor, ids: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """``table[ids]`` with the table laid out as the reference lays it
    out, ``("tp", "fsdp")``: each rank takes the rows of the words it holds
    (:class:`_VocabRows`, zero for the others) and the ranks that split the
    vocabulary sum them, an exact sum. How the table and the rows move
    around that is chosen a call from the shapes (:func:`_lookup_layout`).
    Runs in ``local_map``: DTensor's rule for the gather's backward
    (``index_put``) fails in some PyTorch releases."""
    from torch.distributed.tensor import Replicate, Shard

    shape = tuple(table.shape)
    spec = sh.fit_spec(shape, sh.spec("tp", "fsdp"))
    width = sh.split_dims(shape, spec, 1)
    layout = _lookup_layout(sh, shape, spec, tuple(ids.shape))
    if layout == "rows":
        ins = (spec, (None,) * ids.dim())
        out = [Shard(ids.dim()) if d in width else Replicate() for d in range(sh.mesh.ndim)]
    else:
        ins = ((spec[0] if layout == "table" else None, None),
               sh.spec("dp", *(None,) * (ids.dim() - 1)))
        out = 1
    vocab = sh.split_dims(shape, ins[0], 0)

    def local(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        first = sh.shard_index(vocab) * table.shape[0]
        return _VocabRows.apply(table, ids, first, functools.partial(reduce_local, sh, dims=vocab))

    return local_map(sh, local, ins, out)(table, ids)


def _lookup_layout(sh: Sharding, shape, spec, ids_shape) -> str:
    """How the lookup moves what it needs, whichever sends least a call
    (in full-width rows, the first on a tie):

    * ``"table"``: the table's rows of a rank's words gathered over the
      ranks that split its width, the looked-up rows then summed over the
      vocabulary's ranks, split as the ids are;
    * ``"rows"``: the ids gathered, each rank's part of the width looked up
      for every id and summed over the vocabulary's ranks, then laid out as
      the ids are (an all-to-all, or an all-gather where the ids are not
      split over the width's ranks); a decode step's few ids;
    * ``"whole"``: the whole table gathered, nothing summed; a prefill's
      many ids against a small vocabulary.

    A train step's backward sends the gather (as a reduce-scatter) or the
    all-to-all once more and sums nothing, which keeps the order of
    ``"table"`` and ``"rows"`` where their sums are equal."""
    n = sh.mesh.size
    n_vocab = math.prod(n(d) for d in sh.split_dims(shape, spec, 0))
    width = sh.split_dims(shape, spec, 1)
    n_width = math.prod(n(d) for d in width)
    batch = sh.split_dims(ids_shape, sh.spec("dp", *(None,) * (len(ids_shape) - 1)), 0)
    n_batch = math.prod(n(d) for d in batch)
    n_kept = math.prod(n(d) for d in width if d in batch)
    ids, sum_share = math.prod(ids_shape), 2 * (n_vocab - 1) / n_vocab
    sent = {"table": shape[0] / n_vocab * (n_width - 1) / n_width + sum_share * ids / n_batch,
            "rows": ids / n_kept * (n_width - 1) / n_width + sum_share * ids / n_width,
            "whole": shape[0] * (1 - 1 / (n_vocab * n_width))}
    if not width:
        del sent["rows"]
    return min(sent, key=sent.get)


class _VocabRows(torch.autograd.Function):
    """``table[ids]`` from one part of the vocabulary, the words from
    ``first`` on (``table``: (part, D')), with ``combine(x, "sum")``
    summing over the ranks that hold the other parts: each id's row where
    this part holds it, zero elsewhere. The gradient is the upstream rows
    of this part's ids accumulated into the part, by the same
    ``index_put_`` that ``table[ids]``'s own backward runs (the same bits
    on every device), and no collective."""

    @staticmethod
    def forward(ctx, table, ids, first: int, combine):
        at = ids.long() - first
        mine = (at >= 0) & (at < table.shape[0])
        at = torch.where(mine, at, 0)
        ctx.save_for_backward(at, mine)
        ctx.rows = table.shape[0]
        return combine(torch.where(mine[..., None], table[at], table.new_zeros(())), "sum")

    @staticmethod
    def backward(ctx, g):
        at, mine = ctx.saved_tensors
        grad = g.new_zeros((ctx.rows,) + tuple(g.shape[-1:]))
        rows = torch.where(mine[..., None], g, g.new_zeros(()))
        return grad.index_put_((at,), rows, accumulate=True), None, None, None


def embed_vectors(x: torch.Tensor, *, sh: Sharding = NULL) -> torch.Tensor:
    """The stub frontend's path: the inputs are already (B, S, D)
    embeddings (precomputed patch or frame embeddings), taken as they are,
    in their own dtype."""
    return sh.constrain(x, "dp", None, None)


def logits(p: Embedding, x: torch.Tensor, vocab_size: int | None = None, *,
           sh: Sharding = NULL) -> torch.Tensor:
    """The logits of ``x`` against the head (the table's transpose when
    tied), laid out ``("dp", None, "tp")``, the padded vocabulary masked.
    Under a mesh the head keeps the reference's ``("fsdp", "tp")``, or is
    gathered over fsdp for the product where that moves less
    (:func:`_gathers_head`)."""
    head = p.head if "head" in p else p.table.T
    head = sh.constrain(head, None if _gathers_head(sh, x.shape, head.shape) else "fsdp", "tp")
    out = matmul(x, head)
    v_pad = head.shape[-1]
    if vocab_size is not None and vocab_size < v_pad:
        # mask padded vocab rows so softmax/argmax never see them (int32
        # indices: the mask is the whole vocabulary's on every rank)
        mask = torch.arange(v_pad, device=out.device, dtype=torch.int32) < vocab_size
        out = torch.where(mask, out, torch.tensor(-1e30, dtype=out.dtype, device=out.device))
    return sh.constrain(out, "dp", None, "tp")


def _gathers_head(sh: Sharding, x_shape, head_shape) -> bool:
    """Whether the logits' product gathers the head over fsdp: the head's
    block of this rank's words, ``D x (V / tp)``, is smaller than what
    DTensor moves over fsdp otherwise, the activations of every token
    (``T x D``, gathered) and their logits (``T x (V / tp)``,
    reduce-scattered). A train step's tokens gather the head, as FSDP
    gathers every weight; a decode step's, or a prefill's last positions,
    move their activations."""
    if sh.mesh is None:
        return False
    spec = sh.fit_spec(tuple(head_shape), sh.spec("fsdp", "tp"))
    d, v = head_shape[0], head_shape[1] // math.prod(
        sh.mesh.size(m) for m in sh.split_dims(tuple(head_shape), spec, 1))
    return math.prod(x_shape[:-1]) * (d + v) > d * v


# --------------------------------------------------------------------------
# MLP variants
# --------------------------------------------------------------------------

class MLP(Params):
    """``wi`` (d, d_ff) and ``wo`` (d_ff, d); the gated ``silu_glu`` also
    ``wg`` (d, d_ff)."""

    names = ("wi", "wo")
    optional = ("wg",)


def init_mlp(gen: torch.Generator, cfg: ArchConfig, d_ff: int, dtype, device="cuda") -> MLP:
    d = cfg.d_model
    p = {"wi": dense_init(gen, (d, d_ff), dtype=dtype, device=device)}
    if cfg.act == "silu_glu":
        p["wg"] = dense_init(gen, (d, d_ff), dtype=dtype, device=device)
    p["wo"] = dense_init(gen, (d_ff, d), dtype=dtype, device=device)
    return MLP(p)


def apply_mlp(p: MLP, x: torch.Tensor, cfg: ArchConfig, *, sh: Sharding = NULL) -> torch.Tensor:
    """The activation in f32, cast back to the activations' dtype, as in the
    reference; ``gelu`` is ``jax.nn.gelu``'s default, the tanh form. The
    output projection is :func:`row_parallel_out`: the backward computes
    each rank's own ``d_ff`` columns on its own rows (where the gradient
    already arrives so laid out, nothing moves). Its weight stays split
    over fsdp: on a token a row (decode) or an unsplit batch (``long_500k``)
    gathering it would move more bytes than the output, and there each
    rank would compute every row's product."""
    wi = sh.constrain(p.wi, "fsdp", "tp")
    wo = sh.constrain(p.wo, "tp", "fsdp")
    h = sh.constrain(matmul(x, wi), "dp", None, "tp")
    if cfg.act == "silu_glu":
        h = F.silu(matmul(x, sh.constrain(p.wg, "fsdp", "tp")).float()).to(h.dtype) * h
    elif cfg.act == "sq_relu":
        h = F.relu(h.float()).square().to(h.dtype)
    else:  # gelu
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return row_parallel_out(h, wo, sh)
