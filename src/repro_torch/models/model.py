"""The language models' entry points: initialization, the train/prefill
forward, and the decode step, for the decoder-only model and the
encoder-decoder model (the whisper backbone). The port of
``repro/models/model.py``.

``init_params`` puts the model on the card unless the caller passes
``device="cpu"``. ``forward`` and ``decode_step`` serve, without autograd;
``loss_fn`` trains, through the same forward (``_forward``) in ``train``
mode, with the gradient of every parameter that asks for one
(:func:`~repro_torch.models.layers.set_trainable`). Each takes the
sharding policy as the keyword ``sh`` (:mod:`repro_torch.models.sharding`;
under a mesh it runs on DTensors, inside
:func:`~repro_torch.models.sharding.replicating`), and ``param_specs`` and
``cache_specs`` give the specs the sharded steps lay the parameters and
the decode caches out by. ``init_params(device="meta")`` builds the
shapes without drawing, as ``jax.eval_shape`` does. As in
the reference, prefill hands no state to decode: ``decode_step`` starts
from ``init_decode_state``'s zeroed caches, and an encoder-decoder model's
decoder reads the encoder through the ``cross_kv`` its caller passes.

A batch carrying ``embeds`` (a stub frontend's precomputed patch or frame
embeddings) is read from them, whatever the model, as in the reference.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from ..engine.context import check_device
from .attention import KVCache
from .blocks import apply_stack, apply_stack_decode, init_stack, init_stack_cache
from .config import ArchConfig
from .layers import (
    Embedding,
    Norm,
    apply_norm,
    embed_tokens,
    embed_vectors,
    init_embedding,
    init_norm,
)
from .layers import logits as lm_logits
from .sharding import NULL, Sharding, Spec, local_map, reduce_local, replicating
from .ssm import SSMCache

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MODES = ("train", "prefill")
LOGITS_POSITIONS = ("all", "last")


class LM(nn.Module):
    """``embed`` (the token table and, untied, the head), ``final_norm``,
    and either ``blocks`` (decoder-only, one layer each) or ``encoder``,
    ``enc_norm`` and ``decoder`` (encoder-decoder), named as the
    reference's pytree; the parts a model lacks are None."""

    def __init__(self, embed: Embedding, final_norm: Norm, blocks: nn.ModuleList | None = None,
                 *, encoder: nn.ModuleList | None = None, enc_norm: Norm | None = None,
                 decoder: nn.ModuleList | None = None):
        super().__init__()
        encdec = (encoder, enc_norm, decoder)
        if len({p is None for p in encdec}) > 1 or (blocks is None) == (encoder is None):
            raise ValueError("a model holds blocks, or encoder, enc_norm and decoder")
        self.embed = embed
        self.final_norm = final_norm
        self.blocks = blocks
        self.encoder, self.enc_norm, self.decoder = encdec

    @property
    def is_encdec(self) -> bool:
        return self.blocks is None


def _stack(params: LM, cfg: ArchConfig) -> nn.ModuleList:
    """The stack that decodes: ``blocks`` or the decoder; ``ValueError``
    where the model's kind is not the config's."""
    if params.is_encdec != cfg.is_encdec:
        kinds = ("decoder-only", "encoder-decoder")
        raise ValueError(f"{cfg.name}: the config is {kinds[cfg.is_encdec]}, the model "
                         f"{kinds[params.is_encdec]}")
    return params.decoder if cfg.is_encdec else params.blocks


def init_params(cfg: ArchConfig, *, generator: torch.Generator, device="cuda",
                dtype: torch.dtype | None = None) -> LM:
    """The model with weights drawn from ``generator`` (on ``device``) in
    the reference's distributions, in ``dtype`` (default the config's).
    On ``device="meta"`` only the shapes and dtypes, nothing drawn or
    allocated (the reference's ``jax.eval_shape(init_params, ...)``)."""
    dev = torch.device("meta") if str(device) == "meta" else check_device(device, "init_params")
    dtype = dtype or DTYPES[cfg.dtype]
    embed, final_norm = init_embedding(generator, cfg, dtype, dev), init_norm(cfg, dtype, dev)
    if not cfg.is_encdec:
        return LM(embed, final_norm, init_stack(generator, cfg, dtype, dev))
    return LM(embed, final_norm, encoder=init_stack(generator, cfg, dtype, dev),
              enc_norm=init_norm(cfg, dtype, dev),
              decoder=init_stack(generator, cfg, dtype, dev, n_layers=cfg.dec_layers,
                                 cross_attn=True))


def _inputs_to_hidden(params: LM, cfg: ArchConfig, batch: dict, sh: Sharding) -> torch.Tensor:
    if cfg.frontend != "none" or "embeds" in batch:
        return embed_vectors(batch["embeds"], sh=sh)
    return embed_tokens(params.embed, batch["tokens"], sh=sh)


def _keeps_dtype(cfg: ArchConfig, dtype: torch.dtype, what: str, other: torch.dtype) -> None:
    """``ValueError`` where ``what`` in ``other`` would promote the stack's
    ``dtype`` activations: the reference's stack is a ``lax.scan`` whose
    carry keeps its dtype, and raises there (bf16 embeds on an fp32 model;
    whisper's fp32 encoder states under a bf16 decoder)."""
    if torch.promote_types(dtype, other) != dtype:
        raise ValueError(f"{cfg.name}: {what} in {other} would promote the layer stack's "
                         f"{dtype} activations; the stack keeps its dtype, as the reference's "
                         f"does")


def _check_embeds(params: LM, cfg: ArchConfig, x: torch.Tensor) -> None:
    """Embeds in a wider dtype than the weights (fp32 on a bf16 model) run
    through attention, the MLP and the logits in that dtype, promoted as the
    reference promotes them; an SSM or MoE layer takes only the model's
    dtype (``docs/PORT.md``)."""
    dtype = params.embed.table.dtype
    if x.dtype == dtype:
        return
    _keeps_dtype(cfg, x.dtype, "the weights", dtype)
    stack = params.encoder if params.is_encdec else params.blocks
    if any(p.ssm is not None or p.moe is not None for p in stack):
        raise ValueError(f"{cfg.name}: embeds in {x.dtype} on a model in {dtype} with SSM or "
                         f"MoE layers")


def _encoder_kv(cfg: ArchConfig, enc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder's hidden states as (B, S, n_kv, hd) K/V stand-ins, one
    tensor for both: cross-attention reads the encoder's states directly,
    as in the reference (its ``xattn`` K/V weights are not read)."""
    b, s, d = enc.shape
    kv = enc.reshape(b, s, cfg.n_kv_heads, d // cfg.n_kv_heads)
    if kv.shape[-1] != cfg.hd:
        kv = kv[..., :cfg.hd]
    return kv, kv


@torch.no_grad()
def forward(params: LM, cfg: ArchConfig, batch: dict, *, mode: str = "train",
            logits_positions: str = "all", sh: Sharding = NULL
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_forward` without autograd (serving)."""
    return _forward(params, cfg, batch, mode=mode, logits_positions=logits_positions, sh=sh)


def _forward(params: LM, cfg: ArchConfig, batch: dict, *, mode: str = "train",
             logits_positions: str = "all", sh: Sharding = NULL
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S_dec, V), moe_aux: the MoE layers' load-balancing
    losses summed, 0 without MoE); ``logits_positions="last"`` (what a
    prefill serves) gives (B, 1, V). ``batch`` carries 'tokens' (B, S) or
    'embeds' (B, S, D) (which win whenever present, and which a config with
    a frontend needs), for the encoder-decoder model also 'dec_tokens'
    (B, S_dec), and optionally 'positions' (B, S), else 0..S-1 (M-RoPE's
    three-section positions (B, S, 3) raise ``ValueError``, as the
    reference's forward raises). ``mode="prefill"`` runs attention
    blockwise (:func:`~repro_torch.models.attention.flash_attention`),
    causally in the encoder too, as in the reference; the SSM and MoE
    layers compute the same in both modes. The decoder of the
    encoder-decoder model runs teacher-forced in ``train`` mode on
    positions 0..S_dec-1."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if logits_positions not in LOGITS_POSITIONS:
        raise ValueError(f"logits_positions must be one of {LOGITS_POSITIONS}, "
                         f"got {logits_positions!r}")
    _stack(params, cfg)
    with replicating(sh):
        return _forward_body(params, cfg, batch, mode, logits_positions, sh)


def _forward_body(params: LM, cfg: ArchConfig, batch: dict, mode: str, logits_positions: str,
                  sh: Sharding) -> tuple[torch.Tensor, torch.Tensor]:
    x = _inputs_to_hidden(params, cfg, batch, sh)
    _check_embeds(params, cfg, x)
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    elif tuple(positions.shape) != (b, s):
        raise ValueError(f"{cfg.name}: positions of shape {tuple(positions.shape)}, the "
                         f"forward takes ({b}, {s})")
    # each rank's batch rows, as x's: RoPE's tables then cover only them
    positions = sh.constrain(positions, "dp", None)
    if cfg.is_encdec:
        enc, aux = apply_stack(params.encoder, x, cfg, positions, mode=mode, causal=False, sh=sh)
        enc = apply_norm(params.enc_norm, enc)
        _keeps_dtype(cfg, params.embed.table.dtype, "the encoder's states", enc.dtype)
        y = embed_tokens(params.embed, batch["dec_tokens"], sh=sh)
        db, ds = y.shape[:2]
        dpos = sh.constrain(torch.arange(ds, dtype=torch.int32, device=y.device).expand(db, ds),
                            "dp", None)
        x, aux2 = apply_stack(params.decoder, y, cfg, dpos, mode="train", causal=True,
                              cross_kv=_encoder_kv(cfg, enc), sh=sh)
        aux = aux + aux2
    else:
        x, aux = apply_stack(params.blocks, x, cfg, positions, mode=mode, sh=sh)
    x = sh.constrain(apply_norm(params.final_norm, x), "dp", None, None)
    if logits_positions == "last":
        x = x[:, -1:, :]
    return lm_logits(params.embed, x, vocab_size=cfg.vocab_size, sh=sh), aux


def loss_fn(params: LM, cfg: ArchConfig, batch: dict, aux_weight: float = 0.01, *,
            sh: Sharding = NULL) -> tuple[torch.Tensor, dict]:
    """The training loss, as the reference's: the mean next-token NLL of
    the ``train``-mode logits in fp32 (``logsumexp`` over the padded
    vocabulary as :func:`~repro_torch.models.layers.logits` masks it, less
    the gold logit at ``batch["labels"]``, or ``batch["dec_labels"]`` for
    the encoder-decoder model), plus ``aux_weight`` times the MoE aux loss.
    -> (total, {"nll", "aux"}), differentiable where the parameters are.
    Under a mesh they are DTensors (``sharding.full`` reads one), and a
    backward runs inside ``sharding.replicating(sh)``."""
    out, aux = _forward(params, cfg, batch, mode="train", sh=sh)
    labels = batch["dec_labels" if cfg.is_encdec else "labels"]
    with replicating(sh):
        nll = (_nll(out.float(), labels) if sh.mesh is None
               else _vocab_parallel_nll(out.float(), labels, sh)).mean()
        total = nll + aux_weight * aux
    return total, {"nll": nll, "aux": aux}


def _nll(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's NLL of its label: ``logsumexp`` over the vocabulary
    less the gold logit."""
    logz = torch.logsumexp(out, dim=-1)
    return logz - torch.gather(out, -1, labels[..., None].long())[..., 0]


def _vocab_parallel_nll(out: torch.Tensor, labels: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """:func:`_nll` on the logits as ``lm_logits`` lays them out, the
    vocabulary split over tp: each rank takes its batch rows over its own
    words (:class:`_VocabNLL`), and the ranks that split the vocabulary
    all-reduce their maxima, their sums of ``exp`` and their gold logits."""
    spec = sh.fit_spec(tuple(out.shape), sh.spec("dp", None, "tp"))
    vocab = sh.split_dims(tuple(out.shape), spec, 2)

    def local(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        first = sh.shard_index(vocab) * out.shape[-1]
        return _VocabNLL.apply(out, labels, first, functools.partial(reduce_local, sh, dims=vocab))

    return local_map(sh, local, (spec, spec[:2]), 1)(out, labels)


class _VocabNLL(torch.autograd.Function):
    """Each position's NLL of its label from one part of the vocabulary,
    the words from ``first`` on (``out``: (..., part) fp32 logits), with
    ``combine(x, op)`` reducing over the ranks that hold the other parts:
    ``logsumexp`` taken as ``torch.logsumexp`` takes it (the largest logit
    out, where finite) on the combined maximum and sum, less the gold logit
    of the part that holds the label (0 in the others). The gradient is
    the local softmax less the one-hot of a label in the part, as
    ``logsumexp``'s and ``gather``'s gradients sum to."""

    @staticmethod
    def forward(ctx, out, labels, first: int, combine):
        m = combine(out.amax(dim=-1), "max")
        m = torch.where(m.abs() == math.inf, 0.0, m)
        logz = torch.log(combine(torch.exp(out - m[..., None]).sum(dim=-1), "sum")) + m
        at = labels.long() - first
        mine = (at >= 0) & (at < out.shape[-1])
        at = at.clamp(0, out.shape[-1] - 1)
        gold = torch.where(mine, torch.gather(out, -1, at[..., None])[..., 0], 0.0)
        ctx.save_for_backward(out, logz, at, mine)
        return logz - combine(gold, "sum")

    @staticmethod
    def backward(ctx, g):
        out, logz, at, mine = ctx.saved_tensors
        grad = g[..., None] * torch.exp(out - logz[..., None])
        return (grad.scatter_add_(-1, at[..., None], torch.where(mine, -g, 0.0)[..., None]),
                None, None, None)


def init_decode_state(params: LM, cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """Zeroed caches for ``batch`` sequences: ``max_len`` positions for each
    attention layer's K and V (the decoder's, for the encoder-decoder
    model); an SSM layer's state has no length."""
    return {"caches": init_stack_cache(_stack(params, cfg), cfg, batch, max_len,
                                       params.embed.table.dtype)}


@torch.no_grad()
def decode_step(params: LM, cfg: ArchConfig, state: dict, tokens: torch.Tensor,
                cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None, *,
                sh: Sharding = NULL) -> tuple[torch.Tensor, dict]:
    """One serving step: next-token logits (B, 1, V) + updated caches.
    ``tokens``: (B, 1) integers. ``cross_kv``: the encoder's K/V
    (:func:`_encoder_kv` of the normed encoder states); without it the
    decoder's cross-attention is skipped, as in the reference."""
    stack = _stack(params, cfg)
    if cross_kv is not None:
        _keeps_dtype(cfg, params.embed.table.dtype, "cross_kv", cross_kv[0].dtype)
    with replicating(sh):
        x = embed_tokens(params.embed, tokens, sh=sh)
        x, caches = apply_stack_decode(stack, state["caches"], x, cfg, cross_kv=cross_kv, sh=sh)
        x = apply_norm(params.final_norm, x)
        return lm_logits(params.embed, x, vocab_size=cfg.vocab_size, sh=sh), {"caches": caches}


# --------------------------------------------------------------------------
# parameter and cache partition specs
# --------------------------------------------------------------------------

def _leaf_spec(name: str, ndim: int, cfg: ArchConfig, sh: Sharding) -> Spec:
    """The spec of parameter ``name`` (a dotted name of :class:`LM`): the
    reference's ``_leaf_spec`` (``repro/models/model.py``) without its
    leading ``n_groups`` entry, the port's layers being unstacked."""
    names = [n for n in name.split(".") if not n.isdigit()]
    last = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    mk = sh.spec
    head_tp = sh.attn == "head_tp" and cfg.n_heads % max(sh.tp_size, 1) == 0
    if parent == "embed":
        return mk("tp", "fsdp") if last == "table" else mk("fsdp", "tp")
    if last in ("scale", "bias", "A_log", "D", "dt_bias", "norm_scale"):
        return mk(None)
    if parent in ("attn", "xattn"):
        if last in ("wq", "wk", "wv"):
            heads = cfg.n_heads if last == "wq" else cfg.n_kv_heads
            if head_tp and heads % max(sh.tp_size, 1) == 0:
                return mk("fsdp", "tp", None)
            return mk(("fsdp", "tp"), None, None)
        if last == "wo":
            if head_tp:
                return mk("tp", None, "fsdp")
            return mk(None, None, ("fsdp", "tp"))  # (H, hd, d): shard d
        return mk(None, None)  # biases (H, hd)
    if parent == "mlp":
        return mk("fsdp", "tp") if last in ("wi", "wg") else mk("tp", "fsdp")
    if parent == "moe":
        if last == "router":
            return mk("fsdp", None)
        if sh.moe == "expert":
            return mk("tp", "fsdp", None) if last in ("wi", "wg") else mk("tp", None, "fsdp")
        return mk(None, "fsdp", "tp") if last in ("wi", "wg") else mk(None, "tp", "fsdp")
    if parent == "ssm":
        if last in ("wz", "wx"):
            return mk("fsdp", "tp")
        if last == "wo":
            return mk("tp", "fsdp")
        if last in ("wB", "wC", "wdt"):
            return mk("fsdp", None)
        if last == "conv_w":
            return mk(None, None)
    return (None,) * ndim


def param_specs(params: LM, cfg: ArchConfig, sh: Sharding) -> dict[str, Spec]:
    """The spec of each parameter, by its name in ``params.named_parameters()``
    (for the sharded steps' layouts); ``()`` for each without a mesh.
    Per-dim divisibility is enforced via ``sh.fit_spec`` (small models on
    big meshes back off to feasible axis prefixes)."""
    if sh.mesh is None:
        return {k: () for k, _ in params.named_parameters()}
    return {k: sh.fit_spec(p.shape, _leaf_spec(k, p.dim(), cfg, sh))
            for k, p in params.named_parameters()}


def cache_specs(state: dict, cfg: ArchConfig, sh: Sharding) -> dict:
    """Specs for the decode caches, the structure of ``state``: KV over
    (dp batch, sp seq), SSM state over (dp, tp heads), lengths replicated;
    ``()`` at each leaf without a mesh."""
    specs: list = []
    for c in state["caches"]:
        if sh.mesh is None:
            specs.append(type(c)(*(() for _ in c)))
        elif isinstance(c, KVCache):
            kv = sh.spec("dp", "sp", None, None)
            specs.append(KVCache(k=kv, v=kv, length=()))
        elif isinstance(c, SSMCache):
            specs.append(SSMCache(conv=sh.spec("dp", None, None),
                                  state=sh.spec("dp", "tp", None, None), length=()))
        else:
            raise TypeError(f"cache_specs: a cache of type {type(c).__name__}")
    return {"caches": specs}
