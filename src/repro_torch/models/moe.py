"""Mixture-of-Experts: the top-k router and capacity-based dispatch. The
port of ``repro/models/moe.py``.

Dispatch does only the experts' share of the work (top_k x capacity_factor
of the tokens, never every expert on every token) in O(T*k) memory: each
choice's place in its expert's queue comes from a stable sort, and the
kept choices are scattered into one ``(E, cap, D)`` buffer. The steps are
separate functions (:func:`route`, :func:`capacity`, :func:`assign`,
:func:`dispatch`, :func:`experts`, :func:`combine`), and :func:`apply_moe`
takes a :class:`Routing` from the caller, so a check can hold one routing
decision fixed while it compares what follows.

Sharding policies (``sh.moe``, :mod:`repro_torch.models.sharding`):
  'expert' — experts sharded over 'tp' (EP);
  'ffn'    — expert count kept local, per-expert FFN dim sharded over 'tp'
             (for n_experts % tp != 0, e.g. granite's 40 experts on 16).
Under a mesh every rank routes its own tokens (its ``dp`` shard of the
batch), and :func:`assign`, :func:`dispatch` and :func:`combine` (a sort,
an ``index_add_``, scatters and gathers, which DTensor has no rule for)
run on them through ``local_map`` (:func:`_apply_sharded`):

* each choice's queue position is the global one, token-major over the
  whole batch: the local position plus the expert's count of choices on
  the lower ``dp`` ranks (an all-gather of an ``(E,)`` count over ``dp``);
* each rank fills the slots of its own experts (``expert``) or of every
  expert (``ffn``) with its own tokens, zeros elsewhere, and the buffers
  are summed over ``dp`` (every slot is written on one rank alone, so the
  sum is exact) into the layout the reference constrains them to: an
  all-reduce, a reduce-scatter where ``moe_dispatch="dp"`` shards the
  slots;
* the expert FFN runs on those buffers, and each rank takes back its own
  tokens' rows from its experts, the other choices at weight 0; the
  tokens' outputs are summed over the ranks that split the experts (an
  all-reduce of ``(T / dp, D)``, k times smaller than the choices'
  ``(T / dp, k, D)`` rows). That sum adds the k choices in another order
  than the unsharded sum over k does: the same values to rounding.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import Params, dense_init
from .sharding import NULL, Sharding, gather_local, grad_as_input, local_map


class MoE(Params):
    """``router`` (D, E), always fp32; ``wi`` (E, D, F), ``wo`` (E, F, D)
    and, for ``silu_glu``, ``wg`` (E, D, F), in the model's dtype."""

    names = ("router", "wi", "wo")
    optional = ("wg",)
    fp32 = ("router",)


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype, device="cuda") -> MoE:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {
        "router": dense_init(gen, (d, e), dtype=torch.float32, device=device),
        "wi": dense_init(gen, (e, d, f), in_axis=1, dtype=dtype, device=device),
        "wo": dense_init(gen, (e, f, d), in_axis=1, dtype=dtype, device=device),
    }
    if cfg.act == "silu_glu":
        p["wg"] = dense_init(gen, (e, d, f), in_axis=1, dtype=dtype, device=device)
    return MoE(p)


class Routing(NamedTuple):
    """One routing decision for T tokens: the router's softmax ``probs``
    (T, E), and each token's top-k ``ids`` (T, k, in descending order of
    probability) with their ``gates`` (T, k), renormalized to sum to 1;
    fp32."""

    probs: torch.Tensor
    gates: torch.Tensor
    ids: torch.Tensor


def route(p: MoE, xf: torch.Tensor, k: int) -> Routing:
    """The router in fp32 for tokens ``xf`` (T, D)."""
    probs = torch.softmax(xf.float() @ p.router, dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)  # sorted, as lax.top_k
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return Routing(probs, gates, ids)


def aux_loss(r: Routing, e: int) -> torch.Tensor:
    """The Switch-style load-balancing loss: E x sum over experts of the
    mean router probability times the mean count of choices."""
    me = r.probs.mean(dim=0)
    ce = F.one_hot(r.ids, e).float().sum(dim=1).mean(dim=0)
    return e * (me * ce).sum()


def router_margin(r: Routing) -> torch.Tensor:
    """The smallest gap, over tokens, between the k-th and the (k+1)-th
    router probability: how far a token's choice is from a tie (inf where
    every expert is chosen). A check that compares two computations through
    the router holds only while their router inputs differ by much less."""
    e, k = r.probs.shape[1], r.ids.shape[1]
    if k >= e:
        return torch.full((), float("inf"), device=r.probs.device)
    top = torch.topk(r.probs, k + 1, dim=-1).values
    return (top[:, k - 1] - top[:, k]).min()


def capacity(t: int, k: int, e: int, capacity_factor: float = 1.25) -> int:
    """Slots an expert's queue has for ``t`` tokens: ``t * k *
    capacity_factor / e`` rounded up to a multiple of 256, at least 256
    (a decode step of B tokens gets 256)."""
    return max((int(t * k * capacity_factor / e) + 255) // 256 * 256, 256)


def assign(ids: torch.Tensor, e: int, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each choice's position in its expert's queue, and whether it is
    kept, both (T, k). With the choices flattened token-major, a choice's
    position is the number of earlier choices of the same expert, and it
    is kept while that is below ``cap``: the latest tokens are dropped."""
    flat = ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices  # expert-major, token-major within
    # each expert's count of choices, in a buffer of fixed shape (a bincount's
    # length depends on the ids, which a shape-only run cannot know)
    counts = torch.zeros(e, dtype=flat.dtype, device=flat.device).index_add_(
        0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(flat.numel(), device=flat.device) - starts[flat[order]]
    pos = pos.reshape(ids.shape)
    return pos, pos < cap


def dispatch(xf: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
             e: int, cap: int) -> torch.Tensor:
    """The ``(E, cap, D)`` buffer: each kept choice's token in slot
    ``expert * cap + position``, zeros in the empty slots. Every slot is
    written at most once: the dropped choices all go to one spare row past
    the last slot, which is cut off (every shape fixed by T, k, E and cap,
    none by the choices)."""
    t, d = xf.shape
    k = ids.shape[1]
    slots = torch.where(keep, ids * cap + pos, e * cap).reshape(-1)
    tokens = torch.arange(t, device=xf.device).repeat_interleave(k)
    xe = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    xe[slots] = xf[tokens]
    return xe[:-1].reshape(e, cap, d)


def _expert_specs(sh: Sharding):
    """(wi_spec, wo_spec) under the active MoE policy."""
    if sh.moe == "expert":
        return ("tp", "fsdp", None), ("tp", None, "fsdp")
    return (None, "fsdp", "tp"), (None, "tp", "fsdp")


def experts(p: MoE, xe: torch.Tensor, cfg: ArchConfig, *, sh: Sharding = NULL) -> torch.Tensor:
    """Every expert's FFN on its slots, one batched matmul a weight.
    ``silu_glu`` gates with ``wg``; every other ``act`` (``gelu`` too, as
    in the reference's ``apply_moe``) takes the squared ReLU. The
    activation in fp32, cast back to the slots' dtype."""
    ep = "tp" if sh.moe == "expert" else None
    cap_axis = "dp" if sh.moe_dispatch == "dp" else None
    xe = sh.constrain(xe, ep, cap_axis, None)
    wi_spec, wo_spec = _expert_specs(sh)
    h = torch.bmm(xe, sh.constrain(p.wi, *wi_spec))
    if cfg.act == "silu_glu":
        h = F.silu(torch.bmm(xe, sh.constrain(p.wg, *wi_spec)).float()).to(h.dtype) * h
    else:
        h = F.relu(h.float()).square().to(h.dtype)
    del xe  # the slots go before the outputs' all-reduce: a prefill's peak
    h = sh.constrain(h, ep, cap_axis, "tp" if sh.moe == "ffn" else None)
    return sh.constrain(torch.bmm(h, sh.constrain(p.wo, *wo_spec)), ep, cap_axis, None)


def combine(ye: torch.Tensor, r: Routing, pos: torch.Tensor, keep: torch.Tensor
            ) -> torch.Tensor:
    """Each token's kept choices' expert outputs, gate-weighted and summed
    over k in the outputs' dtype: (T, D). A dropped choice reads slot 0 at
    weight 0."""
    e, cap, d = ye.shape
    t, k = r.ids.shape
    slot = torch.where(keep, r.ids * cap + pos, 0)
    y_choice = ye.reshape(e * cap, d)[slot.reshape(-1)]  # (T*k, D)
    w = (r.gates * keep).to(ye.dtype).reshape(-1, 1)
    return (y_choice * w).reshape(t, k, d).sum(dim=1)


def apply_moe(p: MoE, x: torch.Tensor, cfg: ArchConfig, capacity_factor: float = 1.25,
              *, routing: Routing | None = None, sh: Sharding = NULL
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss). Choices over an expert's capacity are
    dropped (Switch/GShard semantics). ``routing`` (default :func:`route`
    on x) holds the router's decision fixed."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    # the tokens' gradient comes back laid out as xf is: the sharded
    # dispatch's may come back split over tp too, which cannot be
    # unflattened into (B, S) where the batch does not divide evenly
    xf = grad_as_input(x.reshape(t, d))
    r = route(p, xf, k) if routing is None else routing
    cap = capacity(t, k, e, capacity_factor)
    if sh.mesh is None:
        pos, keep = assign(r.ids, e, cap)
        y = combine(experts(p, dispatch(xf, r.ids, pos, keep, e, cap), cfg), r, pos, keep)
    else:
        y = _apply_sharded(p, xf, r, cfg, cap, sh)
    # the gradient comes back laid out as y is: one split over the sequence
    # (under ``sp_activations``) cannot be flattened into (T, D) in some
    # PyTorch releases
    y = grad_as_input(y.reshape(b, s, d))
    return sh.constrain(y.to(x.dtype), "dp", None, None), aux_loss(r, e)


def _apply_sharded(p: MoE, xf: torch.Tensor, r: Routing, cfg: ArchConfig, cap: int,
                   sh: Sharding) -> torch.Tensor:
    """:func:`assign`, :func:`dispatch`, :func:`experts` and :func:`combine`
    under a mesh, each rank on its own tokens (the module docstring):
    (T, D), each rank's rows pending a sum over the mesh dims that split
    the experts."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    e = cfg.n_experts
    tok, tok_dims = _tokens(r.ids, sh)
    exp_dims = sh.split_dims((e, cap), sh.spec("tp" if sh.moe == "expert" else None), 0)
    n_exp = e // math.prod(sh.mesh.size(m) for m in exp_dims)

    def own(ids: torch.Tensor, keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The choices' experts counted from this rank's first, and which
        choices are kept for one of its experts."""
        lo = sh.shard_index(exp_dims) * n_exp
        return ids - lo, keep & (ids >= lo) & (ids < lo + n_exp)

    def fill(xf, ids, pos, keep):
        ids, keep = own(ids, keep)
        return dispatch(xf, ids, pos, keep, n_exp, cap)

    def take(ye, gates, ids, pos, keep):
        ids, keep = own(ids, keep)
        return combine(ye, Routing(None, gates, ids), pos, keep)

    def layout(split: tuple[int, ...], summed: tuple[int, ...]) -> list:
        return [Shard(0) if m in split else Partial() if m in summed else Replicate()
                for m in range(sh.mesh.ndim)]

    pos, keep = assign_sharded(r.ids, e, cap, sh)
    # each rank's slots pending their sum go as soon as experts() has summed them
    ye = experts(p, local_map(sh, fill, (tok,) * 4, layout(exp_dims, tok_dims))(
        xf, r.ids, pos, keep), cfg, sh=sh)
    return local_map(sh, take, (sh.spec("tp" if exp_dims else None, None, None),) + (tok,) * 4,
                     layout(tok_dims, exp_dims))(ye, r.gates, r.ids, pos, keep)


def _tokens(ids: torch.Tensor, sh: Sharding) -> tuple[tuple, tuple[int, ...]]:
    """The spec of the choices ``ids`` (T, k) split as the tokens are, over
    dp, and the mesh dims that split them."""
    tok = sh.fit_spec(tuple(ids.shape), sh.spec("dp", None))
    return tok, sh.split_dims(tuple(ids.shape), tok, 0)


def assign_sharded(ids: torch.Tensor, e: int, cap: int, sh: Sharding
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`assign` under a mesh, each rank on its own tokens' choices:
    the global positions and kept flags, laid out as the tokens. A
    choice's position is its local one plus its expert's count of choices
    on the lower dp ranks (an all-gather of each rank's ``(E,)`` count)."""
    tok, tok_dims = _tokens(ids, sh)

    def positions(ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        pos, _ = assign(ids, e, cap)
        flat = ids.reshape(-1)
        counts = torch.zeros(e, dtype=flat.dtype, device=flat.device).index_add_(
            0, flat, torch.ones_like(flat))
        before = gather_local(sh, counts, tok_dims)[:sh.shard_index(tok_dims)].sum(dim=0)
        pos = pos + before[ids]
        return pos, pos < cap

    return local_map(sh, positions, (tok,), (0, 0))(ids)


def routing_stats(p: MoE, x: torch.Tensor, cfg: ArchConfig, capacity_factor: float = 1.25
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """What :func:`apply_moe` on ``x`` would drop and how close its choice
    is to a tie: (choices dropped, :func:`router_margin`), as 0-dim
    tensors on x's device (nothing waits for the card)."""
    t = x.shape[0] * x.shape[1]
    r = route(p, x.reshape(t, -1), cfg.top_k)
    _, keep = assign(r.ids, cfg.n_experts, capacity(t, cfg.top_k, cfg.n_experts,
                                                     capacity_factor))
    return (~keep).sum(), router_margin(r)
