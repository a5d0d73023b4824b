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
Under a mesh the router runs on the sharded tokens; :func:`assign`,
:func:`dispatch` and :func:`combine` (a sort, an ``index_add_``, scatters
and gathers, which DTensor has no rule for) run on
each rank's replicated copy through ``local_map``, as XLA replicates what
it cannot partition; the expert FFN runs on the sharded ``(E, cap, D)``
buffers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import Params, dense_init
from .sharding import NULL, Sharding, local_map


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
    xf = x.reshape(t, d)
    r = route(p, xf, k) if routing is None else routing
    cap = capacity(t, k, e, capacity_factor)
    rep2, rep3 = (None, None), (None, None, None)
    pos, keep = local_map(sh, lambda ids: assign(ids, e, cap), (rep2,), (None, None))(r.ids)
    xe = local_map(sh, lambda xf, ids, pos, keep: dispatch(xf, ids, pos, keep, e, cap),
                   (rep2,) * 4, None)(xf, r.ids, pos, keep)
    ye = experts(p, xe, cfg, sh=sh)
    y = local_map(sh, lambda ye, gates, ids, pos, keep: combine(ye, Routing(None, gates, ids),
                                                                 pos, keep),
                  (rep3,) + (rep2,) * 4, None)(ye, r.gates, r.ids, pos, keep)
    return sh.constrain(y.reshape(b, s, d).to(x.dtype), "dp", None, None), aux_loss(r, e)


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
