"""Mamba2 SSD (state-space duality) mixer: the chunked parallel form for
train and prefill, the O(1)-state recurrent form for decode. The port of
``repro/models/ssm.py``, its ``REPRO_SSD_LEAN`` option included.

Math (per head, head_dim P, state N):
    h_t = exp(Δ_t A) · h_{t-1} + Δ_t · B_t x_tᵀ      h ∈ R^{N×P}
    y_t = C_tᵀ h_t + D · x_t
Chunked SSD (chunk Q): the intra-chunk quadratic term (C Bᵀ ⊙ causal-decay
mask) X is one :func:`repro_torch.kernels.ssd_intra.ssd_intra` call (the
Hopper kernel on the card); the chunk states, the scan over chunks and the
inter-chunk output are einsums, as the reference computes them outside any
kernel. Casts follow the reference's one by one. The kernel keeps the
intra-chunk weights in fp32 where the reference rounds them to the model's
dtype (``ssm.py:145``).

``REPRO_SSD_LEAN=1`` (read once, at import, as in the reference) takes the
reference's lean path: Δ folded into X once (``xc_dt``, in x's dtype), the
chunk states and the inter-chunk output from three operands with the decay
in x's dtype, written as products of two, and the intra-chunk term as the
kernel on ``xc_dt`` with ``dt`` set to ones. The reference rounds the
lean intra-chunk weights (``gmat``, ``decay``) to x's dtype; the kernel
keeps ``G E`` in fp32 there too (``docs/PORT.md``).

Sharding (``sh``): heads over 'tp' (80/16=5 for mamba2-2.7b, 128/16=8 for
jamba); B/C are group-shared (ngroups=1) and replicated across tp. The
depthwise conv treats each channel on its own, so under a mesh it runs on
each rank's own channels (:func:`_conv_gates`): x's tp share as ``wx``
leaves it, B and C whole, Δ and the log decay on each rank's heads. The
kernel launches through ``ctypes`` and takes no DTensor, so under a mesh
the chunk scan that calls it (:func:`_chunk_scan`: the kernel's term, the
chunk states, the scan over chunks and the inter-chunk term) runs through
``local_map`` on each rank's local shards, as ``shard_map`` would run it:
C and B split over dp, the log decay, Δ and X over dp and (heads) over tp, the
output as X. The scan is independent across batch rows and heads, so
this is exact, and each rank launches the kernel once a layer on its
shard. The gated norm after it runs on each rank's rows and tp share of
``d_inner`` as well (:func:`_gated_norm`): the one collective each way is
the sum of the (rows, 1) statistic over tp.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_intra import ssd_intra
from .config import ArchConfig
from .layers import Params, dense_init, row_parallel_out
from .sharding import NULL, Sharding, local_map, sum_local

#: The reference's ``_LEAN`` (``repro/models/ssm.py:34``): off by default.
_LEAN = os.environ.get("REPRO_SSD_LEAN") == "1"


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, conv_w-1, conv_channels) rolling window
    state: torch.Tensor  # (B, H, N, P) ssm state, fp32
    length: torch.Tensor


class SSM(Params):
    names = ("wz", "wx", "wB", "wC", "wdt", "conv_w", "A_log", "D", "dt_bias", "norm_scale", "wo")
    fp32 = ("A_log", "D", "dt_bias")


def init_ssm(gen: torch.Generator, cfg: ArchConfig, dtype, device="cuda") -> SSM:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h = cfg.ssm_heads
    conv_ch = di + 2 * n
    f32 = {"dtype": torch.float32, "device": device}
    return SSM({
        "wz": dense_init(gen, (d, di), dtype=dtype, device=device),
        "wx": dense_init(gen, (d, di), dtype=dtype, device=device),
        "wB": dense_init(gen, (d, n), dtype=dtype, device=device),
        "wC": dense_init(gen, (d, n), dtype=dtype, device=device),
        "wdt": dense_init(gen, (d, h), dtype=dtype, device=device),
        "conv_w": (torch.randn((cfg.ssm_conv, conv_ch), generator=gen, **f32) * 0.1).to(dtype),
        "A_log": torch.zeros((h,), **f32),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "norm_scale": torch.ones((di,), dtype=dtype, device=device),
        "wo": dense_init(gen, (di, d), dtype=dtype, device=device),
    })


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds. x: (B, S, C); w: (W, C)."""
    width = w.shape[0]
    out = x * w[-1]
    for i in range(1, width):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1], :]
        out = out + shifted * w[-1 - i]
    return out


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5, *, sh: Sharding = NULL) -> torch.Tensor:
    """The RMS norm of ``y * silu(z)`` over the channels (the last dim,
    ``d_inner``), scaled by ``scale``. Under a mesh it runs on each rank's
    own rows and tp share of the channels (y and z as ``wx`` and ``wz``
    leave them), with the channels of ``scale`` that match: each rank sums
    its channels' squares, and the one collective is the sum of that
    (rows, 1) fp32 statistic over tp (and of its gradient in the
    backward); ``scale``'s gradient is each rank's share, pending a sum."""
    spec = sh.spec("dp", *(None,) * (y.ndim - 2), "tp")
    tp_dims = sh.split_dims(tuple(y.shape), spec, y.ndim - 1)
    width = y.shape[-1]
    first = sh.shard_index(tp_dims) * (width // math.prod(sh.mesh.size(d) for d in tp_dims))
    norm = functools.partial(_gated_norm_local, width=width, first=first, eps=eps,
                             total=functools.partial(sum_local, sh, dims=tp_dims))
    return local_map(sh, norm, (spec, spec, (None,)), 0)(y, z, scale)


def _gated_norm_local(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, *, width: int,
                      first: int, eps: float, total) -> torch.Tensor:
    """:func:`_gated_norm` on channels ``[first, first + y's)`` of
    ``width``, ``total`` summing the squares' sums over the ranks that
    hold the others (the identity where one holds them all). Each rank
    sums its channels' fp32 squares in fp64 and rounds the sum to fp32
    once, so that a split of the channels moves the statistic by no more
    than the ranks' fp32 sum of those sums; the mean is that sum divided
    by the width, on every path."""
    dtype = y.dtype
    yf = y.float() * F.silu(z.float())
    ms = total(yf.square().double().sum(dim=-1, keepdim=True).float()) / width
    scale = scale[first: first + y.shape[-1]]
    return (yf * torch.rsqrt(ms + eps) * scale.float()).to(dtype)


def _conv_silu(w: torch.Tensor, *xs: torch.Tensor, first: int) -> tuple[torch.Tensor, ...]:
    """The depthwise causal conv of ``xs`` (each (B, S, C_i)) joined on
    their channels, by channels ``[first, first + sum C_i)`` of ``w`` (W,
    all channels), and its SiLU in fp32: each x's channels of it, in x's
    dtype. Each channel is its own: any split of the channels gives the
    same values."""
    x = torch.cat(xs, dim=-1)
    out = F.silu(_causal_conv(x, w[:, first: first + x.shape[-1]]).float()).to(x.dtype)
    return out.split([t.shape[-1] for t in xs], dim=-1)


def _gates(dt: torch.Tensor, dt_bias: torch.Tensor, a_log: torch.Tensor):
    """Δ and the log decay from the raw Δ projection (B, S, H)."""
    dt = F.softplus(dt + dt_bias)  # (B, S, H)
    a = -torch.exp(a_log)  # (H,) negative
    return dt, dt * a  # log a_t = Δ a, <= 0


def _conv_gates(p: SSM, xin: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                dt: torch.Tensor, cfg: ArchConfig, sh: Sharding):
    """The depthwise causal conv over (x, B, C) with its SiLU, and Δ and
    the log decay from the raw Δ projection: (x, B, C, Δ, log a). Under a
    mesh each rank works on its own channels: x on its batch rows and its
    tp share of the channels (as ``wx`` leaves it) with the matching
    channels of ``conv_w``, B and C (shared by every head) on its rows
    whole over tp, Δ and the log decay on its rows and heads."""
    b, s, h = dt.shape
    heads = sh.fit_spec((b, s, h), sh.spec("dp", None, "tp"))
    rows, rep = sh.spec("dp", None, None), (None, None)
    tp_dims = sh.split_dims((b, s, h), heads, 2)
    first = sh.shard_index(tp_dims) * (cfg.d_inner // math.prod(sh.mesh.size(d) for d in tp_dims))
    (xin,) = local_map(sh, functools.partial(_conv_silu, first=first), (rep, heads), (1,))(
        p.conv_w, xin)
    bmat, cmat = local_map(sh, functools.partial(_conv_silu, first=cfg.d_inner),
                           (rep, rows, rows), (1, 2))(p.conv_w, bmat, cmat)
    dt, log_decay = local_map(sh, _gates, (heads, heads[2:], heads[2:]), (0, 0))(
        dt, p.dt_bias, p.A_log)
    return xin, bmat, cmat, dt, log_decay


def _chunk_scan(cc: torch.Tensor, bc: torch.Tensor, ld: torch.Tensor, dtc: torch.Tensor,
                xc: torch.Tensor) -> torch.Tensor:
    """The chunked SSD on chunk views: C, B (B, nc, q, N) fp32, the log
    decay ``ld`` and Δ (B, nc, q, H) fp32, X (B, nc, q, H, P) -> the
    intra-chunk term (the kernel) plus the inter-chunk term, (B, nc, q, H,
    P) in X's dtype. Independent across batch rows and heads: under a mesh
    it runs on each rank's local shards (:func:`apply_ssm`)."""
    b, nc, q, h, pd = xc.shape
    n = cc.shape[-1]
    dtype = xc.dtype
    cum = torch.cumsum(ld, dim=2)  # within-chunk cumulative log decay

    # ---- intra-chunk (quadratic in q): Y[i] += Σ_{j<=i} C_i·B_j decay Δ_j x_j
    if _LEAN:
        # Δ folded into X once ((B,nc,q,H,P), the size of xc); the kernel
        # then weights by ones
        xc_dt = (xc.float() * dtc[..., None]).to(dtype)
        y_intra = ssd_intra(
            cc.reshape(b * nc, q, n), bc.reshape(b * nc, q, n), cum.reshape(b * nc, q, h),
            torch.ones_like(dtc).reshape(b * nc, q, h), xc_dt.reshape(b * nc, q, h, pd),
        ).reshape(b, nc, q, h, pd)
    else:
        y_intra = ssd_intra(
            cc.reshape(b * nc, q, n), bc.reshape(b * nc, q, n), cum.reshape(b * nc, q, h),
            dtc.reshape(b * nc, q, h), xc.reshape(b * nc, q, h, pd),
        ).reshape(b, nc, q, h, pd)

    # ---- chunk states: S_c = Σ_j decay_to_end_j Δ_j B_j x_jᵀ  (B,nc,H,N,P)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,q,H)
    if _LEAN:
        # "bcjn,bcjh,bcjhp->bchnp" with the decay in x's dtype, as two products
        xd = decay_to_end.to(dtype)[..., None] * xc_dt
        s_c = torch.einsum("bcjn,bcjhp->bchnp", bc.to(dtype), xd)
    else:
        sb = bc[:, :, :, None, :] * (dtc * decay_to_end)[..., None]
        s_c = torch.einsum("bcjhn,bcjhp->bchnp", sb.to(dtype), xc)

    # ---- inter-chunk recurrence (a loop over chunks), carried in fp32
    total = torch.exp(cum[:, :, -1, :])  # (B, nc, H) full-chunk decay
    hprev = torch.zeros((b, h, n, pd), dtype=torch.float32, device=xc.device)
    before = []
    for ci in range(nc):
        before.append(hprev)
        hprev = hprev * total[:, ci, :, None, None] + s_c[:, ci].float()
    h_before = torch.stack(before, dim=1)  # (B,nc,H,N,P) state entering chunk

    # ---- inter-chunk output: y += (C_i decay_from_start_i) · h_before
    decay_from_start = torch.exp(cum)  # (B,nc,q,H)
    if _LEAN:
        # "bcin,bcih,bchnp->bcihp" with the decay in x's dtype, as two products
        ch = torch.einsum("bcin,bchnp->bcihp", cc.to(dtype), h_before.to(dtype))
        y_inter = ch * decay_from_start.to(dtype)[..., None]
    else:
        cd = cc[:, :, :, None, :] * decay_from_start[..., None]
        y_inter = torch.einsum("bcihn,bchnp->bcihp", cd.to(dtype), h_before.to(dtype))
    return y_intra + y_inter


def apply_ssm(p: SSM, x: torch.Tensor, cfg: ArchConfig, *, sh: Sharding = NULL) -> torch.Tensor:
    """Chunked SSD forward. x: (B, S, D) -> (B, S, D). S % chunk == 0."""
    b, s, d = x.shape
    h, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"apply_ssm: sequence length {s} is not a multiple of the chunk {q}")
    nc = s // q

    # the gated norm hands z's gradient back laid out as z (each rank's rows
    # and channels), so that wz's weight gradient runs on each rank's
    # columns, as wx's does
    z = sh.constrain(x @ sh.constrain(p.wz, "fsdp", "tp"), "dp", None, "tp")
    xin = x @ sh.constrain(p.wx, "fsdp", "tp")
    bmat = x @ p.wB
    cmat = x @ p.wC
    dt = (x @ p.wdt).float()

    xin, bmat, cmat, dt, log_decay = _conv_gates(p, xin, bmat, cmat, dt, cfg, sh)
    xh = sh.constrain(xin.reshape(b, s, h, pd), "dp", None, "tp", None)

    # chunk views (heads sharded over tp)
    xc = sh.constrain(xh.reshape(b, nc, q, h, pd), "dp", None, None, "tp", None)
    bc = bmat.reshape(b, nc, q, n).float()
    cc = cmat.reshape(b, nc, q, n).float()
    dtc = sh.constrain(dt.reshape(b, nc, q, h), "dp", None, None, "tp")
    ld = sh.constrain(log_decay.reshape(b, nc, q, h), "dp", None, None, "tp")

    # the chunk scan, on each rank's batch rows and heads under a mesh: C
    # and B over dp, the rest over dp and (heads) tp, the output as X
    cb, hc = sh.spec("dp", None, None, None), sh.spec("dp", None, None, "tp")
    scan = local_map(sh, _chunk_scan, (cb, cb, hc, hc, sh.spec("dp", None, None, "tp", None)), 4)
    y = sh.constrain(scan(cc, bc, ld, dtc, xc), "dp", None, None, "tp", None)

    y = y.reshape(b, s, h, pd) + xh * p.D[None, None, :, None].to(x.dtype)
    y = y.reshape(b, s, cfg.d_inner)
    y = _gated_norm(y, z, p.norm_scale, sh=sh)
    wo = sh.constrain(sh.constrain(p.wo, "tp", "fsdp"), "tp", None)
    return row_parallel_out(sh.constrain(y, "dp", None, "tp"), wo, sh)


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype, device="cuda") -> SSMCache:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype, device=device),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                          dtype=torch.float32, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def apply_ssm_decode(p: SSM, x: torch.Tensor, cache: SSMCache, cfg: ArchConfig, *,
                     sh: Sharding = NULL) -> tuple[torch.Tensor, SSMCache]:
    """Single-token recurrent step. x: (B, 1, D)."""
    b = x.shape[0]
    h, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x0 = x[:, 0]
    z = x0 @ p.wz
    xin = x0 @ p.wx
    bvec = x0 @ p.wB
    cvec = x0 @ p.wC
    # the step sizes of each rank's own heads, laid out as the cache's state:
    # the state's update then runs on those heads alone
    dt = (x0 @ sh.constrain(p.wdt, "fsdp", "tp")).float()

    conv_in = torch.cat([xin, bvec, cvec], dim=-1)  # (B, C)
    window = torch.cat([cache.conv, conv_in[:, None, :]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window.float(), p.conv_w.float())
    conv_out = F.silu(conv_out).to(x.dtype)
    xin = conv_out[:, : cfg.d_inner]
    bvec = conv_out[:, cfg.d_inner: cfg.d_inner + n].float()
    cvec = conv_out[:, cfg.d_inner + n:].float()

    xh = xin.reshape(b, h, pd).float()
    dt = F.softplus(dt + p.dt_bias)  # (B, H)
    decay = torch.exp(dt * -torch.exp(p.A_log))  # (B, H)
    state = cache.state * decay[..., None, None] + (
        bvec[:, None, :, None] * (dt[..., None] * xh)[:, :, None, :]
    )  # (B,H,N,P)
    y = torch.einsum("bn,bhnp->bhp", cvec, state)
    y = y + xh * p.D[None, :, None]
    y = y.reshape(b, cfg.d_inner).to(x.dtype)
    y = _gated_norm(y, z, p.norm_scale, sh=sh)
    out = sh.constrain((y @ p.wo)[:, None, :], "dp", None, None)
    return out, SSMCache(window[:, 1:, :], state, cache.length + 1)
