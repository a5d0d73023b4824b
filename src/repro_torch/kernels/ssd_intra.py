"""The Mamba2 intra-chunk SSD term on Hopper: the wrapper, its plain version,
its launch count and the reference's traffic model.

Source: ``csrc/ssd_intra.cu`` (``ssd_intra_kernel<T>``). It replaces the TPU
kernel ``repro/kernels/ssd_intra.py:ssd_intra_pallas``
(``_ssd_intra_kernel``): for C, B ``(BC, q, N)``, the within-chunk
cumulative log-decay ``cum`` and ``dt`` ``(BC, q, H)``, and X
``(BC, q, H, P)``,

    Y[c, i, h, :] = sum_{j <= i} (C[c, i] . B[c, j]) exp(cum[c, i, h] - cum[c, j, h])
                                 dt[c, j, h] X[c, j, h, :],

``(BC, q, H, P)`` in X's dtype, accumulated in fp32: the term ``y_intra`` of
``repro/models/ssm.py:125-147``, one launch per SSM layer of a prefill or
of a train step's forward (two under remat, whose recompute launches it
again). Its gradient (:class:`SsdIntra`) is PyTorch's, not a kernel's.

What bounds it on an H100: its bytes (0.36 GB at Mamba2-2.7b's q=256,
N=128, H=80, P=64 with BC=64: 0.108 ms for x bf16, 0.208 ms for fp32).
Both products run on the tensor cores: the Gram ``C B^T`` as 3xTF32, and
``W X`` as two bf16 products (W split into bf16 hi and lo parts) for bf16
x, 3xTF32 for fp32 x, so the causal half of the operations,
``2 BC q(q+1)/2 (N + H P)``, takes 0.045 / 0.13 ms at the tensor cores'
rates. The kernel skips the j-tiles above the diagonal (the TPU kernel
does the whole q x q product and masks half of it), forms each Gram tile
once per CTA for all the heads of its block, builds the weights in the
warps' own MMA fragments and takes the exp only where ``j <= i``. Its plan
(tile and heads per CTA, :func:`kernel_plan`) is its own; ``head_block``
is kept for the reference's signature and validated where given.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..engine.plan import H100_SMS, SMEM_BUDGET, SMEM_PER_CTA_MAX, ssd_intra_kernel_grid
from ..observe import collect
from .build import check, count_launch, launch_library, library
from .splitk import copy_width

#: The Gram's N chunk, as ``GK`` in ``csrc/ssd_intra.cu``, and the bytes a
#: C or B row of a chunk takes in shared memory (``GROW``: 16 of skew).
GK = 32
GROW = GK * 4 + 16
#: Warps of a CTA, as ``NWARPS`` in ``csrc/common.cuh``; each multiplies
#: 16 rows by 64 columns of P of one head (``WNT`` n-tiles of 8).
NWARPS = 8
#: The largest head dimension the kernel takes.
MAX_P = 256
#: Most heads a CTA takes: every head of the block reuses the CTA's Gram.
#: At Mamba2-2.7b's shape (H = 80, BC = 64) 40 heads (512 CTAs of 64 rows)
#: ran fastest of 4-80 on an H100 (PERF.md, section 6).
MAX_HEADS = 40


class SsdPlan(NamedTuple):
    """The kernel's launch plan: ``tile`` rows of i (and columns of j) per
    tile, ``heads`` per CTA."""

    tile: int
    heads: int


def _acc(*ts: torch.Tensor) -> torch.dtype:
    """The dtype the plain version and the backward compute in: fp32, or
    float64 where an operand is float64 (so that ``gradcheck`` can hold the
    backward to the forward)."""
    return functools.reduce(torch.promote_types, (t.dtype for t in ts), torch.float32)


def _above(q: int, device) -> torch.Tensor:
    """``[j > i]`` as a (1, q, q, 1) mask."""
    return torch.ones((q, q), dtype=torch.bool, device=device).triu(1)[None, :, :, None]


def _decay(cumf: torch.Tensor) -> torch.Tensor:
    """``E[b,i,j,h] = exp(cum_i - cum_j)`` where ``j <= i``, else 0, the
    exponent masked before the exp (no inf above the diagonal)."""
    seg = cumf[:, :, None, :] - cumf[:, None, :, :]
    return torch.exp(seg.masked_fill(_above(cumf.shape[1], cumf.device), -torch.inf))


def ssd_intra_plain(cc: torch.Tensor, bc: torch.Tensor, cum: torch.Tensor, dt: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Plain version, ``ssd_intra_ref``'s formula: the fp32 Gram, the decay
    selected on ``j <= i``, the ``dt`` weighting, one einsum; x's dtype
    (float64 operands are computed in float64). The decay is selected
    before its exp, where the reference selects after it: the same values,
    but autograd through this version stays finite where a chunk's decay
    passes e^88 above the diagonal (``exp`` overflows there, and the
    reference's gradient of ``cc``, ``bc`` and ``cum`` is NaN)."""
    acc = _acc(cc, bc, cum, dt, x)
    g = torch.einsum("bin,bjn->bij", cc.to(acc), bc.to(acc))
    w = g[..., None] * _decay(cum.to(acc))
    w = w * dt.to(acc)[:, None, :, :]
    return torch.einsum("bijh,bjhp->bihp", w, x.to(acc)).to(x.dtype)


def traffic_model(bcn: int, q: int, n: int, h: int, p: int, itemsize: int = 2) -> dict:
    """HBM bytes: kernel (operands+output once) vs einsum path (which also
    round-trips g (q,q), decay (q,q,H) and w (q,q,H) through HBM); a copy
    of the reference's ``traffic_model``."""
    operands = bcn * (2 * q * n + 2 * q * h + q * h * p) * itemsize
    out = bcn * q * h * p * itemsize
    kernel = operands + out
    einsum_extra = bcn * (q * q + 3 * q * q * h) * 4  # f32 chain
    return {
        "kernel_bytes": kernel,
        "einsum_bytes": kernel + einsum_extra,
        "ratio": (kernel + einsum_extra) / kernel,
    }


def heads_at_once(p: int, tile: int) -> int:
    """Heads a CTA's 8 warps take at once: each head needs ``tile / 16``
    row blocks times ``ceil(P / 64)`` column blocks of warps."""
    return NWARPS // ((tile // 16) * -(-p // 64))


def valid_tile(p: int, tile: int) -> bool:
    """Whether the kernel takes this tile at head dimension P."""
    return tile in (16, 32, 64) and 1 <= p <= MAX_P and heads_at_once(p, tile) >= 1


def kernel_smem_bytes(q: int, p: int, tile: int, itemsize: int) -> int:
    """Dynamic shared memory of one CTA, as ``make_ssd_layout`` counts it
    (x of ``itemsize`` bytes): the Gram tiles ``G`` in fp32 (tile rows of q
    rounded up to the tile, skewed to 8 mod 16 floats for fp32 x and to 16
    mod 32 for bf16 x), two stages of cum_j, dt_j and cum_i for the heads
    taken at once, and the ring: two stages of their X tiles (rows of
    64-column blocks plus 32 or 16 bytes of skew), or the Gram's two stages
    of C and B chunks, the larger."""
    hc = heads_at_once(p, tile)
    q_pad = -(-q // tile) * tile
    ldg = q_pad + 8 if itemsize == 4 else (q_pad + 16 if q_pad % 32 == 0 else q_pad)
    xrow = -(-p // 64) * 64 * itemsize + (32 if itemsize == 4 else 16)
    ring = tile * ldg * 4 + 2 * hc * 3 * tile * 4
    return ring + max(2 * hc * tile * xrow, 4 * tile * GROW)


def kernel_plan(q: int, h: int, p: int, itemsize: int, *, bcn: int,
                sms: int = H100_SMS) -> SsdPlan:
    """The largest tile of 64, 32, 16 that the kernel takes at this P and
    whose shared memory lets two CTAs share an SM (``SMEM_BUDGET``), else
    the largest that fits one CTA. Heads per CTA: divisors of H up to
    :data:`MAX_HEADS`, multiples of :func:`heads_at_once` where one divides
    H; the most of them that still give ``bcn`` chunks a CTA on each of
    ``sms`` SMs, else the fewest (the most CTAs)."""
    tiles = [t for t in (64, 32, 16) if valid_tile(p, t)]
    tile = next((t for budget in (SMEM_BUDGET, SMEM_PER_CTA_MAX) for t in tiles
                 if kernel_smem_bytes(q, p, t, itemsize) <= budget), None)
    if tile is None:
        raise ValueError(f"ssd_intra: no tile fits q={q}, P={p} in one CTA "
                         f"(P <= {MAX_P}, and the Gram rows of a 16-row tile must fit)")
    divisors = [d for d in range(1, min(h, MAX_HEADS) + 1) if h % d == 0]
    hc = heads_at_once(p, tile)
    heads = [d for d in divisors if d % hc == 0] or divisors
    full = [d for d in heads if ssd_intra_kernel_grid(bcn, q, h, tile, d)[0] >= sms]
    return SsdPlan(tile, max(full) if full else min(heads))


def smem_bytes(q: int, p: int, tile: int, itemsize: int) -> int:
    """The library's own count of :func:`kernel_smem_bytes` (-1 for a tile
    or P the kernel does not take)."""
    return int(library("ssd_intra.cu").repro_ssd_intra_smem_bytes(q, p, tile, itemsize))


def _shapes(cc, bc, cum, dt, x, head_block):
    if x.ndim != 4:
        raise ValueError(f"ssd_intra: x must be (BC, q, H, P), got {tuple(x.shape)}")
    bcn, q, h, p = x.shape
    if cc.ndim != 3 or cc.shape[:2] != (bcn, q) or bc.shape != cc.shape:
        raise ValueError(f"ssd_intra: cc and bc must be ({bcn}, {q}, N), got "
                         f"{tuple(cc.shape)}, {tuple(bc.shape)}")
    if cum.shape != (bcn, q, h) or dt.shape != (bcn, q, h):
        raise ValueError(f"ssd_intra: cum and dt must be ({bcn}, {q}, {h}), got "
                         f"{tuple(cum.shape)}, {tuple(dt.shape)}")
    if head_block is not None:
        hb = min(head_block, h)
        if hb < 1 or h % hb:
            raise ValueError(f"ssd_intra: head_block {head_block} does not divide H={h}")
    return bcn, q, cc.shape[2], h, p


def _launch(cc: torch.Tensor, bc: torch.Tensor, cum: torch.Tensor, dt: torch.Tensor,
            x: torch.Tensor, head_block: int, plan: SsdPlan | None) -> torch.Tensor:
    """The forward: the kernel on a CUDA tensor, :func:`ssd_intra_plain`
    on a CPU tensor (see :func:`ssd_intra`)."""
    bcn, q, n, h, p = _shapes(cc, bc, cum, dt, x, head_block)
    if x.device.type == "cpu":
        return ssd_intra_plain(cc, bc, cum, dt, x)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra: the kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_intra: x must be float32 or bfloat16, got {x.dtype}")
    small = [t.to(torch.float32).contiguous() for t in (cc, bc, cum, dt)]
    if any(t.device != x.device for t in small):
        raise ValueError("ssd_intra: all operands must be on one device")
    x = x.contiguous()
    itemsize = x.element_size()
    if plan is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        plan = kernel_plan(q, h, p, itemsize, bcn=bcn, sms=sms)
    if not valid_tile(p, plan.tile) or plan.heads < 1 or h % plan.heads:
        raise ValueError(f"ssd_intra: plan {plan} does not fit H={h}, P={p}")
    ctas = ssd_intra_kernel_grid(bcn, q, h, plan.tile, plan.heads)[0]
    if ctas >= 2 ** 31:
        raise ValueError(f"ssd_intra: {ctas} CTAs; a 1-D grid takes fewer than 2^31")
    smem = smem_bytes(q, p, plan.tile, itemsize)
    if smem > SMEM_PER_CTA_MAX:
        raise ValueError(f"ssd_intra: plan {plan} needs {smem} bytes of shared memory at q={q}; "
                         f"a CTA has at most {SMEM_PER_CTA_MAX}")
    out = torch.empty_like(x)
    copy_cb = copy_width(n * 4, [small[0].data_ptr(), small[1].data_ptr()])
    copy_x = copy_width(p * itemsize, [x.data_ptr()])
    lib = launch_library("ssd_intra.cu", out)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_intra(0 if x.dtype == torch.float32 else 1, bcn, q, n, h, p,
                                  plan.heads, plan.tile, copy_cb, copy_x,
                                  *(t.data_ptr() for t in small), x.data_ptr(), out.data_ptr(),
                                  stream)
    check(err, "ssd_intra")
    count_launch(ssd_intra)
    if collect.SINKS:
        collect.report("ssd_intra", plan, collect.nbytes(*small, x), collect.nbytes(out),
                       collect.dtype_name(out))
    return out


def ssd_intra_grads(cc: torch.Tensor, bc: torch.Tensor, cum: torch.Tensor, dt: torch.Tensor,
                    x: torch.Tensor, dy: torch.Tensor, needs: tuple[bool, ...] = (True,) * 5
                    ) -> tuple[torch.Tensor | None, ...]:
    """The closed-form adjoint of the term: (dcc, dbc, dcum, ddt, dx) for
    the output's gradient ``dy``, each in its input's dtype (None where
    ``needs`` says the input takes none). In fp32 (float64 where an
    operand is float64), with
    ``W[b,i,j,h] = [j <= i] G[b,i,j] E[b,i,j,h] dt[b,j,h]``, ``G = C B^T``,
    ``E = exp(cum_i - cum_j)``:

        dx[b,j,h,p] = sum_i W dy[b,i,h,p]
        dW[b,i,j,h] = [j <= i] sum_p dy[b,i,h,p] x[b,j,h,p]
        dG = sum_h dW E dt_j;  dC = dG B;  dB = dG^T C
        ddt_j = sum_i dW G E
        dcum = rowsum_j(dW W) - colsum_i(dW W)

    Every contraction is a product of two operands. It makes a few fp32
    ``(BC, q, q, H)`` tensors: 336 MB each at BC = 16, q = 256, H = 80."""
    acc = _acc(cc, bc, cum, dt, x, dy)
    ccf, bcf, cumf, dtf, xf, dyf = (t.to(acc) for t in (cc, bc, cum, dt, x, dy))
    g = torch.einsum("bin,bjn->bij", ccf, bcf)
    e = _decay(cumf)
    ge = g[..., None] * e
    w = ge * dtf[:, None, :, :]
    dw = torch.einsum("bihp,bjhp->bijh", dyf, xf).masked_fill_(_above(cc.shape[1], cc.device), 0.0)
    dx = torch.einsum("bijh,bihp->bjhp", w, dyf).to(x.dtype) if needs[4] else None
    dcum = ddt = dcc = dbc = None
    if needs[2]:
        dww = dw * w
        dcum = (dww.sum(2) - dww.sum(1)).to(cum.dtype)
        del dww
    del w
    if needs[3]:
        ddt = (dw * ge).sum(1).to(dt.dtype)
    del ge
    if needs[0] or needs[1]:
        dg = torch.einsum("bijh,bjh->bij", dw * e, dtf)
        dcc = (dg @ bcf).to(cc.dtype) if needs[0] else None
        dbc = (dg.transpose(1, 2) @ ccf).to(bc.dtype) if needs[1] else None
    return dcc, dbc, dcum, ddt, dx


class SsdIntra(torch.autograd.Function):
    """The term with its gradient: the forward is :func:`_launch` (the
    kernel on the card, one launch), the backward :func:`ssd_intra_grads`
    in PyTorch operations (no kernel): the reference has no backward
    kernel either, its training path being an einsum chain that XLA
    differentiates (``repro/models/ssm.py:125-147``)."""

    @staticmethod
    def forward(ctx, cc, bc, cum, dt, x, head_block, plan):
        ctx.save_for_backward(cc, bc, cum, dt, x)
        return _launch(cc, bc, cum, dt, x, head_block, plan)

    @staticmethod
    def backward(ctx, dy):
        return (*ssd_intra_grads(*ctx.saved_tensors, dy, ctx.needs_input_grad[:5]), None, None)


def ssd_intra(cc: torch.Tensor, bc: torch.Tensor, cum: torch.Tensor, dt: torch.Tensor,
              x: torch.Tensor, *, head_block: int | None = None, plan: SsdPlan | None = None
              ) -> torch.Tensor:
    """The intra-chunk SSD term, ``(BC, q, H, P)`` in x's dtype, with its
    gradient (:class:`SsdIntra`). A CUDA tensor launches the kernel under
    ``plan`` (default :func:`kernel_plan`, which picks the heads a CTA
    takes itself); cc, bc, cum and dt are taken in fp32 (cast if they are
    not), x in fp32 or bf16. A CPU tensor takes :func:`ssd_intra_plain`.
    Both run the same backward. A ``head_block`` given is validated as the
    reference's (it must divide H, or exceed it); none is needed, so any H
    runs (a rank's share of the heads, say 20 of ``mamba2-2.7b``'s 80)."""
    return SsdIntra.apply(cc, bc, cum, dt, x, head_block, plan)


ssd_intra.launches = 0  # type: ignore[attr-defined]

