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
``repro/models/ssm.py:125-147``, one launch per layer of a prefill.

What bounds it on an H100: the causal half of the operations,
``2 BC q(q+1)/2 (N + H P)`` (2.2e10 at Mamba2-2.7b's q=256, N=128, H=80,
P=64 with BC=64: 0.33 ms on fp32 FMAs); its bytes (0.36 GB, 0.11 ms) bound
it only on tensor cores. The kernel skips the j-tiles above the diagonal
(the TPU kernel does the whole q x q product and masks half of it), forms
each Gram tile once per CTA for all the heads of its block, and takes the
exp only where ``j <= i``. Its plan (tile and heads per CTA,
:func:`kernel_plan`) is its own; ``head_block`` is kept for the
reference's signature and validation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..engine.plan import SMEM_PER_CTA_MAX
from .build import check, library

#: The Gram's N chunk, as ``NK`` in ``csrc/ssd_intra.cu``.
NK = 32
#: Threads of a CTA, as ``NTHREADS`` in ``csrc/common.cuh``.
NTHREADS = 256
#: Most heads a CTA takes: every head of the block reuses the CTA's Gram.
#: At Mamba2-2.7b's shape (H = 80) 20 heads (1024 CTAs) ran fastest of
#: 4-80 on an H100 (PERF.md, section 6).
MAX_HEADS = 20


class SsdPlan(NamedTuple):
    """The kernel's launch plan: ``tile`` rows of i (and columns of j) per
    tile, ``heads`` per CTA."""

    tile: int
    heads: int


def ssd_intra_plain(cc: torch.Tensor, bc: torch.Tensor, cum: torch.Tensor, dt: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Plain version, ``ssd_intra_ref``'s formula: the fp32 Gram, the decay
    selected on ``j <= i``, the ``dt`` weighting, one einsum; x's dtype."""
    g = torch.einsum("bin,bjn->bij", cc.float(), bc.float())
    cumf = cum.float()
    seg = cumf[:, :, None, :] - cumf[:, None, :, :]
    q = cc.shape[1]
    causal = torch.ones((q, q), dtype=torch.bool, device=cc.device).tril()
    w = torch.where(causal[None, :, :, None], g[..., None] * torch.exp(seg), 0.0)
    w = w * dt.float()[:, None, :, :]
    return torch.einsum("bijh,bjhp->bihp", w, x.float()).to(x.dtype)


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


def kernel_smem_bytes(q: int, p: int, tile: int) -> int:
    """Dynamic shared memory of one CTA, as ``make_ssd_layout`` counts it:
    the Gram tiles ``G^T`` (q rounded up to the tile, x (tile + 4)), two
    buffers of a j-tile's cum and dt, and one stage, the larger of the
    Gram's C and B chunks and a head step's W and X tiles, in fp32."""
    ldt, p4 = tile + 4, -(-p // 4) * 4
    q_pad = -(-q // tile) * tile
    stage = max(2 * NK * ldt, tile * ldt + tile * p4)
    return (q_pad * ldt + 4 * tile + stage) * 4


def kernel_plan(q: int, h: int, p: int) -> SsdPlan:
    """The largest tile of 64, 32, 16 whose output units (4 rows x 4
    columns of P) fit the CTA's threads and whose shared memory fits a CTA;
    the most heads per CTA, up to :data:`MAX_HEADS`, that divide H."""
    p4 = -(-p // 4) * 4
    for tile in (64, 32, 16):
        fits = kernel_smem_bytes(q, p, tile) <= SMEM_PER_CTA_MAX
        if (tile // 4) * (p4 // 4) <= NTHREADS and fits:
            break
    else:
        raise ValueError(f"ssd_intra: no tile fits q={q}, P={p} in one CTA "
                         f"(P <= 256 and about q <= 2700 are needed)")
    heads = max(d for d in range(1, min(h, MAX_HEADS) + 1) if h % d == 0)
    return SsdPlan(tile, heads)


def smem_bytes(q: int, p: int, tile: int) -> int:
    """The library's own count of :func:`kernel_smem_bytes`."""
    return int(library("ssd_intra.cu").repro_ssd_intra_smem_bytes(q, p, tile))


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
    hb = min(head_block, h)
    if hb < 1 or h % hb:
        raise ValueError(f"ssd_intra: head_block {head_block} does not divide H={h}")
    return bcn, q, cc.shape[2], h, p


def ssd_intra(cc: torch.Tensor, bc: torch.Tensor, cum: torch.Tensor, dt: torch.Tensor,
              x: torch.Tensor, *, head_block: int = 8, plan: SsdPlan | None = None
              ) -> torch.Tensor:
    """The intra-chunk SSD term, ``(BC, q, H, P)`` in x's dtype. A CUDA
    tensor launches the kernel under ``plan`` (default :func:`kernel_plan`);
    cc, bc, cum and dt are taken in fp32 (cast if they are not), x in fp32
    or bf16. A CPU tensor takes :func:`ssd_intra_plain`."""
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
    plan = plan or kernel_plan(q, h, p)
    units = (plan.tile // 4) * (-(-p // 4))
    if plan.tile not in (16, 32, 64) or plan.heads < 1 or h % plan.heads or units > NTHREADS:
        raise ValueError(f"ssd_intra: plan {plan} does not fit H={h}, P={p}")
    smem = smem_bytes(q, p, plan.tile)
    if smem > SMEM_PER_CTA_MAX:
        raise ValueError(f"ssd_intra: plan {plan} needs {smem} bytes of shared memory at q={q}; "
                         f"a CTA has at most {SMEM_PER_CTA_MAX}")
    out = torch.empty_like(x)
    lib = library("ssd_intra.cu")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_intra(0 if x.dtype == torch.float32 else 1, bcn, q, n, h, p,
                                  plan.heads, plan.tile, *(t.data_ptr() for t in small),
                                  x.data_ptr(), out.data_ptr(), stream)
    check(err, "ssd_intra")
    ssd_intra.launches += 1
    return out


ssd_intra.launches = 0  # type: ignore[attr-defined]

