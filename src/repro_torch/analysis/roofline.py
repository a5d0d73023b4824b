"""The three-term roofline model and the kernels' bound rule, for an
NVIDIA H100. Counterpart of ``repro.analysis.roofline``, whose table is a
TPU v5e's.

    T_compute    = FLOPs / peak FLOP/s of the operands' type
    T_memory     = bytes / HBM bandwidth
    T_collective = collective bytes / link bandwidth

The reference reads its FLOPs and bytes from compiled HLO
(``analysis.hlo_cost``); the port has no HLO, so callers hand them in:
counted from the shapes (:func:`bound`), from the profiler's groups, or,
for collectives, from the byte counter of
:mod:`repro_torch.distributed.collectives`.

:func:`bound` is the least time a kernel can take for its work: each input
read once and each output written once at the HBM rate, or its operations
at the peak rate of the type they run in, whichever is larger.
:func:`mma_bound` counts the MTTKRP kernel's products as the tensor cores
run them, :func:`ssd_bound` the intra-chunk SSD term's. ``chip_smoke.py``
and the probes in ``scripts/`` take every ``bound_ms`` from here.
:func:`roofline_from_record` reads a record of the dry run
(:mod:`repro_torch.launch.dryrun`), whose FLOPs and bytes are one
device's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping


@dataclass(frozen=True)
class HW:
    """A device's peaks: FLOP/s by operand type, HBM bytes/s, and the
    bytes/s of one inter-device link."""

    name: str
    peak_flops: Mapping[str, float] = field(hash=False)
    hbm_bw: float
    link_bw: float


#: NVIDIA's data sheet for the H100 SXM (``NVIDIA H100 80GB HBM3, 700.00
#: W``), dense rates: float32 outside the tensor cores, tf32 and bf16 on
#: them; HBM3 at 3.35 TB/s; NVLink 4 at 900 GB/s over 18 links, 50 GB/s a
#: link (both directions). Published figures, not readings of this port; a
#: card set below 700 W runs slower under load.
H100 = HW(
    "NVIDIA H100 80GB HBM3, 700.00 W (data sheet)",
    {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12},
    3.35e12,
    50e9,
)

#: The MTTKRP kernel's products on the tensor cores, by input dtype:
#: (products it does for each, the type whose peak rate they run at): fp32
#: as 3xTF32, bf16 as one bf16 product.
MMA_OPS = {"float32": (3, "tf32"), "bfloat16": (1, "bfloat16")}
#: The SSD kernel's W X products, by X's itemsize: two bf16 products for
#: bf16 X (W split into bf16 hi and lo), 3xTF32 for fp32 X.
SSD_WX_OPS = {2: (2, "bfloat16"), 4: (3, "tf32")}


@dataclass
class RooflineTerms:
    t_compute: float
    t_memory: float
    t_collective: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_total: float
    useful_ratio: float      # MODEL_FLOPS / (FLOPs × chips)
    bottleneck: str
    hw: str = H100.name

    @property
    def step_time(self) -> float:
        """No-overlap upper bound (the three terms fully serialized)."""
        return self.t_compute + self.t_memory + self.t_collective

    @property
    def step_time_overlapped(self) -> float:
        """Perfect-overlap lower bound (max of the three engines)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the overlapped bound."""
        if self.step_time_overlapped == 0:
            return 0.0
        return self.useful_ratio * (self.t_compute / self.step_time_overlapped)


def roofline(
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
    model_flops_total: float,
    chips: int,
    hw: HW = H100,
    dtype: str = "bfloat16",
) -> RooflineTerms:
    """The reference's three terms, the compute term at ``hw``'s peak for
    ``dtype`` (the reference's single peak is bf16's)."""
    t_c = flops_per_device / hw.peak_flops[dtype]
    t_m = bytes_per_device / hw.hbm_bw
    t_x = collective_bytes_per_device / hw.link_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops_total / (flops_per_device * chips) if flops_per_device else 0.0
    return RooflineTerms(
        t_compute=t_c,
        t_memory=t_m,
        t_collective=t_x,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        collective_bytes_per_device=collective_bytes_per_device,
        model_flops_total=model_flops_total,
        useful_ratio=useful,
        bottleneck=bottleneck,
        hw=hw.name,
    )


def bound(n_x: int, itemsize: int, factor_words: int, out_words: int, flops: float,
          dtype: str, hw: HW = H100) -> tuple[float, str]:
    """Least time in ms: each input read once and the fp32 output written
    once at the HBM rate, or the operations at the type's peak rate; and
    which of the two bounds it (``"bytes"`` or ``"operations"``)."""
    t_bytes = (n_x * itemsize + factor_words * itemsize + out_words * 4) / hw.hbm_bw
    t_ops = flops / hw.peak_flops[dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def mma_bound(n_x: int, itemsize: int, factor_words: int, out_words: int, flops: float,
              dtype: str, hw: HW = H100) -> tuple[float, str]:
    """:func:`bound` for the MTTKRP kernel: ``flops`` counted as the tensor
    cores run them for ``dtype`` inputs (``MMA_OPS``)."""
    times, rate = MMA_OPS[dtype]
    return bound(n_x, itemsize, factor_words, out_words, times * flops, rate, hw)


def ssd_bound(bcn: int, q: int, n: int, h: int, p: int, x_itemsize: int,
              hw: HW = H100) -> tuple[float, str]:
    """Least time in ms of the intra-chunk SSD term: C, B, cum and dt (fp32)
    read once, X read and Y written once in X's dtype, at the HBM rate; or
    the causal half's operations as the kernel runs them on the tensor
    cores: the Gram's ``2 BC q(q+1)/2 N`` as three tf32 products, and W X's
    ``2 BC q(q+1)/2 H P`` as ``SSD_WX_OPS`` gives for X's dtype."""
    t_bytes = (bcn * q * (2 * n + 2 * h) * 4 + 2 * bcn * q * h * p * x_itemsize) / hw.hbm_bw
    causal = bcn * q * (q + 1) / 2
    times, rate = SSD_WX_OPS[x_itemsize]
    t_ops = (3 * 2.0 * causal * n / hw.peak_flops["tf32"]
             + times * 2.0 * causal * h * p / hw.peak_flops[rate])
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def roofline_from_record(record: dict, hw: HW = H100, dtype: str = "bfloat16") -> RooflineTerms:
    """Terms from a dry-run record (:mod:`repro_torch.launch.dryrun`), the
    reference's mapping: ``cost.flops``, ``cost.bytes_accessed`` and
    ``collectives.operand_bytes`` a device, ``model_flops`` over
    ``devices``."""
    return roofline(
        flops_per_device=record["cost"]["flops"],
        bytes_per_device=record["cost"]["bytes_accessed"],
        collective_bytes_per_device=record["collectives"]["operand_bytes"],
        model_flops_total=record.get("model_flops", 0.0),
        chips=record.get("devices", 256),
        hw=hw,
        dtype=dtype,
    )
