"""Calibrate the analytic traffic model against this machine.
Counterpart of ``repro.tune.calibrate``.

``BlockPlan.eq10_words`` predicts the blocked schedule's memory traffic in
the paper's machine-free units. On a real machine the traffic of the
program that runs differs, and so do the constants that turn traffic into
time (bandwidth, a call's overhead). This module measures both for the
``blocked_host`` schedule (Algorithm 2 as one einsum over the blocked
tensor, :func:`repro_torch.core.blocked.mttkrp_blocked`):

  * **measured traffic**: the bytes that schedule's operations read and
    write (:func:`blocked_mttkrp_bytes`: the zero-padding copies of X and
    the factors, the einsum's operands once and its output once). The
    reference counts the bytes of the compiled XLA program's HLO instead;
    the port has no HLO, so it counts the operations it issues;
  * **measured time**: min of ``reps`` after one warm call, by CUDA events
    on the card (the host's clock on the CPU);

then fits ``time_us = overhead_us + model_bytes / bandwidth`` by least
squares over the shapes. :func:`calibration_report` prints the
model-against-measured error of each shape. The coefficients persist in the
plan cache's ``calibration`` slot.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import torch

from ..engine.plan import Memory, uniform_plan
from .cache import PlanCache, default_cache, platform_tag

#: Small enough to calibrate in seconds on the CPU, large enough that the
#: blocked schedule's traffic outweighs a call's fixed cost.
DEFAULT_CASES: tuple[tuple[tuple[int, ...], int], ...] = (
    ((48, 40, 32), 8),
    ((64, 48, 32), 16),
    ((96, 64, 48), 8),
    ((32, 24, 16, 12), 8),
)


@dataclass
class ShapeCalibration:
    """Model-against-measured numbers of one calibration shape."""

    shape: tuple[int, ...]
    rank: int
    block: int
    model_bytes: int
    measured_bytes: int
    walltime_us: float
    predicted_us: float = float("nan")

    @property
    def traffic_rel_err(self) -> float:
        """(model - measured) / measured: the Eq-10 model's honesty."""
        if self.measured_bytes <= 0:
            return float("nan")
        return (self.model_bytes - self.measured_bytes) / self.measured_bytes

    @property
    def time_rel_err(self) -> float:
        if not self.walltime_us:
            return float("nan")
        return (self.predicted_us - self.walltime_us) / self.walltime_us


@dataclass
class Calibration:
    """Per-machine coefficients: ``time_us = overhead_us + bytes / bandwidth``."""

    bandwidth_bytes_per_us: float
    overhead_us: float
    rows: list[ShapeCalibration] = field(default_factory=list)
    backend: str = "cpu"

    def predict_us(self, model_bytes: float) -> float:
        return self.overhead_us + model_bytes / max(self.bandwidth_bytes_per_us, 1e-12)

    def to_dict(self) -> dict:
        return {
            "bandwidth_bytes_per_us": self.bandwidth_bytes_per_us,
            "overhead_us": self.overhead_us,
            "backend": self.backend,
            "torch": torch.__version__,
            "rows": [
                {"shape": list(r.shape), "rank": r.rank, "block": r.block,
                 "model_bytes": r.model_bytes, "measured_bytes": r.measured_bytes,
                 "walltime_us": r.walltime_us, "predicted_us": r.predicted_us}
                for r in self.rows
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        cal = cls(float(d["bandwidth_bytes_per_us"]), float(d["overhead_us"]),
                  backend=d.get("backend", "cpu"))
        for r in d.get("rows", ()):
            cal.rows.append(ShapeCalibration(
                tuple(r["shape"]), r["rank"], r["block"], r["model_bytes"],
                r["measured_bytes"], r["walltime_us"], r.get("predicted_us", float("nan"))))
        return cal


def blocked_mttkrp_bytes(dims: Sequence[int], rank: int, mode: int, block: int,
                         itemsize: int = 4) -> int:
    """Bytes :func:`~repro_torch.core.blocked.mttkrp_blocked` reads and
    writes for one mode-``mode`` MTTKRP with uniform ``block``: X padded to
    multiples of ``block`` (read X, write the copy, when any extent needs
    it), each other factor padded likewise, then the einsum reading the
    blocked X and factors once and writing the padded output once."""
    padded = [-(-int(d) // block) * block for d in dims]
    x_bytes, xp_bytes = math.prod(dims) * itemsize, math.prod(padded) * itemsize
    total = xp_bytes + (x_bytes + xp_bytes if padded != list(dims) else 0)
    for k, (d, p) in enumerate(zip(dims, padded)):
        if k == mode:
            continue
        total += p * rank * itemsize + (d * rank * itemsize + p * rank * itemsize
                                        if p != d else 0)
    return total + padded[mode] * rank * itemsize


def _fit_affine(xs: Sequence[float], ys: Sequence[float]) -> tuple[float, float]:
    """Least-squares ``y = a + b x``."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    if sxx <= 0:
        return my, 0.0
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    return my - b * mx, b


def calibrate(
    cases: Sequence[tuple[Sequence[int], int]] = DEFAULT_CASES,
    *,
    memory: Memory | None = None,
    reps: int = 3,
    cache: PlanCache | None = None,
    persist: bool = True,
    device: str | torch.device = "cuda",
) -> Calibration:
    """Measure the blocked schedule on each case and fit the coefficients.
    Needs at least 3 shapes (the affine fit and the per-shape report).
    ``device`` defaults to the card; the data are drawn there from seed 0."""
    if len(cases) < 3:
        raise ValueError("calibration needs at least 3 shapes")
    from ..engine import execute as engine_execute  # call-time: the engine imports tune
    from ..engine.context import ExecutionContext
    from .search import _time_call

    ctx = ExecutionContext.create("blocked_host", device=device)
    dev = ctx.torch_device
    mem = memory or Memory.abstract(1 << 16)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows: list[ShapeCalibration] = []
    for dims, rank in cases:
        dims = tuple(int(d) for d in dims)
        plan = uniform_plan(dims, rank, mem)
        b = plan.block_i
        x = torch.randn(dims, generator=gen, device=dev)
        fs = [torch.randn((d, rank), generator=gen, device=dev) for d in dims]

        def run(x=x, fs=fs, b=b):
            return engine_execute.mttkrp(x, fs, 0, ctx=ctx, block=b)

        best = _time_call(run, 1, reps, dev)
        rows.append(ShapeCalibration(dims, rank, b, int(plan.eq10_words(dims, rank)) * 4,
                                     blocked_mttkrp_bytes(dims, rank, 0, b), best))
    overhead, inv_bw = _fit_affine([r.model_bytes for r in rows],
                                   [r.walltime_us for r in rows])
    bandwidth = (1.0 / inv_bw) if inv_bw > 0 else float("inf")
    cal = Calibration(bandwidth, max(overhead, 0.0), rows, platform_tag(dev))
    for r in rows:
        r.predicted_us = cal.predict_us(r.model_bytes)
    if persist:
        (default_cache() if cache is None else cache).put_calibration(cal.to_dict())
    return cal


def load_calibration(cache: PlanCache | None = None) -> Calibration | None:
    d = (default_cache() if cache is None else cache).get_calibration()
    return Calibration.from_dict(d) if d else None


def calibration_report(cal: Calibration) -> str:
    """Human-readable model-against-measured table (one row a shape)."""
    lines = [
        f"calibration[{cal.backend}]: bandwidth={cal.bandwidth_bytes_per_us:.1f} B/us, "
        f"overhead={cal.overhead_us:.1f} us",
        f"{'shape':>18} {'rank':>4} {'b':>4} {'model_MB':>9} {'measured_MB':>11} "
        f"{'traffic_err':>11} {'time_us':>9} {'pred_us':>9} {'time_err':>9}",
    ]
    for r in cal.rows:
        perr = r.time_rel_err
        lines.append(
            f"{'x'.join(map(str, r.shape)):>18} {r.rank:>4} {r.block:>4} "
            f"{r.model_bytes / 1e6:>9.3f} {r.measured_bytes / 1e6:>11.3f} "
            f"{r.traffic_rel_err:>+10.1%} {r.walltime_us:>9.1f} {r.predicted_us:>9.1f} "
            f"{perr if math.isfinite(perr) else float('nan'):>+8.1%}"
        )
    return "\n".join(lines)
