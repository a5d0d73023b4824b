"""Static verification: prove the paper's invariants and the port's kernels,
plans and collectives without running a kernel. Counterpart of
``repro.verify``.

Five analyzers, one :class:`Finding` currency, one CLI
(``python -m repro_torch.verify``):

* :mod:`repro_torch.verify.plans` — pure arithmetic over the planner's
  ``BlockPlan`` / ``MultiTTMPlan`` objects (the reference's checks over its
  lattice, plus the port's default memory ``Memory.h100_smem``), and over
  the Hopper kernels' own plans (``MTTKRPKernelPlan``,
  ``MultiTTMKernelPlan``, ``PartialKernelPlan``): each chooser's plan is one
  the kernel takes, its shared memory within a CTA and the budget, its grid
  covering the output minimally, its splits and batch within the grid's
  limits.
* :mod:`repro_torch.verify.kernels` — each Hopper kernel's tile walk in
  Python (the blocks of every buffer each CTA stores, from the grid
  mirrors and the kernels' index arithmetic), counted with numpy over a
  lattice of the port's cells, ragged edges and batches: coverage,
  write-once, in-bounds boxes, the grid's limits, the written dtype and
  the shared memory. ``chip_smoke.py`` holds these walks against the
  kernels on the card (the C launchers' grid functions, and a build of the
  kernels with a per-element write counter).
* :mod:`repro_torch.verify.lint` — AST rules over the port's own modules
  (falsy-or-default, import scope: no ``jax`` and no ``repro`` anywhere
  and no ``torch`` in the equation layer, mutable defaults, wall clocks
  outside the measurement layers, raw ``torch.distributed`` collectives
  outside ``distributed/collectives.py``, mesh-axis literals).
* :mod:`repro_torch.verify.comm` — every rank's program of the CP and
  Tucker sweeps and of Alg 3 run in one process over a transport that
  moves nothing: each rank's counted bytes equal the §V-C3 models exactly
  and sit above the parallel lower bounds; the ring schedules are
  deadlock-free single cycles with exact, write-once chunk flow; grid
  selection matches brute force.
* :mod:`repro_torch.verify.dtypes` — a dispatch-mode recorder of every
  accumulating aten op under ``compute_dtype=bfloat16`` on every backend:
  a narrow-input accumulation must produce fp32 (and on the card every
  kernel launch writes float32).

Verdicts ride the span schema (``kind="static_verify"``) so ``python -m
repro_torch.observe.report`` tables them.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class Finding:
    """One static-analysis violation: which analyzer, which rule, where.

    ``analyzer`` is ``"plans"`` / ``"kernels"`` / ``"lint"`` / ``"comm"``
    / ``"dtypes"``; ``rule`` is the stable rule code (e.g.
    ``"eq9-infeasible"``, ``"write-once"``, ``"RV107"``,
    ``"byte-model-mismatch"``); ``subject`` names the object (a plan, a
    kernel case or a ``file:line`` location); ``detail`` is the
    human-readable evidence."""

    analyzer: str
    rule: str
    subject: str
    detail: str

    def to_dict(self) -> dict:
        """Plain-dict form for JSONL trace events and test assertions."""
        return asdict(self)

    def __str__(self) -> str:
        return f"[{self.analyzer}:{self.rule}] {self.subject}: {self.detail}"


__all__ = ["Finding"]
