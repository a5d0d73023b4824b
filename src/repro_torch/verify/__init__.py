"""Static verification: prove the paper's invariants and the port's kernel
plans without running anything. Counterpart of ``repro.verify``.

One :class:`Finding` currency and one CLI (``python -m
repro_torch.verify``). Ported so far (ROADMAP Queue 1 item 13):

* :mod:`repro_torch.verify.plans` — pure arithmetic over the planner's
  ``BlockPlan`` / ``MultiTTMPlan`` objects, the reference's checks over the
  reference's lattice (plus the port's default memory,
  ``Memory.h100_smem``), and over the Hopper kernels' own plans
  (``MTTKRPKernelPlan``, ``MultiTTMKernelPlan``, ``PartialKernelPlan``):
  each chooser's plan is one the kernel takes, its shared memory within a
  CTA's limit and the planning budget, its launch grid covering the output
  minimally, its splits and batch within the grid's limits.

The reference's other analyzers (``kernels``, ``lint``, ``comm``,
``dtypes``) are not ported yet; the CLI refuses to run them rather than
report them clean. Verdicts ride the span schema (``kind="static_verify"``)
so ``python -m repro_torch.observe.report`` tables them.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class Finding:
    """One static-analysis violation: which analyzer, which rule, where.

    ``analyzer`` is ``"plans"`` (the reference also has ``"kernels"``,
    ``"lint"``, ``"comm"`` and ``"dtypes"``); ``rule`` is the stable rule
    code (e.g. ``"eq9-infeasible"``, ``"kernel-grid-cover"``); ``subject``
    names the object (a plan and its problem); ``detail`` is the
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
