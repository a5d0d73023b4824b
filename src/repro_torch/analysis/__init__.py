"""Analysis: the roofline model and the kernels' bound rule. Counterpart of
``repro.analysis``; ``hlo_cost.py`` has no counterpart (the port compiles
no HLO: ``docs/PORT.md``)."""

from .roofline import H100, HW, RooflineTerms, bound, mma_bound, ssd_bound

__all__ = ["HW", "H100", "RooflineTerms", "bound", "mma_bound", "ssd_bound"]
