"""Analysis: the roofline model, the kernels' bound rule and the dry run's
tables (``report.py``). Counterpart of ``repro.analysis``; ``hlo_cost.py``
has no counterpart (the port compiles no HLO; the dry run counts one
device's ops as they run: ``docs/PORT.md``)."""

from .roofline import H100, HW, RooflineTerms, bound, mma_bound, roofline_from_record, ssd_bound

__all__ = ["HW", "H100", "RooflineTerms", "bound", "mma_bound", "roofline_from_record",
           "ssd_bound"]
