"""Autotuning of the port: empirical plan search, a persistent plan cache,
and a calibrated cost model behind ``backend="auto"``. Counterpart of
``repro.tune``.

    cache     — the on-disk JSON plan cache, keyed by the full problem
                (kind, shape, rank, mode, dtype, Memory, the CUDA device's
                name, the torch version), with schema versioning and an
                in-process memo; ``REPRO_TORCH_TUNE_CACHE`` overrides the
                path.
    search    — candidates (einsum, blocked_host, and the Hopper kernels
                with their own plans: the chooser's and its neighbours, both
                3-way variants), measured through the engine with CUDA
                events; and ``resolve``, the ``backend="auto"`` entry.
    calibrate — fits this machine's bandwidth and overhead so the blocked
                schedule's modeled bytes can be scored against measurements.
"""

from .cache import (
    SCHEMA_VERSION,
    CacheEntry,
    PlanCache,
    cache_key,
    default_cache,
    isolated_cache,
    plan_from_dict,
    plan_to_dict,
)
from .calibrate import Calibration, calibrate, calibration_report
from .search import (  # the search *function* stays module-qualified
    Candidate,
    Measurement,
    TuneResult,
    generate_candidates,
    resolve,
    resolve_multi_ttm,
    resolve_sweep,
    tune_mttkrp,
    tune_multi_ttm,
    tune_partial,
    tune_sweep,
)
from . import cache, calibrate, search  # noqa: E402,F401  (the submodules, as in the reference)

__all__ = [
    "SCHEMA_VERSION",
    "CacheEntry",
    "PlanCache",
    "cache_key",
    "default_cache",
    "isolated_cache",
    "plan_from_dict",
    "plan_to_dict",
    "Calibration",
    "calibrate",
    "calibration_report",
    "Candidate",
    "Measurement",
    "TuneResult",
    "generate_candidates",
    "resolve",
    "resolve_multi_ttm",
    "resolve_sweep",
    "tune_mttkrp",
    "tune_multi_ttm",
    "tune_partial",
    "tune_sweep",
    "search",
]
