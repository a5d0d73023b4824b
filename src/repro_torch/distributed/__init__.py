"""The distributed runtime on ``torch.distributed``: the parallel MTTKRP
algorithms (Alg 3 and 4), grid selection, the stationary CP-ALS sweep
driver, and the counted collectives. Counterpart of ``repro.distributed``
(its ``hlo.py`` has no counterpart: the collectives count their own bytes,
:mod:`.collectives`; the Tucker sweep and ``compression.py`` come with the
next slice)."""

from .collectives import COUNTER, CollectiveCounter, Group, ring_total
from .cp_als_parallel import build_cp_sweep, cp_als_parallel, place_cp_state
from .grid_select import (
    GridChoice,
    choose_cp_grid,
    choose_tucker_grid,
    multi_ttm_sweep_words,
    select_general_grid,
    select_grid,
    select_stationary_grid,
    select_tucker_grid,
    stationary_sweep_words,
)
from .mesh import (
    GridLayout,
    GridMesh,
    hyperslice_axes,
    make_abstract_grid_mesh,
    make_grid_mesh,
    mode_axis,
    row_sharding_axes,
    validate_grid,
    validate_tucker_grid,
)
from .mttkrp_parallel import (
    engine_local_fn,
    factor_block,
    gather_factor,
    gather_factors,
    mttkrp_general,
    mttkrp_stationary,
    output_block,
    place_inputs,
    tensor_block,
)

__all__ = [
    "make_grid_mesh",
    "make_abstract_grid_mesh",
    "GridLayout",
    "GridMesh",
    "mode_axis",
    "hyperslice_axes",
    "row_sharding_axes",
    "validate_grid",
    "validate_tucker_grid",
    "engine_local_fn",
    "gather_factor",
    "gather_factors",
    "mttkrp_stationary",
    "mttkrp_general",
    "place_inputs",
    "tensor_block",
    "factor_block",
    "output_block",
    "GridChoice",
    "choose_cp_grid",
    "choose_tucker_grid",
    "select_tucker_grid",
    "multi_ttm_sweep_words",
    "select_grid",
    "select_general_grid",
    "select_stationary_grid",
    "stationary_sweep_words",
    "build_cp_sweep",
    "cp_als_parallel",
    "place_cp_state",
    "COUNTER",
    "CollectiveCounter",
    "Group",
    "ring_total",
]
