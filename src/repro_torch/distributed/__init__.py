"""The distributed runtime on ``torch.distributed``: the parallel MTTKRP
algorithms (Alg 3 and 4), grid selection, the stationary CP-ALS sweep
driver, and the counted collectives. Counterpart of ``repro.distributed``
and of its Tucker/HOOI sweep and CP gradient compression (its ``hlo.py``
has no counterpart: the collectives count their own bytes,
:mod:`.collectives`)."""

from .collectives import COUNTER, CollectiveCounter, Group, ring_total
from .compression import (
    CompressionState,
    compressed_gradient,
    compression_ratio,
    cp_compressed_mean,
    init_compression_state,
    pick_3way_shape,
)
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
    world_group,
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
from .tucker_parallel import (
    build_tucker_sweep,
    multi_ttm_stationary,
    place_multi_ttm_inputs,
    place_tucker_state,
    tucker_hooi_parallel,
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
    "build_tucker_sweep",
    "multi_ttm_stationary",
    "place_multi_ttm_inputs",
    "place_tucker_state",
    "tucker_hooi_parallel",
    "pick_3way_shape",
    "cp_compressed_mean",
    "CompressionState",
    "init_compression_state",
    "compressed_gradient",
    "compression_ratio",
    "world_group",
    "COUNTER",
    "CollectiveCounter",
    "Group",
    "ring_total",
]
