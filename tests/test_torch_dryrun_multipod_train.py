"""The dry run's ``train`` cells on the 2x16x16 mesh (512 ranks of a fake
process group; DTensor plans every op over three mesh dims, so each cell
takes tens of seconds) at one layer, for the three families the mesh
repairs touched (``tests/test_torch_dryrun_cells.py`` has the 16x16
ones)."""

import pytest

from _torch_dryrun_cells import ARCHS, run


@pytest.mark.parametrize("arch", ARCHS)
def test_repaired_cells_run_on_2x16x16(arch, tmp_path):
    run(arch, "train_4k", True, tmp_path)
