"""The port's sharded train and serve steps on a ``(2, 2)`` mesh of 4 gloo
ranks against the reference's unsharded steps, for the smoke config of
``mamba2-2.7b`` (the SSD kernel's plain version under ``local_map``) in
fp32, and the elastic restore across meshes; ``tests/_torch_mesh.py``
holds the workers, the reference and the limits
(``tests/test_torch_mesh_train_dense.py``, ``_moe.py`` and ``_hybrid.py``
the other families).

Also ``mamba2-2.7b``'s sharded step in 2 microbatches against its step on
the whole batch, every parameter and moment keeping its layout.

The elastic restore: ``mamba2-2.7b``'s state laid out on the mesh is
saved (rank 0 writes what every rank gathered) and restored onto no mesh
and onto a ``(1, 4)`` mesh: every array bit-equal, each leaf laid out by
its spec, and the checkpoint's arrays and manifest byte-equal to an
unsharded save of the same state (the archive's own timestamps aside).
"""

import os
import zipfile

import pytest

import _torch_mesh as mesh

NAMES = ("mamba2-2.7b",)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return mesh.run(NAMES, str(tmp_path_factory.mktemp("mesh_train")), restore=True)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_train_losses_match_the_reference(run, name):
    mesh.check_losses(run, name)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_gradients_match_the_reference(run, name):
    mesh.check_gradients(run, name)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_parameters_after_two_steps_match_the_reference(run, name):
    mesh.check_parameters(run, name)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_decode_matches_the_reference(run, name):
    mesh.check_decode(run, name)


def test_a_sharded_step_in_two_microbatches_takes_the_whole_batchs_step(run):
    mesh.check_microbatches(run, NAMES[0])


def test_restore_onto_no_mesh_is_bit_exact(run):
    assert run["restore"]["null_equal"] and run["restore"]["null_plain"]


def test_restore_onto_another_mesh_is_bit_exact_and_laid_out(run):
    r = run["restore"]
    assert r["mesh_equal"] and r["mesh_moments_equal"] and r["mesh_laid_out"]
    assert r["step"] == 0


def test_a_sharded_save_writes_what_an_unsharded_save_writes(run):
    def contents(d):
        path = os.path.join(run["tmp"], d, "step_3")
        with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
            arrays = {n: z.read(n) for n in z.namelist()}
        with open(os.path.join(path, "manifest.json"), "rb") as f:
            return arrays, f.read()

    sharded, plain = contents("sharded"), contents("plain")
    assert len(plain[0]) > 0 and sharded == plain
