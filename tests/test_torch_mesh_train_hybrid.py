"""The port's sharded train and serve steps on a ``(2, 2)`` mesh of 4 gloo
ranks against the reference's unsharded steps, for the smoke config of
the hybrid ``jamba-v0.1-52b`` (SSM and attention mixers, MLP and MoE FFNs)
in fp32, each router's smallest margin asserted first;
``tests/_torch_mesh.py`` holds the workers, the reference and the limits.
"""

import pytest

import _torch_mesh as mesh

NAMES = ("jamba-v0.1-52b",)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return mesh.run(NAMES, str(tmp_path_factory.mktemp("mesh_train_hybrid")))


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
