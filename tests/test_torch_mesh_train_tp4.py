"""The port's sharded train and serve steps on a ``(2, 4)`` mesh of 8 gloo
ranks (tp = 4) against the reference's unsharded steps, for the smoke
configs of ``mamba2-2.7b`` and the hybrid ``jamba-v0.1-52b`` in fp32,
each router's smallest margin asserted first. At tp = 4 the SSM's and the
MLP's output projections sum their output's gradient over 4 ranks, and
the gate's gradient comes back split 4 ways; the ``(2, 2)`` files hold
the same steps at tp = 2. ``tests/_torch_mesh.py`` holds the workers, the
reference and the limits.
"""

import pytest

import _torch_mesh as mesh

NAMES = ("mamba2-2.7b", "jamba-v0.1-52b")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return mesh.run(NAMES, str(tmp_path_factory.mktemp("mesh_train_tp4")), shape=(2, 4))


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
