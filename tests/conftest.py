"""Shared pytest fixtures.

NOTE: deliberately does NOT set --xla_force_host_platform_device_count —
smoke tests and benches must see 1 device. Multi-device distributed tests
spawn subprocesses (see tests/dist/).
"""

import os
import sys
import warnings

import numpy as np
import pytest

try:  # real hypothesis when available; deterministic shim otherwise
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(__file__))
    from _hypothesis_stub import install as _install_hypothesis_stub

    _install_hypothesis_stub()

warnings.filterwarnings(
    "ignore", message=".*dtype float64 requested.*", category=UserWarning
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy kernel/tune/distributed suites — PRs run the fast "
        "subset (-m 'not slow'); pushes to main and the nightly schedule "
        "run everything",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the Hopper kernels); skips without one",
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
