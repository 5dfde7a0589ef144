"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches see
the single real CPU device; only launch/dryrun.py forces 512 devices."""
import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one "
                   "(run on the card with `pytest -m gpu`)")
