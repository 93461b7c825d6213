"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches must
see the real single CPU device; only launch/dryrun.py fakes 512 devices."""
import sys

# Install-or-skip guard for the `hypothesis` test dependency (declared in
# pyproject.toml's [test] extra): when it is absent, inject the deterministic
# in-repo fallback so the six property-test modules still collect and run a
# fixed-seed sample instead of erroring at import time.
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import _hypothesis_fallback
    sys.modules.setdefault("hypothesis", _hypothesis_fallback)

import jax
import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end tests")
    config.addinivalue_line(
        "markers", "cuda: compares a CUDA kernel of the PyTorch port with "
        "its plain version; needs a CUDA device and skips without one")
    # Lock the backend to the real single CPU device BEFORE any test module
    # imports repro.launch.dryrun (which sets XLA_FLAGS for ITS OWN process;
    # jax ignores the env var once initialised).
    assert len(jax.devices()) >= 1
