"""Test harness: run on CPU with 8 virtual devices so multi-device sharding
paths are exercised without accelerator hardware.  Tests marked `gpu` need
the card and skip here; chip_smoke.py runs those paths on it."""

import os

# XLA_FLAGS must land before the CPU backend initializes; jax itself may
# already be imported (the jaxtyping pytest plugin imports it before
# conftest), so the platform choice also goes through jax.config.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def gist_1000():
    """The bundled 1000 x 960-d Gist slice used throughout the reference's
    tests (reference: data/gist_1000.bin, config/gist_1000.toml)."""
    path = os.path.join(os.path.dirname(__file__), "..", "data", "gist_1000.bin")
    data = np.fromfile(path, dtype=np.float32).reshape(-1, 960)
    assert data.shape == (1000, 960)
    return data


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided per test, never
    at import: parallel workers must collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU; chip_smoke.py runs this path on the card")
