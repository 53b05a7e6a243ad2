"""Test configuration.

Tests run on a virtual 8-device CPU mesh so that multi-device sharding
logic is exercised without accelerators. This must happen before jax is
imported anywhere. Tests marked `gpu` need a CUDA device; they run on
the card with `JAX_PLATFORMS= pytest -m gpu` and skip elsewhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from maria_tpu.backend import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng():
    return np.random.default_rng(42)


@pytest.fixture()
def gpu():
    """The first CUDA device; the test skips where there is none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a CUDA device: run `JAX_PLATFORMS= pytest -m gpu` on the card")
    return devices[0]
