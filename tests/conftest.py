"""Test configuration.

By default every test runs on the CPU, on a virtual 8-device mesh, so the
sharding tests need no hardware.  With ``BSMR_SDDMM_TEST_GPU=1`` JAX keeps
its default backend instead, and the tests marked ``gpu`` run on the card:

    BSMR_SDDMM_TEST_GPU=1 python -m pytest tests -m gpu

Whether a card is present is decided by the ``gpu_device`` fixture, at
test time, never while a module is imported.
"""

import os
import sys

if os.environ.get("BSMR_SDDMM_TEST_GPU") != "1":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    # set through jax.config as well: an environment variable alone is
    # too late if anything imported jax before this file ran (backends
    # are not initialized until first use, so this still works)
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if os.environ.get("BSMR_SDDMM_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from bsmr_sddmm.data import generate  # noqa: E402


@pytest.fixture(scope="session")
def small_random_csr():
    return generate.random_sparse(200, 160, density=0.05, seed=3)


@pytest.fixture(scope="session")
def clustered_csr():
    return generate.block_clustered(
        num_row_groups=24, num_col_groups=20, block_prob=0.15,
        block_density=0.8, noise_density=0.002, seed=7)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform!r} "
                    "(run with BSMR_SDDMM_TEST_GPU=1 on the card)")
    return dev
