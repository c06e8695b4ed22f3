"""Test harness: run everything on CPU with 8 virtual devices so the
multi-device sharding path is exercised without GPUs (SURVEY.md section 4:
CPU-simulated multi-chip tests). ``RESNET_TPU_TEST_PLATFORM=cuda`` runs the
suite on a GPU instead; tests marked ``gpu`` take the ``gpu`` fixture and
skip unless the first device is one."""

import os

# Pin the platform before jax is imported: CPU unless asked otherwise.
os.environ["JAX_PLATFORMS"] = os.environ.get("RESNET_TPU_TEST_PLATFORM", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless the first JAX device is a GPU. Decided here, when the
    test runs, never at import or collection time: every xdist worker must
    collect the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (first device is {dev.platform}); run "
                    "with RESNET_TPU_TEST_PLATFORM=cuda -m gpu")
    return dev

