"""Test harness config: CPU JAX with 8 virtual devices.

The suite runs on the CPU backend (``JAX_PLATFORMS=cpu``) with an
8-device virtual mesh for the sharded paths; Pallas kernels run in
interpret mode (``FUGU_PALLAS_INTERPRET=1``), since a Triton kernel
compiles only for a GPU.

Tests that need the card carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them when JAX finds no GPU.  On a
machine with an H100: ``FUGU_TEST_GPU=1 python -m pytest tests/ -m gpu``.
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

if not os.environ.get("FUGU_TEST_GPU"):
    os.environ["FUGU_PALLAS_INTERPRET"] = "1"
    import jax

    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)"
    )


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise
    (decided at run time, never while collecting)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
