"""Test config: run on the CPU backend with 8 virtual devices.

Multi-device sharding tests use a virtual 8-device CPU mesh.  Tests
marked ``gpu`` need an NVIDIA GPU and skip elsewhere; to run them on a
GPU machine, set IEACHE_TEST_GPU=1 so that JAX keeps its default
backend:

    IEACHE_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import os

import pytest

if os.environ.get("IEACHE_TEST_GPU") != "1":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time,
    never while the module is imported)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's default device is "
                    f"{dev.platform}")
    return dev
