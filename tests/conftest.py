"""Test environment: the CPU backend with 8 virtual devices.

Multi-device code is tested on a virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8), the analog of the
reference's rayon-thread-scaling tests (reference
tests/test_performance.rs:134-156).

Tests marked `gpu` need an NVIDIA GPU and skip elsewhere, through the
`gpu_device` fixture.  `python chip_smoke.py` runs them on the card inside
its own process with GLC_TESTS_ON_GPU=1, which leaves the platform to JAX.
"""

import os

import pytest

if os.environ.get("GLC_TESTS_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first JAX device when it is an NVIDIA GPU; skips otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card by chip_smoke.py)")
    return dev
