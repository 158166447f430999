"""Test configuration: JAX on a host-simulated 8-device CPU mesh.

The sharding layer is exercised on XLA's virtual CPU devices, which run the
same SPMD partitioner as a multi-GPU host.  JAX_PLATFORMS defaults to cpu.

Tests that need a GPU carry the ``chip`` marker and take the ``gpu``
fixture, which skips them where JAX finds no GPU.  On a GPU host:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests -m chip -p no:randomly
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# NOTE: no persistent compilation cache for tests — XLA:CPU AOT entries are
# machine-feature-specific and poison reruns on heterogeneous hosts; true
# CPU compiles of these programs take seconds anyway.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a GPU; skipped where JAX finds none")


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX reports {dev.platform!r}")
    return dev
