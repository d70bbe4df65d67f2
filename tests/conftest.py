"""Test configuration: run everything on a virtual 8-device CPU mesh.

Sharding/collective code is exercised on XLA's host platform with 8 virtual
devices (the JAX-recommended pattern for distributed testing), and float64
is enabled so numerics can be validated against scipy/sklearn references.
Tests that need an NVIDIA GPU are marked ``gpu`` (pyproject.toml) and take
the ``gpu_device`` fixture, which skips them everywhere else.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# the repository root: chip_smoke.py and bench.py are importable by tests
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)

from gpras_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture()
def gpu_device():
    """The default device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (default device is {dev.platform})")
    return dev
