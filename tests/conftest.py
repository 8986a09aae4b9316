"""Test configuration: float64, and 8 virtual devices on the CPU.

The platform follows ``JAX_PLATFORMS`` and defaults to the CPU, where the
multi-device sharding tests use a virtual 8-device mesh
(``--xla_force_host_platform_device_count=8``); the same code runs unchanged
on the cards of one host. Parity tests run in float64 (x64),
float32-accuracy tests cast explicitly. Tests marked ``gpu`` need an NVIDIA
GPU and skip elsewhere: ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    """Skip ``gpu``-marked tests when JAX's default device is not a GPU
    (decided here, at run time, never while collecting)."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU: run JAX_PLATFORMS=cuda "
                        "python -m pytest -m gpu tests/ on the card")
