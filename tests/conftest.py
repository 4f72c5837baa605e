"""Test configuration: run on a virtual 8-device CPU mesh.

jax.config is set before any backend initializes, so every test sees eight
CPU devices whatever accelerator the machine has. Tests that need a real
GPU carry the ``gpu`` marker and take the ``gpu_device`` fixture, which
skips them here; run them on a GPU machine with ``SAD_TPU_TEST_ON_GPU=1
python -m pytest tests/ -m gpu``.
"""

import os

import jax
import pytest

os.environ.setdefault("JAX_ENABLE_X64", "0")

if os.environ.get("SAD_TPU_TEST_ON_GPU", "0") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (run with SAD_TPU_TEST_ON_GPU=1 on one)")
    return devices[0]
