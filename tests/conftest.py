"""Test environment: CPU backend with a virtual 8-device mesh.

The suite runs without an accelerator: the host platform is split into
8 virtual devices so the sharding tests exercise real multi-device
partitioning, and Pallas kernels run in interpret mode. Tests marked
``gpu`` need a CUDA card and skip elsewhere; run them on a GPU machine
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

from ikpso.utils.cache import enable_compile_cache  # noqa: E402

# The unrolled LM-polish programs take tens of seconds of XLA CPU
# compile; cache them across test runs.
enable_compile_cache(min_compile_time_secs=2.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless the default device is a CUDA GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU (run: JAX_PLATFORMS=cuda pytest -m gpu)")
