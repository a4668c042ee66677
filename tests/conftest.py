"""Test configuration: run everything on a virtual 8-device CPU mesh.

The unit tests run on the CPU (``JAX_PLATFORMS=cpu``, forced here);
multi-device sharding is validated on a virtual CPU mesh. Tests that need
the GPU carry the ``gpu`` marker and take the ``gpu_device`` fixture, which
skips them here; run them on the card with ``python -m pytest tests -m gpu
-p no:xdist`` and ``PDF_TEST_PLATFORM=gpu``.
Must set flags before jax is imported anywhere.
"""

import os

_ON_GPU = os.environ.get("PDF_TEST_PLATFORM") == "gpu"
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_enable_x64", True)  # oracles compare at f64

# Persistent XLA cache: the heavy suite compiles (GICP planar GN loop,
# shard_map SPMD programs) become a once-per-cache cost; the cache key is
# the optimized HLO, so code changes re-compile exactly what changed.
from pointcloud_depthfusion_tpu.utils.compile_cache import (  # noqa: E402
    enable_persistent_cache,
)

enable_persistent_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with PDF_TEST_PLATFORM=gpu)")
    return devs[0]
