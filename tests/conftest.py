"""Test harness: run everything on CPU with 8 virtual devices so that the
multi-device sharding paths are exercised without accelerator hardware (the
dryrun in __graft_entry__.py does the same via
xla_force_host_platform_device_count).

SUPERNOVA_GPU_TESTS=1 leaves the platform alone, for the card-only tests
(`-m gpu`, tests/test_gpu.py), which chip_smoke.py runs on the GPU."""
import os

if os.environ.get("SUPERNOVA_GPU_TESTS") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"  # tests run on the virtual CPU mesh
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")  # env may have been read already
# NO persistent compile cache for tests: executable (de)serialization on the
# 8-virtual-device CPU backend segfaults flakily inside
# compilation_cache.{get,put}_executable_and_time (observed in both the read
# and the write path, fresh cache dir, jaxlib in this image).

import numpy as np
import pytest

# paranoid mode: every D.validate() in the pipeline runs the deep per-edge
# invariant checks, so a surgery that breaks an invariant fails its test
from supernova_tpu.asm import supergraph as _sg

_sg.PARANOID = True


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU, for tests marked `gpu`; skips where JAX has none."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run by chip_smoke.py on the card)")
    return devs[0]
