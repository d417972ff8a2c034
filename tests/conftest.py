"""Test harness: force JAX onto CPU with 8 virtual devices so mesh/collective
logic is exercised without accelerators (SURVEY.md §4c).

The platform is pinned through `jax.config` after importing jax but before
any backend is initialized, so the tests run on the CPU even where an
accelerator plugin is installed.  Tests that need a GPU carry the `gpu`
marker and decide inside the `gpu_device` fixture whether one is present;
on a GPU machine they run with

    PBMM_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("PBMM_TESTS_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

# The persistent compilation cache must stay OFF for the whole test
# process: in-process CLI invocations (`pbmm_tpu.cli.main` enables the
# cache for accelerator runs) would otherwise flip the process-wide cache dir on,
# and a cache populated by a *different* XLA build/machine then serves
# stale XLA:CPU AOT executables to later tests — which abort at execute
# time with mismatched target features (observed: SIGABRT in
# test_parallel after test_cli/test_checkpoint ran).  CPU test compiles
# are sub-second; the cache buys nothing here.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (PBMM_TESTS_ON_GPU=1 on a GPU "
                    "machine)")
    return dev
