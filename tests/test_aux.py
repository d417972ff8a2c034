"""Auxiliary subsystems: launcher helpers, debug checks."""

import numpy as np
import pytest

from pbmm_tpu.parallel.launcher import (
    global_mesh,
    host_local_batch_slice,
    initialize_distributed,
)
from pbmm_tpu.utils.checks import assert_finite, debug_mode


def test_initialize_distributed_noop_without_env(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert initialize_distributed() is False


def test_global_mesh_covers_all_devices():
    import jax

    mesh = global_mesh(n_videos=2)
    assert mesh.devices.size == jax.device_count()
    assert mesh.axis_names == ("data", "frame")


def test_host_local_batch_slice_single_process():
    assert host_local_batch_slice(5) == (0, 5)


def test_assert_finite():
    assert_finite("ok", np.ones(3))
    with pytest.raises(FloatingPointError, match="non-finite"):
        assert_finite("bad", np.array([1.0, np.nan]))


def test_debug_mode_catches_nan():
    import jax
    import jax.numpy as jnp

    with debug_mode():
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: jnp.log(x) / x)(jnp.float32(-1.0)).block_until_ready()
    # restored afterwards
    assert not jax.config.jax_debug_nans


def test_parity_tool_passes():
    from pbmm_tpu.tools.parity import run_parity

    results = run_parity(size=64, frames=4,
                         which="pyramid_defaults,standard")
    assert len(results) == 2
    assert all(r["pass_35db"] for r in results)
    assert all(r["psnr_db"] > 55 for r in results)
