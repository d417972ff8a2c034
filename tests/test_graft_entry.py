"""The driver contract: entry() compile-checks and dryrun_multichip runs on
a virtual device mesh."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__ as ge  # noqa: E402


def test_entry_compiles_and_runs():
    fn, args = ge.entry()
    out = fn(*args)
    out = np.asarray(out)
    assert out.shape == (256, 256, 3)
    assert np.isfinite(out).all()


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")
def test_dryrun_multichip_8():
    ge.dryrun_multichip(8)


@pytest.mark.skipif(jax.device_count() < 2, reason="needs 2 devices")
def test_dryrun_multichip_2():
    ge.dryrun_multichip(2)


def test_dryrun_multichip_needs_the_devices():
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        ge.dryrun_multichip(64)
