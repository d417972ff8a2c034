"""Debug-mode numerical checks (SURVEY.md §5 race-detection row).

JAX is functional, so the reference's GPU-hazard concerns don't map over;
what can go wrong here is numerical (NaN/Inf from bad configs).
`debug_mode()` turns on jax's NaN/Inf interception for the enclosed block.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def debug_mode(nan_checks: bool = True):
    """Context manager enabling slow-but-strict execution."""
    prev_nan = jax.config.jax_debug_nans
    try:
        if nan_checks:
            jax.config.update("jax_debug_nans", True)
        yield
    finally:
        jax.config.update("jax_debug_nans", prev_nan)


def assert_finite(name: str, *arrays) -> None:
    """Host-side sanity check for tests and streaming drivers."""
    import numpy as np

    for i, a in enumerate(arrays):
        a = np.asarray(a)
        if not np.isfinite(a).all():
            bad = int((~np.isfinite(a)).sum())
            raise FloatingPointError(
                f"{name}: array {i} has {bad} non-finite values"
            )
