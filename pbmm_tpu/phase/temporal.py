"""Streaming temporal filtering of phase deltas (extension).

The reference's temporal model is exactly a two-frame delta — the `fir=[1]`
special case of filtering the delta stream (SURVEY.md §5 "long-context"
row).  Here we add a streaming IIR band-pass over the per-bin delta stream,
carried as `lax.scan` state so per-device memory stays flat for arbitrarily
long videos: band-passed delta = lp_fast - lp_slow, where each lp is a
first-order low-pass y += r (x - y) — the classic realtime Eulerian video
magnification filter pair.

State is a pytree of f32 arrays only (complex is kept out of public/jit
boundaries, so checkpoints hold plain float arrays).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp


class TemporalState(NamedTuple):
    lp_fast: jnp.ndarray  # delta-plane-shaped f32
    lp_slow: jnp.ndarray  # delta-plane-shaped f32


def temporal_init(shape: Tuple[int, ...], temporal_cfg) -> TemporalState:
    """`shape` is the per-frame delta-plane shape, e.g. (C, H, W)."""
    if temporal_cfg.mode == "two_frame":
        # Zero-size state keeps the scan carry minimal.
        z = jnp.zeros((0,) * len(shape), jnp.float32)
        return TemporalState(z, z)
    z = jnp.zeros(shape, jnp.float32)
    return TemporalState(z, z)


def temporal_apply(
    delta: jnp.ndarray, state: TemporalState, temporal_cfg
) -> Tuple[jnp.ndarray, TemporalState]:
    """Filter one frame's delta plane; returns (filtered_delta, new_state)."""
    if temporal_cfg.mode == "two_frame":
        return delta, state
    r_hi, r_lo = temporal_cfg.smoothing_factors()
    lp_fast = state.lp_fast + jnp.float32(r_hi) * (delta - state.lp_fast)
    lp_slow = state.lp_slow + jnp.float32(r_lo) * (delta - state.lp_slow)
    return lp_fast - lp_slow, TemporalState(lp_fast, lp_slow)
