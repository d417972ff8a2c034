"""Standard (non-pyramid) mode: whole-spectrum phase-delta amplification with
a radial spatial-frequency weighting.

Reference: `ProcessPhaseDifference` (`PhaseDifferenceComputeShader.compute:
124-179`), uniforms pushed from `MotionMagnificationProcessor.cs:489-506`.

The weight w(f) depends only on (shape, config), so it is precomputed once on
host (numpy) and closed over as a constant — the per-frame work is a single
fused elementwise pass.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax.numpy as jnp
import numpy as np

from pbmm_tpu.core.complexop import wrap_phase


@functools.lru_cache(maxsize=16)
def _weight_map_np(
    pad_h: int,
    pad_w: int,
    apply_bandpass: bool,
    low_cutoff: float,
    high_cutoff: float,
    steepness: float,
    motion_sensitivity: float,
    edge_enhancement: float,
) -> np.ndarray:
    """w(f) per bin, exact math of `calculate_spatial_frequency` +
    `calculate_bandpass_weight` (`PhaseDifferenceComputeShader.compute:
    74-122`)."""
    fy = np.arange(pad_h, dtype=np.float64)[:, None] / pad_h - 0.5
    fx = np.arange(pad_w, dtype=np.float64)[None, :] / pad_w - 0.5
    # Radial frequency scaled so the corner (~0.707) maps to 1 (`:74-85`).
    f = np.minimum(np.sqrt(fx * fx + fy * fy) / 0.707, 1.0)

    if not apply_bandpass:
        w = np.ones_like(f)
    else:
        w = np.ones_like(f)
        lo = np.maximum(low_cutoff, 0.001)
        below = f < low_cutoff
        w = np.where(below, w * (f / lo) ** steepness, w)
        hi_div = np.maximum(1.0 - high_cutoff, 0.001)
        above = f > high_cutoff
        w = np.where(above, w * ((1.0 - f) / hi_div) ** steepness, w)
        w = w * motion_sensitivity
        mid = (f > low_cutoff) & (f < high_cutoff)
        edge = 1.0 + edge_enhancement * np.sin(
            np.pi * (f - low_cutoff) / (high_cutoff - low_cutoff)
        )
        w = np.where(mid, w * edge, w)
        w = np.maximum(w, 0.0)
    return w.astype(np.float32)


def bandpass_weight_jnp(freq: jnp.ndarray, cfg) -> jnp.ndarray:
    """w(f) as an elementwise function of the radial frequency `freq`, on
    device — same math as `_weight_map_np`, so it fuses into the phase
    pass instead of shipping/reading a (H, W) constant.  Any spectrum
    layout or shard evaluates it on its own frequency grid."""
    f = jnp.minimum(freq / 0.707, 1.0)
    if not cfg.apply_bandpass:
        return jnp.ones_like(f)
    steep = cfg.filter_steepness
    w = jnp.ones_like(f)
    w = jnp.where(
        f < cfg.low_freq_cutoff,
        w * (f / max(cfg.low_freq_cutoff, 1e-3)) ** steep,
        w,
    )
    w = jnp.where(
        f > cfg.high_freq_cutoff,
        w * ((1.0 - f) / max(1.0 - cfg.high_freq_cutoff, 1e-3)) ** steep,
        w,
    )
    w = w * cfg.motion_sensitivity
    edge = cfg.edge_enhancement if cfg.enhance_edges else 0.0
    mid = (f > cfg.low_freq_cutoff) & (f < cfg.high_freq_cutoff)
    w = jnp.where(
        mid,
        w
        * (
            1.0
            + edge
            * jnp.sin(
                jnp.pi
                * (f - cfg.low_freq_cutoff)
                / (cfg.high_freq_cutoff - cfg.low_freq_cutoff)
            )
        ),
        w,
    )
    return jnp.maximum(w, 0.0)


def bandpass_weight_map_jnp(pad_h: int, pad_w: int, cfg,
                            layout: str = "centered") -> jnp.ndarray:
    """Procedural form of `bandpass_weight_map` on a (pad_h, pad_w) grid;
    `layout="rfft"` evaluates the same radial weight on the natural
    half-spectrum grid."""
    from pbmm_tpu.pyramid.filters import freq_grid_jnp

    return bandpass_weight_jnp(freq_grid_jnp(pad_h, pad_w, layout), cfg)


def bandpass_weight_map(pad_h: int, pad_w: int, cfg) -> jnp.ndarray:
    """(H, W) f32 phase-delta weight map for the standard mode.

    `enhance_edges=False` zeroes the edge term, mirroring the C# uniform push
    (`MotionMagnificationProcessor.cs:505`).
    """
    return jnp.asarray(
        _weight_map_np(
            pad_h,
            pad_w,
            bool(cfg.apply_bandpass),
            float(cfg.low_freq_cutoff),
            float(cfg.high_freq_cutoff),
            float(cfg.filter_steepness),
            float(cfg.motion_sensitivity),
            float(cfg.edge_enhancement) if cfg.enhance_edges else 0.0,
        )
    )


def standard_phase_amplify(
    cur: jnp.ndarray,
    prev: jnp.ndarray,
    weight: jnp.ndarray,
    phase_scale: float,
    magnitude_threshold: float,
    magnitude_scale: float = 1.0,
    apply_magnitude_scale: bool = False,
    delta_override: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """out = gate ? cur : cur * exp(1j * wrap(arg(prev)-arg(cur)) * w * scale)

    (`PhaseDifferenceComputeShader.compute:124-179`).  `magnitude_scale` is
    computed but *not applied* by the reference (`:169,175-178`); we apply it
    only behind `apply_magnitude_scale`.
    """
    from pbmm_tpu.phase.amplify import phase_delta

    cur_mag = jnp.abs(cur)
    prev_mag = jnp.abs(prev)
    gate = (cur_mag < magnitude_threshold) | (prev_mag < magnitude_threshold)
    delta = phase_delta(cur, prev)
    if delta_override is not None:
        delta = delta_override
    modified = cur * jnp.exp(1j * (delta * weight * phase_scale).astype(jnp.complex64))
    if apply_magnitude_scale:
        modified = modified * jnp.asarray(magnitude_scale, jnp.float32)
    return jnp.where(gate, cur, modified)
