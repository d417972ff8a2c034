"""Frequency-domain filter banks ("pyramid levels").

Numpy-built, cached per (shape, params) and closed over as constants inside
jit — the analog of the reference generating its masks once at init / on
inspector edits (`GeneratePyramidFilters`, `PyramidOperations.compute:25-87`,
regenerated by `OnValidate`, `MotionMagnificationProcessor.cs:78-88`).

The reference bank is *radial only* — no angular/orientation component
(SURVEY.md §2.2) — and intentionally does not tile to unity (gaps between the
high-pass ramp and the band edges => imperfect reconstruction; reproduced
bit-for-bit by `radial_filter_bank`).  `steerable_filter_bank` is this
build's extension: each mid band is additionally split into K angular
sectors by a partition-of-unity cos^(2(K-1)) window, which leaves every
radial sum unchanged (so K=0 and K>0 collapse identically when no phase
processing is applied).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np


def _smoothstep(t: np.ndarray) -> np.ndarray:
    t = np.clip(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _freq_grid(pad_h: int, pad_w: int):
    # Integer-pixel normalized coordinates, exactly the compute-shader's
    # fx = x/W - 0.5, fy = y/H - 0.5 (`PyramidOperations.compute:32-37`).
    # Array index (y, x) of a DC-centered spectrum corresponds to shifted
    # frequency ((y - H/2)/H, (x - W/2)/W) = (fy, fx) for even H, W.
    fy = np.arange(pad_h, dtype=np.float64) / pad_h - 0.5
    fx = np.arange(pad_w, dtype=np.float64) / pad_w - 0.5
    return fy[:, None], fx[None, :]


@functools.lru_cache(maxsize=16)
def _radial_bank_np(pad_h: int, pad_w: int, levels: int,
                    min_freq: float, max_freq: float) -> np.ndarray:
    """(L, H, W) f32 radial masks, exact math of `PyramidOperations.compute:
    25-87`."""
    fy, fx = _freq_grid(pad_h, pad_w)
    freq = np.sqrt(fx * fx + fy * fy)
    masks = np.zeros((levels, pad_h, pad_w), dtype=np.float64)

    for i in range(levels):
        if i == 0:
            # High-pass: 1 above max_freq, smoothstep ramp over
            # [0.8*max_freq, max_freq] (`:40-53`).
            m = np.where(
                freq > max_freq,
                1.0,
                np.where(
                    freq > max_freq * 0.8,
                    _smoothstep((freq - max_freq * 0.8) / (max_freq * 0.2)),
                    0.0,
                ),
            )
        elif i == levels - 1:
            # Low-pass: 1 below min_freq, ramp down over
            # [min_freq, 1.2*min_freq] (`:54-67`).
            m = np.where(
                freq < min_freq,
                1.0,
                np.where(
                    freq < min_freq * 1.2,
                    1.0 - _smoothstep((freq - min_freq) / (min_freq * 0.2)),
                    0.0,
                ),
            )
        else:
            # Raised-cosine band with geometric center spacing (`:68-84`).
            # Note the reference quirk: for levels == 3 the denominator
            # (levels - 3) is zero -> NaN ratio in HLSL -> every comparison
            # false -> the single mid band is all-zero.  Reproduced.
            denom = levels - 3
            if denom == 0:
                m = np.zeros_like(freq)
            else:
                ratio = (i - 1) / denom
                center = min_freq * (max_freq / min_freq) ** (1.0 - ratio)
                bandwidth = center * 0.5
                lo, hi = center - bandwidth, center + bandwidth
                inside = (freq >= lo) & (freq <= hi)
                t = (freq - lo) / (hi - lo)
                m = np.where(inside, 0.5 * (1.0 + np.cos(2.0 * np.pi * (t - 0.5))), 0.0)
        masks[i] = m
    return masks.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _steerable_bank_np(pad_h: int, pad_w: int, levels: int, min_freq: float,
                       max_freq: float, orientations: int) -> np.ndarray:
    """Extension bank: mid bands split into K angular sectors.

    Masks: (n_masks, H, W) where n_masks = 2 + (levels - 2) * K for
    levels >= 2 (high/low pass stay radial).  Angular windows are
    cos^(2(K-1))(theta - theta_k) normalized across k (partition of unity),
    so summing a mid band's K sector masks recovers the radial band exactly.
    """
    radial = _radial_bank_np(pad_h, pad_w, levels, min_freq, max_freq)
    if orientations <= 1 or levels < 3:
        return radial
    k_or = orientations
    fy, fx = _freq_grid(pad_h, pad_w)
    theta = np.arctan2(np.broadcast_to(fy, radial.shape[1:]),
                       np.broadcast_to(fx, radial.shape[1:]))
    power = 2 * (k_or - 1) if k_or > 1 else 0
    ang = np.empty((k_or,) + radial.shape[1:], dtype=np.float64)
    for k in range(k_or):
        # Orientation bands cover [0, pi) doubled: use cos of (theta - center)
        # so opposite half-planes (Hermitian pairs) share a sector.
        c = np.cos(theta - np.pi * k / k_or)
        ang[k] = np.abs(c) ** power if power else np.ones_like(c)
    total = ang.sum(axis=0)
    total = np.where(total == 0.0, 1.0, total)
    ang /= total

    out = [radial[0]]
    for i in range(1, levels - 1):
        for k in range(k_or):
            out.append(radial[i] * ang[k])
    out.append(radial[-1])
    return np.stack(out).astype(np.float32)


def freq_axes_jnp(pad_h: int, pad_w: int, layout: str = "centered"):
    """(fy (H,1), fx (1,Wk)) f32 normalized frequency axes, on device.

    layout "centered": the DC-centered full grid, exactly the shader's
    fx = x/W - 0.5 (`PyramidOperations.compute:32-37`).
    layout "rfft": natural rfft2 half-spectrum — row ky maps to the
    centered value ((ky + H/2) % H)/H - 0.5 and columns are kx/W for
    kx in [0, W/2]; radii match the centered grid bin-for-bin under the
    Hermitian mirror (all filters are even in k).
    """
    if layout == "centered":
        fy = jnp.arange(pad_h, dtype=jnp.float32) / pad_h - 0.5
        fx = jnp.arange(pad_w, dtype=jnp.float32) / pad_w - 0.5
    elif layout == "rfft":
        ky = (jnp.arange(pad_h, dtype=jnp.int32) + pad_h // 2) % pad_h
        fy = ky.astype(jnp.float32) / pad_h - 0.5
        fx = jnp.arange(pad_w // 2 + 1, dtype=jnp.float32) / pad_w
    else:
        raise ValueError(f"unknown spectrum layout: {layout!r}")
    return fy[:, None], fx[None, :]


def freq_grid_jnp(pad_h: int, pad_w: int, layout: str = "centered") -> jnp.ndarray:
    """Radial frequency grid, computed on device from iota (no multi-MB
    host constants — at 2048^2 an explicit grid is 16 MB that would
    otherwise be embedded in the executable and re-read from HBM every
    frame)."""
    fy, fx = freq_axes_jnp(pad_h, pad_w, layout)
    return jnp.sqrt(fy**2 + fx**2)


def _smoothstep_jnp(t):
    t = jnp.clip(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def radial_level_params(levels: int, min_f: float, max_f: float):
    """THE single source of truth for the radial bank's per-level ramp
    parameters: a tuple of (kind, lo, hi, amplified) per level, kind in
    {"high", "low", "band", "zero"}, exactly as `GeneratePyramidFilters`
    derives them (`PyramidOperations.compute:25-87`: level 0 high-pass
    ramps over [0.8*maxF, maxF]; level L-1 low-pass over [minF, 1.2*minF];
    mid bands raised-cosine over [c/2, 3c/2] with geometric center
    spacing; L=3 hits the NaN-ratio quirk -> all-zero mid mask).

    Every evaluator — the procedural profile below and the sharded
    engine's per-shard masks — derives its lo/hi/center from HERE, so a
    drift in one cannot silently pass the other test families.
    """
    lo_f, hi_f = float(min_f), float(max_f)
    out = []
    for i in range(levels):
        amp = 0 < i < levels - 1
        if i == 0:
            out.append(("high", 0.8 * hi_f, hi_f, False))
        elif i == levels - 1:
            out.append(("low", lo_f, 1.2 * lo_f, False))
        elif levels == 3:
            out.append(("zero", 0.0, 0.0, False))
        else:
            r = (i - 1) / (levels - 3)
            c = lo_f * (hi_f / lo_f) ** (1.0 - r)
            out.append(("band", 0.5 * c, 1.5 * c, amp))
    return tuple(out)


def radial_profile_jnp(freq: jnp.ndarray, i: int, levels: int,
                       min_f: float, max_f: float) -> jnp.ndarray:
    """Level-i mask value as an elementwise function of radius — the
    procedural (fusable, constant-free) form of `_radial_bank_np`.
    Exact same math as `GeneratePyramidFilters`
    (`PyramidOperations.compute:25-87`)."""
    kind, lo, hi, _ = radial_level_params(levels, min_f, max_f)[i]
    if kind == "zero":
        return jnp.zeros_like(freq)
    if kind == "high":
        return jnp.where(
            freq > hi, 1.0,
            jnp.where(freq > lo, _smoothstep_jnp((freq - lo) / (hi - lo)),
                      0.0),
        )
    if kind == "low":
        return jnp.where(
            freq < lo, 1.0,
            jnp.where(freq < hi,
                      1.0 - _smoothstep_jnp((freq - lo) / (hi - lo)), 0.0),
        )
    t = (freq - lo) / (hi - lo)
    band = 0.5 * (1.0 + jnp.cos(2.0 * jnp.pi * (t - 0.5)))
    return jnp.where((freq >= lo) & (freq <= hi), band, 0.0)


def angular_profiles_jnp(pad_h: int, pad_w: int, orientations: int,
                         layout: str = "centered"):
    """K partition-of-unity angular windows, matching `_steerable_bank_np`'s
    sector construction.  The windows are |cos|^even, i.e. invariant under
    theta -> theta + pi, so the rfft half-plane is consistent with the full
    grid's Hermitian mirror."""
    fy, fx = freq_axes_jnp(pad_h, pad_w, layout)
    shape = (fy.shape[0], fx.shape[1])
    theta = jnp.arctan2(
        jnp.broadcast_to(fy, shape), jnp.broadcast_to(fx, shape)
    )
    k_or = orientations
    power = 2 * (k_or - 1) if k_or > 1 else 0
    raw = []
    for k in range(k_or):
        c = jnp.cos(theta - jnp.pi * k / k_or)
        raw.append(jnp.abs(c) ** power if power else jnp.ones_like(c))
    total = sum(raw)
    total = jnp.where(total == 0.0, 1.0, total)
    return [a / total for a in raw]


def procedural_mask_planes(pad_h: int, pad_w: int, cfg, layout: str = "centered"):
    """Yield (mask_plane, amplified) pairs computed on the fly — the
    constant-free generator the fused phase pass iterates over.  Ordering
    matches `filter_bank` + `amplified_level_flags`.  `pad_w` is the full
    spatial width even for layout="rfft" (planes are then (H, W//2+1))."""
    levels = cfg.pyramid_levels
    freq = freq_grid_jnp(pad_h, pad_w, layout)
    use_steer = cfg.orientations > 1 and levels >= 3
    ang = (
        angular_profiles_jnp(pad_h, pad_w, cfg.orientations, layout)
        if use_steer
        else None
    )
    for i in range(levels):
        radial = radial_profile_jnp(
            freq, i, levels, cfg.min_frequency, cfg.max_frequency
        )
        amplified = 0 < i < levels - 1
        if use_steer and amplified:
            for a in ang:
                yield radial * a, True
        else:
            yield radial, amplified


def radial_filter_bank(pad_h, pad_w, levels, min_freq, max_freq) -> jnp.ndarray:
    return jnp.asarray(_radial_bank_np(pad_h, pad_w, levels,
                                       float(min_freq), float(max_freq)))


def steerable_filter_bank(pad_h, pad_w, levels, min_freq, max_freq,
                          orientations) -> jnp.ndarray:
    return jnp.asarray(_steerable_bank_np(pad_h, pad_w, levels,
                                          float(min_freq), float(max_freq),
                                          int(orientations)))


def filter_bank(pad_h: int, pad_w: int, cfg) -> jnp.ndarray:
    """Bank selected by config; (n_masks, H, W) f32."""
    if cfg.orientations > 1:
        return steerable_filter_bank(pad_h, pad_w, cfg.pyramid_levels,
                                     cfg.min_frequency, cfg.max_frequency,
                                     cfg.orientations)
    return radial_filter_bank(pad_h, pad_w, cfg.pyramid_levels,
                              cfg.min_frequency, cfg.max_frequency)


def amplified_level_flags(cfg) -> np.ndarray:
    """Which mask planes get phase amplification.

    The reference skips level 0 (high-pass) and level L-1 (low-pass)
    (`PyramidPhaseDifference.compute:73-77`); with orientations, every sector
    of a mid band is amplified.  Returns (n_masks,) bool.
    """
    levels = cfg.pyramid_levels
    if cfg.orientations > 1 and levels >= 3:
        n_mid = (levels - 2) * cfg.orientations
        return np.array([False] + [True] * n_mid + [False])
    flags = np.zeros(levels, dtype=bool)
    if levels >= 3:
        flags[1:-1] = True
    return flags
