"""Padding, Hann windowing, cropping and the separable "anti-aliasing" blur.

These replace the reference's raster passes (`Hidden/WindowingFunction`,
`Hidden/GaussianBlur`, the GL-quad pad/crop in
`MotionMagnificationProcessor.cs:358-410`) with trivial vectorized array math —
raster passes exist in the reference only because Unity makes full-screen math
easiest as fragment shaders (SURVEY.md §1).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np


class Geometry(NamedTuple):
    """Static pad/crop geometry. All ints, derived from shapes at trace time."""

    in_h: int
    in_w: int
    pad_h: int
    pad_w: int
    y0: int  # top offset of the image inside the padded frame
    x0: int  # left offset


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def geometry_for(in_h: int, in_w: int, pad_mode: str = "square_pow2") -> Geometry:
    """Pad-size calculation.

    "square_pow2" is the reference rule: N = NextPowerOfTwo(max(w, h)) for
    both axes (`MotionMagnificationProcessor.cs:298-302`; the square
    constraint exists there only because the FFT driver shares one
    bitrev/twiddle table between axes, `:531-535`).  "rect_pow2" pads each
    axis independently, a perf option per SURVEY.md §7.3.  Honest scope
    note: at 1080p it degenerates to the square geometry
    (NextPowerOfTwo(1080) = 2048 = NextPowerOfTwo(1920)); the win appears
    at resolutions whose height crosses a lower power of two — e.g. 720p:
    1280x720 -> 2048x1024 instead of 2048x2048, 2x fewer pixels (bench.py
    publishes the measured trade).
    """
    if pad_mode == "square_pow2":
        n = _next_pow2(max(in_h, in_w))
        pad_h = pad_w = n
    elif pad_mode == "rect_pow2":
        pad_h, pad_w = _next_pow2(in_h), _next_pow2(in_w)
    elif pad_mode == "tight":
        # Height padded to the smallest multiple of 128 — 1080p pads to
        # 1152 = 9*128 instead of 2048, 0.5625x the pixels; the FFT
        # library takes the mixed-radix height directly.  The width keeps
        # the pow-2 rule.
        pad_h = max(-(-in_h // 128) * 128, 128)
        pad_w = _next_pow2(in_w)
    else:
        raise ValueError(f"unknown pad_mode: {pad_mode!r}")
    # Center placement; the reference's GL quad offsets are
    # (1 - w/N)/2 in uv, i.e. (N - w)/2 pixels (`:358-384`).
    return Geometry(in_h, in_w, pad_h, pad_w, (pad_h - in_h) // 2, (pad_w - in_w) // 2)


def hann2d_region(geom: Geometry) -> jnp.ndarray:
    """The padded-frame Hann window restricted to the crop region,
    (in_h, in_w) f32 — lets the pipeline window the chroma planes at input
    resolution instead of materializing full padded chroma planes
    (at 1080p that is ~350 MB/call of avoided HBM traffic)."""
    iy = (jnp.arange(geom.in_h, dtype=jnp.float32) + geom.y0 + 0.5) / geom.pad_h
    ix = (jnp.arange(geom.in_w, dtype=jnp.float32) + geom.x0 + 0.5) / geom.pad_w
    wy = 0.5 * (1.0 - jnp.cos(2.0 * jnp.pi * iy))
    wx = 0.5 * (1.0 - jnp.cos(2.0 * jnp.pi * ix))
    return wy[:, None] * wx[None, :]


def hann2d(pad_h: int, pad_w: int) -> jnp.ndarray:
    """2D separable Hann window over the padded frame, (pad_h, pad_w) f32.

    The reference windows with uv = pixel-center texture coordinates:
    w(u) = 0.5*(1 - cos(2*pi*u)), u = (i + 0.5)/N, separable in x and y
    (`WindowingFunction.shader:46-70`).  Computed on device from iota (a
    2048^2 constant would be 16 MB baked into every executable).
    """
    iy = (jnp.arange(pad_h, dtype=jnp.float32) + 0.5) / pad_h
    ix = (jnp.arange(pad_w, dtype=jnp.float32) + 0.5) / pad_w
    wy = 0.5 * (1.0 - jnp.cos(2.0 * jnp.pi * iy))
    wx = 0.5 * (1.0 - jnp.cos(2.0 * jnp.pi * ix))
    return wy[:, None] * wx[None, :]


def pad_center(img: jnp.ndarray, geom: Geometry) -> jnp.ndarray:
    """Center-pad the last two (spatial) dims with zeros ("black borders",
    `MotionMagnificationProcessor.cs:365`): (..., H, W) -> (..., Hp, Wp).

    Channels ride in leading dims — the pipeline is channels-first
    internally so the minor (contiguous) dims are the large spatial ones
    and every plane is a dense 2D array for the FFT.
    """
    pads = [(0, 0)] * (img.ndim - 2) + [
        (geom.y0, geom.pad_h - geom.in_h - geom.y0),
        (geom.x0, geom.pad_w - geom.in_w - geom.x0),
    ]
    return jnp.pad(img, pads)


def crop_center(img: jnp.ndarray, geom: Geometry) -> jnp.ndarray:
    """Center-crop the last two dims back to (..., H, W)
    (`MotionMagnificationProcessor.cs:386-410`; the reference's crop quad
    gathers exact source texel centers)."""
    return img[
        ..., geom.y0 : geom.y0 + geom.in_h, geom.x0 : geom.x0 + geom.in_w
    ]


@functools.lru_cache(maxsize=8)
def blur_taps(blur_size: float = 0.5) -> Tuple[float, ...]:
    """Discrete equivalent of the reference's bilinear-sampled 5-tap blur.

    The shader samples at offsets {0, ±1.3846153846*s, ±3.2307692308*s}
    texels with weights {0.2270270270, 0.3162162162, 0.0702702703}
    (`GaussianBlur.shader:52-57`) using hardware bilinear filtering, so each
    fractional tap splats onto its two neighboring texels.  At the
    reference's fixed _BlurSize = 0.5 (`MotionMagnificationProcessor.cs:427`)
    this reduces *exactly* to a discrete symmetric 5-tap kernel, derived here
    from the same constants rather than hardcoded.
    """
    offs = np.array([1.3846153846, 3.2307692308]) * blur_size
    wts = np.array([0.3162162162, 0.0702702703])
    radius = int(np.ceil(offs.max()))
    taps = np.zeros(2 * radius + 1, dtype=np.float64)
    taps[radius] = 0.2270270270
    for off, w in zip(offs, wts):
        lo = int(np.floor(off))
        frac = off - lo
        for sign in (+1, -1):
            taps[radius + sign * lo] += w * (1.0 - frac)
            taps[radius + sign * (lo + 1)] += w * frac
    return tuple(float(t) for t in taps)


def _blur_axis(img: jnp.ndarray, taps: Tuple[float, ...], axis: int) -> jnp.ndarray:
    """Apply a symmetric 1D kernel along `axis` with edge-replicate padding
    (Unity RenderTextures default to clamp wrap mode, which the shader's
    out-of-range bilinear fetches hit at the borders)."""
    radius = (len(taps) - 1) // 2
    pads = [(0, 0)] * img.ndim
    pads[axis] = (radius, radius)
    padded = jnp.pad(img, pads, mode="edge")
    n = img.shape[axis]
    out = None
    for k, t in enumerate(taps):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(k, k + n)
        term = padded[tuple(sl)] * t
        out = term if out is None else out + term
    return out


def gaussian_blur5(img: jnp.ndarray, blur_size: float = 0.5,
                   axes: Tuple[int, int] = (-2, -1)) -> jnp.ndarray:
    """Separable blur, horizontal then vertical like the reference
    (`MotionMagnificationProcessor.cs:423-433`)."""
    taps = blur_taps(blur_size)
    img = _blur_axis(img, taps, axes[1])
    img = _blur_axis(img, taps, axes[0])
    return img


def blur_then_crop(img: jnp.ndarray, geom: Geometry,
                   blur_size: float = 0.5) -> jnp.ndarray:
    """`crop_center(gaussian_blur5(img))`, computed on the crop region only.

    The reference blurs the full padded texture and then crops
    (`MotionMagnificationProcessor.cs:197,200-205`); only the crop region
    of the blurred image survives, and each output pixel depends on inputs
    at most `radius` texels away.  Cropping first with a `radius`-pixel
    halo and blurring that sub-region is therefore bit-identical while
    doing ~(pad/(crop+4))^2 x less work (2048^2 -> 1084x1924 at 1080p):

    - full-halo side: every tap of every kept pixel reads real sub-region
      data (halo rows/cols absorb the dependency), so the sub-region's
      edge-replicate padding is never consulted for kept outputs;
    - clipped-halo side (crop touches the pad border): the sub-region edge
      IS the padded-image edge, so edge-replicate reproduces the
      reference's clamp sampling exactly.
    """
    radius = (len(blur_taps(blur_size)) - 1) // 2
    hy0 = min(radius, geom.y0)
    hx0 = min(radius, geom.x0)
    hy1 = min(radius, geom.pad_h - geom.y0 - geom.in_h)
    hx1 = min(radius, geom.pad_w - geom.x0 - geom.in_w)
    sub = img[
        ...,
        geom.y0 - hy0 : geom.y0 + geom.in_h + hy1,
        geom.x0 - hx0 : geom.x0 + geom.in_w + hx1,
    ]
    sub = gaussian_blur5(sub, blur_size)
    return sub[..., hy0 : hy0 + geom.in_h, hx0 : hx0 + geom.in_w]
