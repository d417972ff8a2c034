"""RGB <-> YIQ color transforms.

NTSC matrices as used by the reference fragment shaders
(`Assets/Shaders/RGBToYIQ.shader:46-50`, `Assets/Shaders/YIQToRGB.shader:51-55`),
written out as scalar multiply-adds so XLA fuses the 3x3 transform with the
surrounding elementwise work.

The reference's optional per-channel YIQ gains are inert (the shader keyword
`_YIQADJUSTMENT_ON` is never enabled and the multipliers are fixed at 1.0 —
`YIQToRGB.shader:20,65-70`, `MotionMagnificationProcessor.cs:24-26`), so they
are intentionally not reproduced.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

def unit_float(x: jnp.ndarray) -> jnp.ndarray:
    """Frames to f32 in [0, 1]: uint8 inputs are scaled by 1/255 (real
    video is 8-bit; keeping frames uint8 until they reach the device
    quarters host->device transfer in the streaming drivers, r4), other
    dtypes are cast as-is (the original [0, 1] f32 contract)."""
    if x.dtype == jnp.uint8:
        return x.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    return x.astype(jnp.float32)


# Rows: Y, I, Q.  `RGBToYIQ.shader:46-50`.
RGB_TO_YIQ = np.array(
    [
        [0.299, 0.587, 0.114],
        [0.596, -0.274, -0.322],
        [0.211, -0.523, 0.312],
    ],
    dtype=np.float32,
)

# Rows: R, G, B.  `YIQToRGB.shader:51-55`.  (Not the exact inverse of the
# above — the reference hardcodes both matrices; we reproduce both.)
YIQ_TO_RGB = np.array(
    [
        [1.0, 0.956, 0.621],
        [1.0, -0.272, -0.647],
        [1.0, -1.106, 1.703],
    ],
    dtype=np.float32,
)


def _apply_3x3(x: jnp.ndarray, m: np.ndarray, axis: int = -1) -> jnp.ndarray:
    """Explicit elementwise FMA form of a 3x3 channel transform along `axis`.

    Written out (rather than einsum/dot) deliberately: a dot could be
    lowered to a reduced-precision matrix unit path (TF32 / bf16 inputs)
    and lose ~3 decimal digits; as scalar FMAs it stays full fp32 and fuses
    into the surrounding pad/window arithmetic.
    """
    c0 = jnp.take(x, 0, axis=axis)
    c1 = jnp.take(x, 1, axis=axis)
    c2 = jnp.take(x, 2, axis=axis)
    rows = [
        c0 * float(m[d, 0]) + c1 * float(m[d, 1]) + c2 * float(m[d, 2])
        for d in range(3)
    ]
    return jnp.stack(rows, axis=axis if axis >= 0 else x.ndim + axis)


def rgb_to_yiq(rgb: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """RGB -> YIQ along the channel `axis`."""
    return _apply_3x3(rgb, RGB_TO_YIQ, axis)


def yiq_to_rgb(yiq: jnp.ndarray, saturate: bool = True,
               axis: int = -1) -> jnp.ndarray:
    """YIQ -> RGB along the channel `axis`.

    `saturate=True` applies the [0,1] clamp the reference performs after the
    matrix multiply (`YIQToRGB.shader:76`).
    """
    rgb = _apply_3x3(yiq, YIQ_TO_RGB, axis)
    if saturate:
        rgb = jnp.clip(rgb, 0.0, 1.0)
    return rgb
