"""Device-side YCbCr -> RGB decode for the streaming ingestion path.

The pure-numpy y4m reader (`io.y4m`) decodes on the host: chroma
upsample + BT.601 matrix in f32, then 12 bytes/px of RGB cross
host->device.  This module moves the decode onto the device: the raw
uint8 planes transfer (~1.5 bytes/px for C420) and one jitted XLA
computation performs the identical nearest-neighbor upsample and
limited-range BT.601 conversion (`io/y4m.py::_ycbcr_to_rgb` /
`_upsample`, same formulas in the same order — parity pinned by
tests/test_y4m.py).

For the reference's contract the output is full-range [0, 1] f32 RGB,
exactly what `magnify_video` ingests; the decode fuses into the
pipeline's pre stage under jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_KR, _KG, _KB = 0.299, 0.587, 0.114


@functools.partial(jax.jit, static_argnames=("h", "w"))
def ycbcr_planes_to_rgb(y_u8: jnp.ndarray, cb_u8: jnp.ndarray,
                        cr_u8: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """(T, H, W) u8 luma + (T, ch, cw) u8 chroma planes -> (T, H, W, 3)
    f32 RGB in [0, 1].

    Chroma is nearest-neighbor upsampled by the same integer factors the
    host reader uses (`_upsample`: repeat by h//ch, w//cw then crop);
    color math is the limited-range BT.601 of `_ycbcr_to_rgb`.
    """
    t, ch, cw = cb_u8.shape

    def up(p):
        ry = max(h // ch, 1)
        rx = max(w // cw, 1)
        if ry > 1:
            p = jnp.repeat(p, ry, axis=1)
        if rx > 1:
            p = jnp.repeat(p, rx, axis=2)
        return p[:, :h, :w]

    yf = (y_u8.astype(jnp.float32) - 16.0) / 219.0
    pb = (up(cb_u8).astype(jnp.float32) - 128.0) / 224.0
    pr = (up(cr_u8).astype(jnp.float32) - 128.0) / 224.0
    r = yf + 2.0 * (1.0 - _KR) * pr
    b = yf + 2.0 * (1.0 - _KB) * pb
    g = (yf - _KR * r - _KB * b) / _KG
    return jnp.clip(jnp.stack([r, g, b], axis=-1), 0.0, 1.0)


@functools.partial(jax.jit, static_argnames=("h", "w"))
def ycbcr_planes_to_rgb_planar_u8(y_u8: jnp.ndarray, cb_u8: jnp.ndarray,
                                  cr_u8: jnp.ndarray, h: int,
                                  w: int) -> jnp.ndarray:
    """(T, H, W) u8 luma + (T, ch, cw) u8 chroma -> (T, 3, H, W) uint8
    planar RGB: a quarter of the f32 bytes on the way into
    `magnify_video`, which converts to f32 on device.  Values are the f32 decode rounded once to 8 bits — exactly
    what every rgb24 video decoder emits (the y4m source was 8-bit to
    begin with)."""
    rgb = ycbcr_planes_to_rgb(y_u8, cb_u8, cr_u8, h, w)  # (T, H, W, 3)
    planar = jnp.moveaxis(rgb, -1, 1)
    return jnp.round(planar * 255.0).astype(jnp.uint8)
