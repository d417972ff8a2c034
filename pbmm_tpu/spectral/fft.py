"""Centered 2D FFT/IFFT — the spectral core.

The reference implements a hand-sequenced radix-2 DIT FFT as ~29 GPU
dispatches per transform (`Assets/Shaders/FFT.compute`, driven by
`MotionMagnificationProcessor.cs:508-620`).  Here the idiomatic equivalent
is XLA's native FFT op (cuFFT on an NVIDIA GPU), a tuned library
transform — re-implementing radix-2 butterfly *passes* one-at-a-time
would round-trip HBM log2(N) times and be strictly slower (SURVEY.md §7.3).

DC-centering conventions (proved equivalent for even N, which power-of-two
padding guarantees):

- The reference pre-modulates by (-1)^(x+y) before the forward transform
  (`FFT.compute:175-189` `CenterComplex`), which equals `fftshift` of the
  unmodulated spectrum.
- Its inverse is conj -> forward FFT -> conj -> /(W*H) -> (-1)^(x+y)
  (`MotionMagnificationProcessor.cs:563-616`), which equals
  `ifft2(ifftshift(.))` exactly.
"""

from __future__ import annotations

import jax.numpy as jnp


def _collapsed(fn, x):
    """Run `fn` with leading batch dims collapsed to one.

    Works around an XLA CPU fft-thunk RET_CHECK
    (`LayoutUtil::IsMonotonicWithDim0Major`) hit when a >3-D FFT operand
    inherits a non-dim0-major layout under sharding; the reshape pins a
    standard layout.  On a dense row-major array the reshape is free.
    """
    if x.ndim <= 3:
        return fn(x)
    shape = x.shape
    out = fn(x.reshape((-1,) + shape[-2:]))
    # Output spatial dims may differ from the input's (rfft half-spectrum).
    return out.reshape(shape[:-2] + out.shape[-2:])


def fft2_centered(y: jnp.ndarray) -> jnp.ndarray:
    """Real (..., H, W) f32 -> DC-centered complex64 spectrum.

    Equals the reference chain ConvertTexToComplex -> CenterComplex ->
    row/col radix-2 passes (`MotionMagnificationProcessor.cs:508-553`).
    """
    spec = _collapsed(jnp.fft.fft2, y.astype(jnp.complex64))
    return jnp.fft.fftshift(spec, axes=(-2, -1))


def ifft2_centered(spec: jnp.ndarray) -> jnp.ndarray:
    """DC-centered complex spectrum -> complex spatial-domain result.

    Equals the reference chain conj -> FFT -> conj -> divide -> center
    (`MotionMagnificationProcessor.cs:563-616`).  The caller decides between
    magnitude (reference behavior, `FFT.compute:143-150`) and real part.
    """
    return _collapsed(
        jnp.fft.ifft2, jnp.fft.ifftshift(spec, axes=(-2, -1))
    )


def rfft2_half(y: jnp.ndarray) -> jnp.ndarray:
    """Real (..., H, W) f32 -> half-spectrum (..., H, W//2 + 1) complex64 in
    natural (unshifted) rfft layout.

    The half-spectrum pipeline is mathematically identical to the full one
    for real inputs: the reference's phase modification preserves Hermitian
    symmetry (magnitude gates are even in k, the wrapped delta is odd, and
    all masks/weights are radial i.e. even), so the full spectrum is always
    the Hermitian extension of this half — at ~half the FFT and phase-pass
    cost.  Exposed behind `MagnifyConfig.use_rfft` (SURVEY.md §7.3 fallback
    contract: both paths behind one interface, benchmarked honestly).
    """
    return _collapsed(jnp.fft.rfft2, y)


def irfft2_half(spec: jnp.ndarray, pad_w: int) -> jnp.ndarray:
    """Half-spectrum -> real spatial-domain result (..., H, W)."""
    return _collapsed(
        lambda s: jnp.fft.irfft2(s, s=(s.shape[-2], pad_w)), spec
    )
