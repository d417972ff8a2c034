"""Four-step (Bailey) FFT — matmul-factored DFTs.

The reference's transform is a radix-2 butterfly ladder of ~29 GPU
dispatches (`Assets/Shaders/FFT.compute`, `MotionMagnificationProcessor.cs:
508-620`).  This module instead factors each N-point DFT as two dense
matmuls, routing the FLOPs to the matrix units:

    n = N2*n1 + n2,  k = k1 + N1*k2        (N = N1*N2, N1 <= 128)
    X[k1 + N1*k2] = sum_n2 W_N^(n2*k1) * W_N2^(n2*k2)
                        * sum_n1 x[N2*n1 + n2] * W_N1^(n1*k1)

    step 1  reshape (N1, N2), transpose -> A[n2, n1]
    step 2  B = A @ DFT_N1                  (matmul, contraction K = N1)
    step 3  C = B * twiddle[n2, k1]         (elementwise)
    step 4  D = DFT_N2^T @ C                (matmul, contraction K = N2)
    step 5  flatten (k2 major, k1 minor) -> natural-order spectrum

Both matmuls run at `Precision.HIGHEST` (full f32: no TF32 or bf16
passes); complex arithmetic is split re/im.  It is an alternative backend
(`fft_backend="mxu"`), off the default path: the default is `jnp.fft`
(cuFFT on the GPU).

Half-spectrum variants (`rfft2_mxu` / `irfft2_mxu`) produce/consume exactly
`jnp.fft.rfft2`'s natural layout, so they are drop-in spectral backends for
the pipeline's `use_rfft=True` path (layout "rfft", same procedural masks):
  - forward rows: the input is real, so step 2 is 2 real matmuls instead of
    4, and only output rows k2 <= N2/2 are computed (half-spectrum crop);
  - inverse rows: Hermitian extension (a flip + conjugate, fused elementwise)
    then a full inverse four-step, keeping the real part.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_PREC = jax.lax.Precision.HIGHEST


def _split(n: int) -> Tuple[int, int]:
    """N1*N2 = n with N1 <= 128 maximal (both powers of two)."""
    if n & (n - 1):
        raise ValueError(f"mxu fft requires power-of-two length, got {n}")
    n1 = min(128, n)
    return n1, n // n1


@functools.lru_cache(maxsize=32)
def _dft_mat(n: int, inverse: bool, scale: float = 1.0):
    """(n, n) DFT matrix as (re, im) f32 numpy pair; W^(jk), sign by dir."""
    k = np.arange(n)
    sign = 2.0 if inverse else -2.0
    ang = sign * np.pi * np.outer(k, k) / n
    return (
        (np.cos(ang) * scale).astype(np.float32),
        (np.sin(ang) * scale).astype(np.float32),
    )


@functools.lru_cache(maxsize=32)
def _twiddle(n: int, inverse: bool):
    """(N2, N1) twiddle table W_N^(n2*k1), f32 re/im."""
    n1, n2 = _split(n)
    sign = 2.0 if inverse else -2.0
    ang = sign * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _mm(a, b):
    return jnp.einsum(
        "...ij,jk->...ik", a, b, precision=_PREC,
        preferred_element_type=jnp.float32,
    )


def _cmm(ar, ai, br, bi):
    """Complex matmul, split re/im (4 real matmuls)."""
    return _mm(ar, br) - _mm(ai, bi), _mm(ar, bi) + _mm(ai, br)


def _four_step_last(
    xr, xi, n: int, inverse: bool, scale: float = 1.0, out_rows: int = 0
):
    """N-point DFT along the last axis of (..., n) split-complex input.

    `xi=None` marks a purely real input (halves step 2).  `out_rows` > 0
    computes only the first `out_rows` values of the k2 (major) output
    coordinate — the half-spectrum crop.  `scale` folds a normalization
    into the step-4 matrix.  Returns (re, im) with last dim
    n if out_rows == 0 else out_rows * N1.
    """
    n1, n2 = _split(n)
    lead = xr.shape[:-1]
    # step 1: n = N2*n1 + n2  ->  A[..., n2, n1]
    xr = jnp.swapaxes(xr.reshape(lead + (n1, n2)), -1, -2)
    if xi is not None:
        xi = jnp.swapaxes(xi.reshape(lead + (n1, n2)), -1, -2)
    w1r, w1i = _dft_mat(n1, inverse)
    w1r, w1i = jnp.asarray(w1r), jnp.asarray(w1i)
    if xi is None:
        br, bi = _mm(xr, w1r), _mm(xr, w1i)  # real input: 2 matmuls
    else:
        br, bi = _cmm(xr, xi, w1r, w1i)
    tr, ti = _twiddle(n, inverse)
    cr = br * tr - bi * ti
    ci = br * ti + bi * tr
    # step 4: contract n2 (the -2 axis): D[k2, k1] = sum_n2 W2[n2,k2]*C[n2,k1]
    w2r, w2i = _dft_mat(n2, inverse, scale)
    if out_rows:
        w2r, w2i = w2r[:, :out_rows], w2i[:, :out_rows]
    w2r, w2i = jnp.asarray(w2r), jnp.asarray(w2i)
    dr = jnp.einsum("...sk,st->...tk", cr, w2r, precision=_PREC,
                    preferred_element_type=jnp.float32) - \
         jnp.einsum("...sk,st->...tk", ci, w2i, precision=_PREC,
                    preferred_element_type=jnp.float32)
    di = jnp.einsum("...sk,st->...tk", cr, w2i, precision=_PREC,
                    preferred_element_type=jnp.float32) + \
         jnp.einsum("...sk,st->...tk", ci, w2r, precision=_PREC,
                    preferred_element_type=jnp.float32)
    rows = out_rows or n2
    return dr.reshape(lead + (rows * n1,)), di.reshape(lead + (rows * n1,))


def _fft_axis(xr, xi, axis: int, inverse: bool, scale: float = 1.0):
    """Full c2c transform along `axis` (moveaxis + four-step + moveback)."""
    xr = jnp.moveaxis(xr, axis, -1)
    xi = None if xi is None else jnp.moveaxis(xi, axis, -1)
    n = xr.shape[-1]
    rr, ri = _four_step_last(xr, xi, n, inverse, scale)
    return jnp.moveaxis(rr, -1, axis), jnp.moveaxis(ri, -1, axis)


def rfft2_mxu(y: jnp.ndarray) -> jnp.ndarray:
    """Real (..., H, W) f32 -> (..., H, W//2+1) complex64, == jnp.fft.rfft2.

    Row stage: real-input four-step along -1 keeping k2 <= N2/2 (then a
    slice to exactly W//2+1 bins).  Column stage: full c2c along -2.
    """
    h, w = y.shape[-2:]
    n1, n2 = _split(w)
    rr, ri = _four_step_last(
        y.astype(jnp.float32), None, w, inverse=False, out_rows=n2 // 2 + 1
    )
    rr, ri = rr[..., : w // 2 + 1], ri[..., : w // 2 + 1]
    rr, ri = _fft_axis(rr, ri, -2, inverse=False)
    return jax.lax.complex(rr, ri)


def irfft2_mxu(spec: jnp.ndarray, pad_w: int) -> jnp.ndarray:
    """Half-spectrum (..., H, K) -> real (..., H, pad_w), == jnp.fft.irfft2.

    Inverse c2c along -2 (1/H folded into step 4), Hermitian extension
    along -1, inverse four-step (1/W folded in), real part.
    """
    h = spec.shape[-2]
    sr, si = jnp.real(spec), jnp.imag(spec)
    sr, si = _fft_axis(sr, si, -2, inverse=True, scale=1.0 / h)
    # Hermitian extension: X[W-k] = conj(X[k]) for k = 1..W/2-1.
    tail = slice(1, pad_w - (pad_w // 2 + 1) + 1)
    fr = jnp.concatenate([sr, sr[..., tail][..., ::-1]], axis=-1)
    fi = jnp.concatenate([si, -si[..., tail][..., ::-1]], axis=-1)
    rr, _ = _four_step_last(fr, fi, pad_w, inverse=True, scale=1.0 / pad_w)
    return rr


def fft2_mxu(y: jnp.ndarray) -> jnp.ndarray:
    """Real (..., H, W) -> full natural-order complex spectrum (c2c path,
    mainly for tests; the pipeline uses the rfft pair above)."""
    rr, ri = _four_step_last(y.astype(jnp.float32), None, y.shape[-1], False)
    rr, ri = _fft_axis(rr, ri, -2, inverse=False)
    return jax.lax.complex(rr, ri)
