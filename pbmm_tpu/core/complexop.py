"""Complex-number helpers shared by the phase kernels and the oracle."""

from __future__ import annotations

import jax.lax as lax
import jax.numpy as jnp

TWO_PI = 6.283185307179586


def wrap_phase(x: jnp.ndarray) -> jnp.ndarray:
    """Wrap to [-pi, pi].

    The reference's `normalize_phase` is a while-loop subtracting/adding 2*pi
    (`PhaseDifferenceComputeShader.compute:63-71`).  For |x| < 2*pi (always
    true of a difference of two atan2 results) a single round-half-even
    correction is exactly equivalent, including the x = ±pi edge cases
    (neither branch of the HLSL loop fires at exactly ±pi, and
    round(±0.5) = 0 here).
    """
    return x - TWO_PI * jnp.round(x / TWO_PI)


def split(z: jnp.ndarray):
    """complex -> (re, im) f32 pair: public jit boundaries and checkpoints
    carry plain float arrays."""
    return jnp.real(z), jnp.imag(z)


def combine(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    """(re, im) f32 pair -> complex64."""
    return lax.complex(re, im)
