"""Pyramid-mode phase-difference amplification — the fused formulation.

Reference semantics (per band i, per bin):
    cur_i = cur * m_i; prev_i = prev * m_i          (`PyramidOperations.compute:90-108`)
    if i == 0 or i == L-1:               out_i = cur_i   # pass-through
    elif |cur_i| < tau or |prev_i| < tau: out_i = cur_i  # magnitude gate
    else: out_i = cur_i * exp(1j * phase_scale * wrap(arg(prev_i) - arg(cur_i)))
                                         (`PyramidPhaseDifference.compute:58-101`)
    result = sum_i out_i                 (`PyramidOperations.compute:111-128`)

Fusion: every mask m_i is real and non-negative, so
arg(z * m_i) = arg(z) wherever m_i > 0 — the per-band phase delta is
*independent of the band*.  The whole L-band loop therefore collapses to a
single elementwise pass:

    delta = wrap(arg(prev) - arg(cur))            # computed once per bin
    amp_i = amplified(i) & (|cur|*m_i >= tau) & (|prev|*m_i >= tau)
    E = sum_i m_i * amp_i;  P = (sum_i m_i) - E
    result = cur * (P + E * exp(1j * phase_scale * delta))

This replaces the reference's 10 filter applies + 5 phase kernels + 6
accumulator dispatches per frame (SURVEY.md §3.2) with one elementwise pass,
and is exactly equal in infinite precision (`pyramid_phase_amplify_naive`
reproduces the literal band loop; tests assert agreement).  Where m_i = 0 both
formulations contribute cur * 0.

An optional temporal filter transforms the raw delta stream before
amplification (extension; `temporal.py`).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pbmm_tpu.core.complexop import wrap_phase


def pyramid_phase_amplify(
    cur: jnp.ndarray,
    prev: jnp.ndarray,
    masks: jnp.ndarray,
    amp_flags: np.ndarray,
    phase_scale: float,
    magnitude_threshold: float,
    delta_override: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Fused band decomposition + phase amplification + collapse.

    Args:
      cur, prev: DC-centered complex64 spectra (..., H, W).
      masks: (n_masks, H, W) f32 filter bank.
      amp_flags: (n_masks,) bool — which planes are amplified
        (False for high/low-pass, `PyramidPhaseDifference.compute:73-77`).
      delta_override: optional pre-filtered phase delta to amplify in place
        of the raw two-frame delta (temporal filtering).

    Returns the collapsed modified spectrum (..., H, W) complex64.
    """
    cur_mag = jnp.abs(cur)
    prev_mag = jnp.abs(prev)
    delta = wrap_phase(jnp.angle(prev) - jnp.angle(cur))
    if delta_override is not None:
        delta = delta_override

    flags = jnp.asarray(amp_flags)
    # Gate per band: both filtered magnitudes >= tau
    # (`PyramidPhaseDifference.compute:82-86`).  |z * m| == |z| * m for m >= 0.
    shape = (masks.shape[0],) + (1,) * (cur.ndim - 2) + cur.shape[-2:]
    m = masks.reshape(shape)
    amp = (
        flags.reshape((-1,) + (1,) * (cur.ndim))
        & (cur_mag[None] * m >= magnitude_threshold)
        & (prev_mag[None] * m >= magnitude_threshold)
    )
    mask_total = jnp.sum(m * jnp.ones_like(cur_mag)[None], axis=0)
    amplified_sum = jnp.sum(jnp.where(amp, m, 0.0), axis=0)
    pass_sum = mask_total - amplified_sum

    rot = jnp.exp(1j * (phase_scale * delta).astype(jnp.complex64))
    return cur * (pass_sum + amplified_sum * rot)


def phase_delta(cur: jnp.ndarray, prev: jnp.ndarray) -> jnp.ndarray:
    """wrap(arg(prev) - arg(cur)) in one atan2: arg(prev * conj(cur)).

    atan2 of the product is already wrapped to [-pi, pi] and equals the
    reference's two-atan2-plus-while-loop form
    (`PhaseDifferenceComputeShader.compute:63-71,152-156`) everywhere except
    fp-rounding at the ±pi knife edge.
    """
    return jnp.angle(prev * jnp.conj(cur))


def _unit_rotation(cur: jnp.ndarray, prev: jnp.ndarray) -> jnp.ndarray:
    """e^{i*delta} without trig: normalize prev * conj(cur) to unit modulus.

    Zero-modulus bins produce 0 (not NaN); they are always magnitude-gated
    to pass-through, so the value is never consumed.
    """
    r = prev * jnp.conj(cur)
    m2 = jnp.real(r) ** 2 + jnp.imag(r) ** 2
    inv = jnp.where(m2 > 0, jax.lax.rsqrt(jnp.maximum(m2, 1e-38)), 0.0)
    return r * inv.astype(jnp.complex64)


def _integer_power(z: jnp.ndarray, n: int) -> jnp.ndarray:
    """z**n by square-and-multiply (n >= 0, static)."""
    result = None
    base = z
    while n > 0:
        if n & 1:
            result = base if result is None else result * base
        base = base * base
        n >>= 1
    return result if result is not None else jnp.ones_like(z)


def rotation_term(
    cur: jnp.ndarray,
    prev: jnp.ndarray,
    phase_scale: float,
    delta_override: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """exp(1j * phase_scale * wrap(arg(prev) - arg(cur))) — trig-free when
    phase_scale is a (small) integer: e^{i*s*(delta - 2*pi*k)} = e^{i*s*delta}
    for integer s, so (prev*conj(cur)/|.|)^s is exact, replacing
    atan2 + sincos (expensive transcendentals) with one rsqrt and
    a handful of complex multiplies."""
    s = float(phase_scale)
    if delta_override is None and s.is_integer() and 0 <= s <= 64:
        return _integer_power(_unit_rotation(cur, prev), int(s))
    delta = phase_delta(cur, prev) if delta_override is None else delta_override
    return jnp.exp(1j * (s * delta).astype(jnp.complex64))


def pyramid_phase_amplify_procedural(
    cur: jnp.ndarray,
    prev: jnp.ndarray,
    cfg,
    delta_override: Optional[jnp.ndarray] = None,
    layout: str = "centered",
    full_pad_w: Optional[int] = None,
) -> jnp.ndarray:
    """The production fused pass: identical math to
    `pyramid_phase_amplify`, but mask values are computed per-pixel from the
    radial/angular profiles instead of read from (L, H, W) planes.

    Why: at the reference's 2048^2 working set, explicit masks are 84 MB of
    constants baked into the executable and re-read from HBM every frame;
    the profiles are a handful of elementwise ops that XLA fuses into the
    pass, so per-frame HBM traffic drops to the spectra themselves
    (SURVEY.md §7.3 "fusing ... the band multiply to avoid HBM
    round-trips")."""
    from pbmm_tpu.pyramid.filters import procedural_mask_planes

    pad_h = cur.shape[-2]
    pad_w = full_pad_w if layout == "rfft" else cur.shape[-1]
    cur_mag = jnp.abs(cur)
    prev_mag = jnp.abs(prev)

    tau = cfg.magnitude_threshold
    total = jnp.zeros(cur.shape[-2:], jnp.float32)
    amped = jnp.zeros_like(cur_mag)
    for m, amplified in procedural_mask_planes(pad_h, pad_w, cfg, layout):
        total = total + m
        if amplified:
            gate = (cur_mag * m >= tau) & (prev_mag * m >= tau)
            amped = amped + jnp.where(gate, m, 0.0)

    rot = rotation_term(cur, prev, cfg.phase_scale, delta_override)
    return cur * ((total - amped) + amped * rot)


def pyramid_phase_amplify_naive(
    cur: jnp.ndarray,
    prev: jnp.ndarray,
    masks: jnp.ndarray,
    amp_flags: np.ndarray,
    phase_scale: float,
    magnitude_threshold: float,
) -> jnp.ndarray:
    """Literal transcription of the reference band loop (test oracle for the
    fused form): ApplyPyramidFilter -> ProcessPyramidPhaseDifference ->
    AccumulatePyramidLevel per band."""
    acc = jnp.zeros_like(cur)
    for i in range(masks.shape[0]):
        m = masks[i]
        cur_i = cur * m
        prev_i = prev * m
        if not bool(amp_flags[i]):
            acc = acc + cur_i
            continue
        gate = (jnp.abs(cur_i) < magnitude_threshold) | (
            jnp.abs(prev_i) < magnitude_threshold
        )
        delta = wrap_phase(jnp.angle(prev_i) - jnp.angle(cur_i))
        rotated = cur_i * jnp.exp(1j * (phase_scale * delta).astype(jnp.complex64))
        acc = acc + jnp.where(gate, cur_i, rotated)
    return acc
