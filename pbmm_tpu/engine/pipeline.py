"""The per-frame pipeline — pure, jittable, config-static.

This is the equivalent of the reference orchestrator's per-frame
sequence (`ProcessFrameWithPyramidDecomposition`,
`MotionMagnificationProcessor.cs:145-206`, and the standard path `:208-232`),
reduced from ~115 GPU dispatches to:

    rgb->yiq -> pad+window          (fused elementwise by XLA)
    1 forward FFT (per processed channel; the reference runs 2 per frame
      because it re-FFTs the previous frame — we cache its spectrum)
    1 fused band/phase pass         (phase.amplify / phase.standard)
    1 inverse FFT
    blur -> combine -> yiq->rgb -> crop   (fused elementwise)

All functions take the config as a static argument and derive geometry from
(static) shapes at trace time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from pbmm_tpu.config import MagnifyConfig
from pbmm_tpu.core.color import rgb_to_yiq, unit_float, yiq_to_rgb
from pbmm_tpu.core.window import (
    Geometry,
    blur_then_crop,
    geometry_for,
    hann2d,
    hann2d_region,
    pad_center,
)
from pbmm_tpu.phase.amplify import (
    phase_delta,
    pyramid_phase_amplify_procedural,
)
from pbmm_tpu.phase.standard import bandpass_weight_map_jnp, standard_phase_amplify
from pbmm_tpu.phase.temporal import TemporalState, temporal_apply, temporal_init
from pbmm_tpu.spectral.fft import (
    fft2_centered,
    ifft2_centered,
    irfft2_half,
    rfft2_half,
)
from pbmm_tpu.spectral.mxu_fft import irfft2_mxu, rfft2_mxu


def _geometry(frame_shape, cfg: MagnifyConfig) -> Geometry:
    h, w = frame_shape[-3], frame_shape[-2]
    return geometry_for(h, w, cfg.pad_mode)


def preprocess(
    frame_rgb: jnp.ndarray, cfg: MagnifyConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(..., H, W, 3) RGB -> (spectra (..., C, Hp, Wp) complex64, YIQ at
    *input* resolution (..., 3, H, W) f32, channels-first).  Leading batch
    dims (frames/videos) batch the FFT directly — no vmap — so XLA sees one
    large transform.  Internals are channels-first so the minor (contiguous)
    dims are the large spatial ones.

    Mirrors Blit(RGBToYIQ) -> PadTexture (+Hann) -> ExtractYChannel ->
    PerformFFT (`MotionMagnificationProcessor.cs:147-155`), with C = 1
    channel (Y) in reference mode or 3 (Y, I, Q) when `chroma="rgb"`.
    Only FFT-bound channels are padded/windowed at full resolution; the
    chroma planes the reference carries through its padded textures are
    reconstructed on the crop region in `postprocess` (identical values —
    the pad border is zeros and the crop discards it).
    """
    with jax.named_scope("pbmm.preprocess"):
        geom = _geometry(frame_rgb.shape, cfg)
        rgb_cf = jnp.moveaxis(unit_float(frame_rgb), -1, -3)
        yiq = rgb_to_yiq(rgb_cf, axis=-3)  # (..., 3, H, W)
        if cfg.chroma == "rgb":
            chans_small = yiq
        else:
            chans_small = yiq[..., 0:1, :, :]  # Y plane only
        padded = pad_center(chans_small, geom)
        win = hann2d(geom.pad_h, geom.pad_w)
        chans = padded * win
        with jax.named_scope("pbmm.fft"):
            if cfg.fft_backend == "mxu":
                spec = rfft2_mxu(chans)
            elif cfg.use_rfft:
                spec = rfft2_half(chans)
            else:
                spec = fft2_centered(chans)
        return spec, yiq


def amplify_spectrum(
    cur_spec: jnp.ndarray,
    prev_spec: jnp.ndarray,
    cfg: MagnifyConfig,
    temporal_state: Optional[TemporalState] = None,
) -> Tuple[jnp.ndarray, Optional[TemporalState]]:
    """Dispatch to the pyramid or standard phase core; threads temporal
    state when an IIR temporal filter is configured."""
    with jax.named_scope("pbmm.phase_amplify"):
        return _amplify_spectrum_impl(cur_spec, prev_spec, cfg, temporal_state)


def _amplify_spectrum_impl(cur_spec, prev_spec, cfg, temporal_state):
    pad_h = cur_spec.shape[-2]
    layout = "rfft" if cfg.use_rfft else "centered"
    # In rfft layout the array is (H, W//2+1); recover the spatial width
    # (square/rect pow-2 padding makes it unambiguous: W = 2*(Wk-1)).
    pad_w = 2 * (cur_spec.shape[-1] - 1) if cfg.use_rfft else cur_spec.shape[-1]

    delta_override = None
    new_state = temporal_state
    if cfg.temporal.mode != "two_frame":
        delta = phase_delta(cur_spec, prev_spec)
        if temporal_state is None:
            temporal_state = temporal_init(delta.shape, cfg.temporal)
        delta_override, new_state = temporal_apply(
            delta, temporal_state, cfg.temporal
        )

    if cfg.mode == "pyramid":
        # Procedural masks: constant-free, fuses into one elementwise pass.
        mod = pyramid_phase_amplify_procedural(
            cur_spec,
            prev_spec,
            cfg,
            delta_override=delta_override,
            layout=layout,
            full_pad_w=pad_w,
        )
    else:
        weight = bandpass_weight_map_jnp(pad_h, pad_w, cfg, layout)
        mod = standard_phase_amplify(
            cur_spec,
            prev_spec,
            weight,
            cfg.phase_scale,
            cfg.magnitude_threshold,
            cfg.magnitude_scale,
            cfg.apply_magnitude_scale,
            delta_override=delta_override,
        )
    return mod, new_state


def reconstruct(mod_spec: jnp.ndarray, cfg: MagnifyConfig,
                pad_w: int) -> jnp.ndarray:
    """Modified spectrum -> real reconstruction at padded resolution:
    PerformIFFT with the reference's magnitude reduction
    (`FFT.compute:143-150`, `MotionMagnificationProcessor.cs:196`)."""
    with jax.named_scope("pbmm.ifft"):
        if cfg.fft_backend == "mxu":
            rec = irfft2_mxu(mod_spec, pad_w)  # real by construction
        elif cfg.use_rfft:
            rec = irfft2_half(mod_spec, pad_w)  # real by construction
        else:
            rec = ifft2_centered(mod_spec)
    if cfg.reconstruct == "magnitude":
        # Reference takes |z| of the complex result (`FFT.compute:143-150`).
        # In the rfft path the result is exactly real, so |z| == |re|; the
        # full path's imaginary residue is fp noise (Hermitian symmetry).
        return jnp.abs(rec)
    return jnp.real(rec) if jnp.iscomplexobj(rec) else rec


def postprocess(
    mod_spec: jnp.ndarray,
    yiq_small: jnp.ndarray,
    cfg: MagnifyConfig,
) -> jnp.ndarray:
    """(..., C, Hp, Wp) modified spectra + (..., 3, H, W) input-resolution
    YIQ -> (..., 3, H, W) RGB (channels-first, already cropped).  Batch
    dims flow through.

    Mirrors PerformIFFT (magnitude reconstruction, `FFT.compute:143-150`) ->
    ApplyAntiAliasing -> CombineYIQChannels -> YIQToRGB (saturate) ->
    CropTexture (`MotionMagnificationProcessor.cs:196-205`).  The blur runs
    at padded resolution (its taps near the crop edge read outside the
    crop, as in the reference); the windowed chroma combine happens on the
    crop region directly (identical values — see `preprocess`).
    """
    h, w = yiq_small.shape[-2:]
    geom = geometry_for(h, w, cfg.pad_mode)
    chans = reconstruct(mod_spec, cfg, geom.pad_w)
    return posttail(chans, yiq_small, cfg)


def posttail(
    chans: jnp.ndarray, yiq_small: jnp.ndarray, cfg: MagnifyConfig
) -> jnp.ndarray:
    """Shared post stage on the real reconstruction: blur -> chroma combine
    -> optional window compensation -> YIQ->RGB (saturate) -> crop."""
    h, w = yiq_small.shape[-2:]
    geom = geometry_for(h, w, cfg.pad_mode)
    with jax.named_scope("pbmm.blur"):
        # Bit-identical to blur-at-padded-res + crop, on ~1/4 the pixels
        # (halo analysis in `core/window.py::blur_then_crop`).
        chans = blur_then_crop(chans, geom, cfg.blur_size)

    with jax.named_scope("pbmm.post"):
        win_c = hann2d_region(geom)
        if cfg.chroma == "rgb":
            out_yiq = chans  # all three planes processed
        else:
            # Processed Y + the *windowed* original I/Q
            # (`CombineYIQChannels.shader:44-57` reads the windowed padded
            # YIQ).
            out_yiq = jnp.concatenate(
                [chans[..., 0:1, :, :], yiq_small[..., 1:, :, :] * win_c],
                axis=-3,
            )

        if cfg.compensate_window:
            out_yiq = out_yiq / jnp.maximum(win_c, 1e-3)

        if cfg.apply_yiq_gains:
            # The reference's (never-enabled) `_YIQADJUSTMENT_ON` channel
            # gains multiply YIQ right before the RGB matrix
            # (`YIQToRGB.shader:65-70`).
            gains = jnp.asarray(cfg.yiq_gains, jnp.float32).reshape((3, 1, 1))
            out_yiq = out_yiq * gains

        return yiq_to_rgb(out_yiq, saturate=True, axis=-3)


def magnify_frame_pair(
    prev_rgb: jnp.ndarray, cur_rgb: jnp.ndarray, cfg: MagnifyConfig
) -> jnp.ndarray:
    """Stateless two-frame magnification, reference-faithful: both frames are
    fully pre-processed (the reference re-FFTs the previous frame every
    frame, `MotionMagnificationProcessor.cs:151-156`).

    Args:
      prev_rgb, cur_rgb: (H, W, 3) f32 RGB in [0, 1].
    Returns (H, W, 3) f32 RGB.
    """
    if not cfg.apply_motion_magnification:
        # Reference bypass (`MotionMagnificationProcessor.cs:126-139`).
        return unit_float(cur_rgb)
    cur_spec, cur_yiq = preprocess(cur_rgb, cfg)
    prev_spec, _ = preprocess(prev_rgb, cfg)
    mod_spec, _ = amplify_spectrum(cur_spec, prev_spec, cfg)
    return jnp.moveaxis(postprocess(mod_spec, cur_yiq, cfg), -3, -1)
