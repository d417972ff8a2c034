"""Frozen, hashable configuration for the magnification pipeline.

This is the analog of the reference's Unity-inspector parameter
surface (`Assets/Scripts/MotionMagnificationProcessor.cs:7-47`): a frozen
dataclass passed as a *static* jit argument, so any change retraces cleanly —
the analog of `OnValidate` regenerating the filter masks
(`MotionMagnificationProcessor.cs:78-88`).

Defaults mirror the reference script defaults; the demo scene's serialized
overrides (`Assets/Scenes/SampleScene.unity:709-719`: phase_scale=1,
high_freq_cutoff=0.3, filter_steepness=2) are available via
`MagnifyConfig.scene_defaults()`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TemporalConfig:
    """Temporal filtering of per-bin phase deltas across frames.

    The reference's temporal extent is exactly two frames: the phase delta
    against the immediately previous frame (`MotionMagnificationProcessor.cs:
    56-57,111-117,142`), i.e. a [1] FIR on the delta stream — mode
    "two_frame" here.  Mode "iir_bandpass" is the strictly-more-general
    streaming extension (BASELINE.json configs 2-5): the delta stream is
    band-passed with a difference of two first-order low-pass IIRs (the
    classic realtime-Eulerian-video-magnification filter), carried as scan
    state, before amplification.
    """

    mode: str = "two_frame"  # "two_frame" | "iir_bandpass"
    low_hz: float = 0.4
    high_hz: float = 3.0
    fps: float = 30.0

    def __post_init__(self):
        if self.mode not in ("two_frame", "iir_bandpass"):
            raise ValueError(f"unknown temporal mode: {self.mode!r}")
        if self.mode == "iir_bandpass" and not (0.0 < self.low_hz < self.high_hz):
            raise ValueError("need 0 < low_hz < high_hz")

    def smoothing_factors(self) -> Tuple[float, float]:
        """First-order low-pass smoothing factors (r_high, r_low).

        y += r * (x - y), r = 1 - exp(-2*pi*f/fps); band = y_high - y_low.
        """
        import math

        r_hi = 1.0 - math.exp(-2.0 * math.pi * self.high_hz / self.fps)
        r_lo = 1.0 - math.exp(-2.0 * math.pi * self.low_hz / self.fps)
        return r_hi, r_lo


@dataclasses.dataclass(frozen=True)
class MagnifyConfig:
    """All pipeline parameters. Hashable -> usable as a static jit argument.

    Parameter provenance (reference file:line):
      mode                 pyramid vs standard path select
                           (`MotionMagnificationProcessor.cs:126-136`)
      phase_scale          `MotionMagnificationProcessor.cs:30` (default 10;
                           scene override 1, `SampleScene.unity:715`)
      pyramid_levels       `:19` (default 5)
      min/max_frequency    `:20-21` (0.05 / 0.45)
      magnitude_threshold  `:31` (0.01)
      magnitude_scale      `:32` — computed but never applied by the reference
                           (`PhaseDifferenceComputeShader.compute:169-178`);
                           only used here when `apply_magnitude_scale=True`
      apply_bandpass .. edge_enhancement   standard-mode spatial weighting
                           (`:35-43`, `PhaseDifferenceComputeShader.compute:
                           88-122`)
      blur_size            the "anti-aliasing" separable Gaussian's _BlurSize
                           (`:427-431`, fixed 0.5 in the reference)

    Quirk switches (reference behaviors that are arguably bugs — kept
    reproducible but individually overridable, per SURVEY.md §7.0):
      reconstruct          "magnitude": IFFT output is |z| as in
                           `FFT.compute:143-150` (negatives rectified);
                           "real": take the real part instead.
      cache_prev_spectrum  the reference re-FFTs the previous frame every
                           frame (`MotionMagnificationProcessor.cs:151-156`);
                           caching its spectrum is mathematically identical
                           and halves FFT work. Default True.
      compensate_window    the reference never divides the Hann window back
                           out (output is vignetted, SURVEY.md §7.0).
                           Default False = reference behavior.
    """

    # --- mode select ---
    mode: str = "pyramid"  # "pyramid" | "standard"
    apply_motion_magnification: bool = True  # False = full passthrough, the
    #   reference's applyMotionMagnification=false bypass: OnRenderImage
    #   blits source->destination untouched while still tracking the
    #   previous frame (`MotionMagnificationProcessor.cs:13,126-139,142`)

    # --- shared phase parameters ---
    phase_scale: float = 10.0
    magnitude_threshold: float = 0.01
    magnitude_scale: float = 1.0
    apply_magnitude_scale: bool = False

    # --- pyramid mode ---
    pyramid_levels: int = 5
    min_frequency: float = 0.05
    max_frequency: float = 0.45
    orientations: int = 0  # 0 = radial-only (reference); K>0 adds K angular
    #                        steerable sectors per mid band (extension)

    # --- standard mode spatial bandpass of the phase delta ---
    apply_bandpass: bool = True
    low_freq_cutoff: float = 0.05
    high_freq_cutoff: float = 0.4
    filter_steepness: float = 3.0
    motion_sensitivity: float = 1.5
    enhance_edges: bool = True
    edge_enhancement: float = 0.8

    # --- pre/post processing ---
    blur_size: float = 0.5
    pad_mode: str = "square_pow2"  # "square_pow2" (reference) | "rect_pow2"
    #   | "tight" (height to the next 128 multiple — 1080p -> 1152x2048,
    #   0.56x the reference's pixels)
    chroma: str = "y_only"  # "y_only" (reference) | "rgb" (magnify all planes)
    output_layout: str = "interleaved"  # "interleaved" ((T, H, W, 3) f32,
    #   the reference's texture contract) | "planar" ((T, 3, H, W) f32)
    #   | "planar_u8" (same, quantized to uint8 — 1/4 the output bytes;
    #   the y4m/display contract)

    # --- temporal filtering ---
    temporal: TemporalConfig = dataclasses.field(default_factory=TemporalConfig)

    # --- quirk switches (defaults = reference behavior) ---
    reconstruct: str = "magnitude"  # "magnitude" | "real"
    cache_prev_spectrum: bool = True
    compensate_window: bool = False
    yiq_gains: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    apply_yiq_gains: bool = False  # the reference's per-channel YIQ
    #   multipliers are INERT: the `_YIQADJUSTMENT_ON` shader keyword is
    #   never enabled and the multipliers are fixed at 1.0
    #   (`YIQToRGB.shader:20,65-70`, `MotionMagnificationProcessor.cs:
    #   24-26,200-204`).  Default False reproduces that; True applies the
    #   gains to the combined YIQ right before the RGB matrix, exactly
    #   where the shader would.

    # --- backend ---
    fft_backend: str = "xla"  # "xla" (jnp.fft: cuFFT on the GPU) | "mxu"
    #   (four-step matmul-factored DFT, natural rfft layout —
    #   spectral/mxu_fft.py; off the default path, kept for comparison).
    use_rfft: bool = True  # half-spectrum (rfft2/irfft2) spectral path.
    #   Mathematically identical for real inputs: the phase modification
    #   preserves Hermitian symmetry (gates even in k, wrapped delta odd,
    #   masks/weights radial), so the full spectrum is always the Hermitian
    #   extension of the half — at ~half the FFT + phase-pass cost.  Set
    #   False for the literal full-spectrum chain.

    def __post_init__(self):
        if self.mode not in ("pyramid", "standard"):
            raise ValueError(f"unknown mode: {self.mode!r}")
        if self.reconstruct not in ("magnitude", "real"):
            raise ValueError(f"unknown reconstruct: {self.reconstruct!r}")
        if self.pad_mode not in ("square_pow2", "rect_pow2", "tight"):
            raise ValueError(f"unknown pad_mode: {self.pad_mode!r}")
        if self.pad_mode == "tight" and self.fft_backend != "xla":
            raise ValueError(
                "pad_mode='tight' needs a non-pow2-capable backend: "
                "fft_backend='xla'"
            )
        if self.chroma not in ("y_only", "rgb"):
            raise ValueError(f"unknown chroma: {self.chroma!r}")
        if self.output_layout not in ("interleaved", "planar", "planar_u8"):
            raise ValueError(f"unknown output_layout: {self.output_layout!r}")
        if self.pyramid_levels < 1:
            raise ValueError("pyramid_levels must be >= 1")
        if self.orientations < 0:
            raise ValueError("orientations must be >= 0")
        if self.fft_backend not in ("xla", "mxu"):
            raise ValueError(f"unknown fft_backend: {self.fft_backend!r}")
        if self.fft_backend == "mxu" and not self.use_rfft:
            raise ValueError(
                "fft_backend='mxu' requires use_rfft=True (four-step matmul "
                "FFT produces the natural half-spectrum layout)"
            )

    @staticmethod
    def scene_defaults() -> "MagnifyConfig":
        """The demo scene's serialized overrides (`SampleScene.unity:709-719`)."""
        return MagnifyConfig(
            phase_scale=1.0, high_freq_cutoff=0.3, filter_steepness=2.0
        )

    def replace(self, **kw) -> "MagnifyConfig":
        return dataclasses.replace(self, **kw)
