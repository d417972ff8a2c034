"""pbmm_tpu — phase-based motion manipulation framework.

A JAX/XLA implementation of Eulerian phase-based motion magnification with
the capabilities of the Unity/HLSL reference
`KenanGokdenizAcet/phase-based-motion-manipulation` (see SURVEY.md), built
as array programs that XLA compiles for the accelerator (cuFFT for the
transforms on an NVIDIA GPU):

- the whole per-frame pipeline is one pure, jittable array program
  (`engine.pipeline.magnify_frame_pair`);
- the reference's ~115 GPU dispatches/frame collapse to 1 forward FFT,
  one fused band/phase pass, and 1 inverse FFT (the pyramid band loop is
  algebraically fused — see `phase.amplify`);
- video streaming is a `lax.scan` carrying the previous frame's spectrum and
  temporal-filter state (`engine.video`);
- multi-device scaling uses `jax.sharding` meshes with a 1-frame halo
  exchange over the frame-shard axis (`parallel`).

Layer map (mirrors SURVEY.md §7.1):
    core/      color transforms, pad/window/crop/blur, complex helpers
    spectral/  centered 2D FFT/IFFT (jnp.fft; matmul-factored alternative)
    pyramid/   frequency-domain radial (+ optional steerable) filter banks
    phase/     phase-delta amplification (pyramid + standard modes), temporal
    engine/    frame-pair and streaming-video drivers, pipeline state
    parallel/  device meshes, shardings, halo exchange
    oracle/    numpy transcription of the reference math (executable spec)
    utils/     metrics (PSNR/SSIM), debug visualizations, profiling
    io/        video tensor I/O
"""

from pbmm_tpu.config import MagnifyConfig, TemporalConfig
from pbmm_tpu.engine.pipeline import magnify_frame_pair
from pbmm_tpu.engine.video import magnify_video

__version__ = "0.1.0"

__all__ = [
    "MagnifyConfig",
    "TemporalConfig",
    "magnify_frame_pair",
    "magnify_video",
    "__version__",
]
