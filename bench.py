"""Headline benchmark: 1080p magnified frames/s on one NVIDIA GPU.

Reference-parity algorithm (pyramid mode, L=5, phase_scale=10, phase math
per `MotionMagnificationProcessor.cs`) in the portable default
configuration (XLA with cuFFT, half-spectrum) at pad_mode="tight"
(1152x2048 internal; the reference's 2048^2 pad exists only because its
FFT driver shares one pow-2 table between axes, `:531-535`).  Frames go
through the streaming engine (`engine.video.magnify_video`) with the
previous frame's spectrum carried as state across chunk calls — every
frame magnified against its true predecessor, as the CLI streams.

Prints ONE JSON line on stdout:
  {"metric": "fps_1080p", "value": N, "unit": "frames/s",
   "device": {"platform": ..., "kind": ..., "count": ...}}
Device, card name and power limit, batch-1 latency and the other
configurations' rates go to stderr.  Exits 1 when JAX finds no GPU.

    python bench.py            # PBMM_BENCH_EXTRA=0 skips the extra lines
"""

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def clip(h, w, t, seed=0):
    """Slightly shifting random content, so phase deltas are realistic
    (the magnitude gates open)."""
    rng = np.random.default_rng(seed)
    base = rng.random((h, w, 3)).astype(np.float32)
    return np.stack(
        [np.roll(base, shift=i, axis=1) * (0.95 + 0.01 * i) for i in range(t)]
    )


def fps_of(frames_dev, cfg, reps=8, trials=3):
    """Steady-state frames/s: `reps` chunk calls threading the state, run
    to completion with `jax.block_until_ready`; median of `trials`."""
    import jax

    from pbmm_tpu.engine.video import magnify_video

    out, state = magnify_video(frames_dev, cfg)  # compile bootstrap
    out, state = magnify_video(frames_dev, cfg, state)  # compile chunk
    jax.block_until_ready((out, state))
    rates = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(reps):
            out, state = magnify_video(frames_dev, cfg, state)
        jax.block_until_ready((out, state))
        rates.append(frames_dev.shape[0] * reps / (time.perf_counter() - t0))
    return float(np.median(rates))


def main():
    import jax

    from pbmm_tpu.utils.cache import enable_compile_cache
    from pbmm_tpu.utils.device import (
        describe,
        gpu_name_and_power_limit,
        require_gpu,
    )

    try:
        require_gpu(jax.devices())
    except RuntimeError as e:
        log(f"bench: {e}")
        return 1
    enable_compile_cache()
    device = describe(jax.devices())
    log(f"device: {device}")
    log(f"card: {gpu_name_and_power_limit()}")

    from pbmm_tpu.config import MagnifyConfig
    from pbmm_tpu.engine.video import magnify_video

    t = 16
    frames_dev = jax.device_put(clip(1080, 1920, t))
    cfg = MagnifyConfig(pad_mode="tight")

    t0 = time.perf_counter()
    fps = fps_of(frames_dev, cfg)
    log(f"headline: {fps:.2f} fps ({1e3 / fps:.3f} ms/frame); "
        f"compile + measurement {time.perf_counter() - t0:.1f}s")

    # Single-frame latency (the reference's real contract: an interactive
    # per-frame post-effect, `OnRenderImage`,
    # `MotionMagnificationProcessor.cs:101`).  Batch-1 chunks threaded
    # through the carried state: a strict frame-after-frame chain.
    one = frames_dev[:1]
    _, state = magnify_video(frames_dev, cfg)
    out1, state = magnify_video(one, cfg, state)  # compile the T=1 chunk
    jax.block_until_ready(out1)
    n_lat = 64
    t0 = time.perf_counter()
    for _ in range(n_lat):
        out1, state = magnify_video(one, cfg, state)
        jax.block_until_ready(out1)
    lat_ms = (time.perf_counter() - t0) / n_lat * 1e3
    log(f"latency: {lat_ms:.3f} ms/frame at batch 1")

    if os.environ.get("PBMM_BENCH_EXTRA", "1") == "1":
        extra_benches(jax, frames_dev, cfg)

    print(json.dumps({"metric": "fps_1080p", "value": round(fps, 2),
                      "unit": "frames/s", "device": device}))
    return 0


def extra_benches(jax, frames_1080, cfg):
    from pbmm_tpu.config import TemporalConfig

    for name, c in [
        ("standard", cfg.replace(mode="standard")),
        ("steerable-4", cfg.replace(orientations=4)),
        ("chroma-rgb", cfg.replace(chroma="rgb")),
        ("iir-temporal", cfg.replace(
            temporal=TemporalConfig(mode="iir_bandpass"))),
        ("square_pow2 (2048^2)", cfg.replace(pad_mode="square_pow2")),
    ]:
        log(f"{name}: {fps_of(frames_1080, c, trials=1):.2f} fps 1080p")

    # u8 planar video pipeline (planar uint8 in -> planar out): the
    # production-video contract (the reference's source textures are
    # 8-bit).
    fr_u8 = np.clip(np.asarray(frames_1080) * 255.0, 0, 255).astype(np.uint8)
    planar = jax.device_put(np.moveaxis(fr_u8, -1, 1).copy())
    for layout in ("planar", "planar_u8"):
        v = fps_of(planar, cfg.replace(output_layout=layout), trials=1)
        log(f"u8-planar in, {layout} out: {v:.2f} fps 1080p")

    # Pad geometry at 720p: tight 768x2048, rect_pow2 1024x2048,
    # square_pow2 2048^2.
    clip_720 = jax.device_put(clip(720, 1280, 16, seed=1))
    for pad in ("tight", "rect_pow2", "square_pow2"):
        v = fps_of(clip_720, cfg.replace(pad_mode=pad), trials=1)
        log(f"720p {pad}: {v:.2f} fps")


if __name__ == "__main__":
    sys.exit(main())
