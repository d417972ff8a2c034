"""BASELINE.json benchmark suite — the five driver-defined configs.

Each config prints one JSON line {config, frames_per_s, psnr_vs_oracle, ...}
with the device it ran on.  Configs 1-3 validate quality against the numpy
oracle as well as throughput; config 4 exercises the sharded batched
engine; config 5 measures scaling efficiency across the visible GPUs.
Every timing ends with `jax.block_until_ready`.  Exits 1 when JAX finds no
GPU.

Run:  python benchmarks/run_suite.py [--configs 1,2,3] [--quick]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rate(fn, n_frames, reps=3):
    """Frames/s of `reps` calls of fn() after one warm-up call."""
    import jax

    out = jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return n_frames * reps / (time.perf_counter() - t0), out


def _time_video(frames, cfg, reps=3):
    import jax

    from pbmm_tpu.parallel.sharding import magnify_clip_batched

    fd = jax.device_put(frames)
    return _rate(lambda: magnify_clip_batched(fd, cfg), len(frames), reps)


def config1(quick):
    """2-scale, 4-orientation steerable pyramid, 128x128 oscillating bar."""
    from pbmm_tpu.config import MagnifyConfig
    from pbmm_tpu.oracle.reference import oracle_magnify_video
    from pbmm_tpu.oracle.synthetic import oscillating_bar
    from pbmm_tpu.utils.metrics import psnr, ssim

    frames = oscillating_bar(size=128, frames=16 if quick else 64, bar_width=2)
    # 2 mid scales + high/low pass = 4 levels; 4 angular sectors per scale.
    cfg = MagnifyConfig(pyramid_levels=4, orientations=4, phase_scale=10.0)
    fps, out = _time_video(frames, cfg)
    # Quality for the SAME config that is timed: the fp64 oracle carries
    # an independent steerable bank (`oracle.reference.steerable_mask_planes`)
    # since r3, so the angular extension's values are pinned end-to-end.
    oracle = oracle_magnify_video(frames, cfg)
    return {
        "config": 1,
        "desc": "steerable 4-level/4-orient 128px bar",
        "frames_per_s": round(fps, 2),
        "psnr_vs_oracle": round(psnr(np.asarray(out), oracle), 1),
        "ssim_vs_oracle": round(ssim(np.asarray(out), oracle), 4),
    }


def config2(quick):
    """5 levels, 8 orientations, 256x256, IIR temporal + phase-scale sweep."""
    from pbmm_tpu.config import MagnifyConfig, TemporalConfig
    from pbmm_tpu.engine.video import magnify_video
    from pbmm_tpu.oracle.synthetic import oscillating_gaussian_blob

    import jax

    frames = jax.device_put(oscillating_gaussian_blob(
        height=256, width=256, frames=8 if quick else 32
    ))  # staged on device: measure compute, not host transfer
    results = {}
    for scale in ([5.0] if quick else [1.0, 5.0, 15.0]):
        cfg = MagnifyConfig(
            pyramid_levels=5,
            orientations=8,
            phase_scale=scale,
            temporal=TemporalConfig(mode="iir_bandpass", low_hz=0.5,
                                    high_hz=6.0, fps=30.0),
        )
        fps, _ = _rate(lambda: magnify_video(frames, cfg), len(frames), 1)
        results[f"fps_scale{scale:g}"] = round(fps, 2)
    return {"config": 2, "desc": "5L/8K 256px IIR sweep", **results}


def config3(quick):
    """RGB/YIQ 512x512, chroma-preserving, streaming IIR state."""
    from pbmm_tpu.config import MagnifyConfig, TemporalConfig
    from pbmm_tpu.engine.video import magnify_video
    from pbmm_tpu.oracle.synthetic import oscillating_gaussian_blob

    import jax

    frames = jax.device_put(oscillating_gaussian_blob(
        height=512, width=512, frames=4 if quick else 16
    ))  # staged on device: measure compute, not host transfer
    cfg = MagnifyConfig(
        temporal=TemporalConfig(mode="iir_bandpass", low_hz=0.4,
                                high_hz=4.0, fps=30.0)
    )
    # Streamed in 2 chunks with carried state (the streaming contract).
    half = len(frames) // 2

    def two_chunks():
        _, st = magnify_video(frames[:half], cfg)
        return magnify_video(frames[half:], cfg, state=st)

    fps, _ = _rate(two_chunks, len(frames), 1)
    return {"config": 3, "desc": "512px YIQ streaming IIR",
            "frames_per_s": round(fps, 2)}


def config4(quick):
    """Batched 1080p multi-video, frames sharded across cards —
    device-resident (frames staged onto the mesh before timing, so the
    number measures sharded compute, not host->device transfer), with the
    analytic link-traffic scaling model published alongside."""
    import jax

    from pbmm_tpu.config import MagnifyConfig
    from pbmm_tpu.parallel.mesh import make_mesh, mesh_shape_for
    from pbmm_tpu.parallel.model import scaling_table
    from pbmm_tpu.parallel.sharding import magnify_batch_sharded

    n = jax.device_count()
    h, w = (270, 480) if quick else (1080, 1920)
    shape = mesh_shape_for(n, n_videos=2)
    mesh = make_mesh(shape)
    b, t = shape[0], 2 * shape[1]
    rng = np.random.default_rng(0)
    frames = jax.device_put(
        rng.random((b, t, h, w, 3)).astype(np.float32))
    cfg = MagnifyConfig()
    fps, _ = _rate(lambda: magnify_batch_sharded(frames, cfg, mesh), b * t,
                   2 if quick else 3)
    return {"config": 4,
            "desc": f"sharded {h}p batch on {n} devices (device-resident)",
            "frames_per_s": round(fps, 2), "devices": n,
            "mesh": list(shape),
            "link_model": scaling_table(
                h, w, cfg.pad_mode, compute_ms_per_frame=1e3 / fps,
                device_kind=jax.devices()[0].device_kind)}


def config5(quick):
    """Scaling efficiency: same per-device work on 1 vs all devices."""
    import jax

    from pbmm_tpu.config import MagnifyConfig
    from pbmm_tpu.parallel.mesh import make_mesh
    from pbmm_tpu.parallel.sharding import magnify_batch_sharded

    n = jax.device_count()
    h, w = (135, 240) if quick else (540, 960)
    t_per_dev = 2 if quick else 8
    cfg = MagnifyConfig()
    rng = np.random.default_rng(0)

    def run(n_dev):
        mesh = make_mesh((1, n_dev), devices=jax.devices()[:n_dev])
        frames = jax.device_put(rng.random(
            (1, t_per_dev * n_dev, h, w, 3)).astype(np.float32))
        fps, _ = _rate(lambda: magnify_batch_sharded(frames, cfg, mesh),
                       t_per_dev * n_dev, 6)
        return fps

    fps1 = run(1)
    if n == 1:
        return {"config": 5, "desc": "frame-shard scaling efficiency",
                "devices": 1, "fps_1dev": round(fps1, 2),
                "fps_ndev": None, "efficiency": None,
                "note": "one device: no scaling to measure"}
    fpsn = run(n)
    return {"config": 5, "desc": "frame-shard scaling efficiency",
            "devices": n, "fps_1dev": round(fps1, 2),
            "fps_ndev": round(fpsn, 2),
            "efficiency": round(fpsn / (fps1 * n), 3)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)

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
        print(f"run_suite: {e}", file=sys.stderr)
        return 1
    enable_compile_cache()
    device = describe(jax.devices())
    print(f"card: {gpu_name_and_power_limit()}", file=sys.stderr)
    fns = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}
    failed = False
    for c in [int(x) for x in args.configs.split(",")]:
        try:
            row = fns[c](args.quick)
        except Exception as e:  # keep the suite running, report at exit
            row = {"config": c, "error": str(e)[:200]}
            failed = True
        print(json.dumps({**row, "device": device}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
