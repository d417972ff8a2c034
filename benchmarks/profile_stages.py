"""Device time per pipeline stage for one 1080p chunk on one NVIDIA GPU.

Traces the streaming engine's chunk step (`engine.video._chunk_scan`) at
1920x1080, tight geometry (1152x2048), T=16 frames, reference defaults
(pyramid, L=5, phase_scale=10), with `jax.profiler`, and sums device time
per named scope with `utils.profiling.device_time_by_scope`.  For each
stage it prints ms/frame, the bytes the stage must move through HBM per
frame (`stage_bytes`, computed from shapes) and the share of the byte
floor those bytes set at the card's published HBM bandwidth.  In the same
run it times a large plain copy, the bandwidth a streaming kernel can
actually reach on this card.

Writes the trace, the compiled HLO and `stages.json` under `--out`.
Exits 1 when JAX finds no GPU.

    python benchmarks/profile_stages.py --out stage_profile
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published HBM bandwidth, TB/s, keyed by `device_kind` (NVIDIA H100 data
# sheet, SXM part: 80 GB HBM3 at 3.35 TB/s).  A device that is not in the
# table is an error, not a default.
HBM_TBPS = {"NVIDIA H100 80GB HBM3": 3.35}

STAGES = ("pbmm.preprocess", "pbmm.fft", "pbmm.phase_amplify", "pbmm.ifft",
          "pbmm.blur+post")


def stage_bytes(h: int, w: int, cfg) -> dict:
    """Least HBM bytes per frame each stage of the portable path moves:
    its inputs read once and its outputs written once, at the stage
    boundaries the XLA program has (an FFT is a library call that
    elementwise work cannot fuse into).  f32 planes, complex64 spectra,
    rfft half-spectrum of width W//2+1, cached previous spectrum.  The
    scan carry's copy of the current spectrum is not counted."""
    from pbmm_tpu.core.window import geometry_for

    g = geometry_for(h, w, cfg.pad_mode)
    c = 3 if cfg.chroma == "rgb" else 1
    iq = 0 if cfg.chroma == "rgb" else 2 * h * w * 4  # original I/Q planes
    plane = c * g.pad_h * g.pad_w * 4
    spec = c * g.pad_h * (g.pad_w // 2 + 1) * 8
    rgb = 3 * h * w * 4
    return {
        "pbmm.preprocess": rgb + plane + iq,
        "pbmm.fft": plane + spec,
        "pbmm.phase_amplify": 3 * spec,
        "pbmm.ifft": spec + plane,
        "pbmm.blur+post": c * h * w * 4 + iq + rgb,
    }


def hbm_tbps(device_kind: str) -> float:
    try:
        return HBM_TBPS[device_kind]
    except KeyError:
        raise ValueError(f"no HBM bandwidth on record for {device_kind!r}; "
                         f"known: {sorted(HBM_TBPS)}") from None


def copy_gbps(jax, jnp, n_bytes: int = 1 << 30, reps: int = 20) -> float:
    """Read+write GB/s of a plain elementwise pass over `n_bytes`."""
    x = jnp.ones((n_bytes // 4,), jnp.float32)
    f = jax.jit(lambda a: a * 1.0001)
    jax.block_until_ready(f(x))
    t0 = time.perf_counter()
    for _ in range(reps):
        y = f(x)
    jax.block_until_ready(y)
    return 2 * n_bytes * reps / (time.perf_counter() - t0) / 1e9


def dump_planes(logdir: str, path: str) -> None:
    """Plane / line / event-count outline of the trace, with the stats of
    each line's first events — what the reduction reads."""
    import jax

    from pbmm_tpu.utils.profiling import _xplane_file

    pd = jax.profiler.ProfileData.from_file(_xplane_file(logdir))
    with open(path, "w") as f:
        for plane in pd.planes:
            for line in plane.lines:
                evs = list(line.events)
                f.write(f"{plane.name} | {line.name} | {len(evs)}\n")
                for ev in evs[:3]:
                    f.write(f"    {ev.name} {ev.duration_ns} "
                            f"{dict(ev.stats)}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="stage_profile")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from pbmm_tpu.config import MagnifyConfig
    from pbmm_tpu.engine.video import _chunk_scan, magnify_video
    from pbmm_tpu.utils.cache import enable_compile_cache
    from pbmm_tpu.utils.device import (
        describe,
        gpu_name_and_power_limit,
        require_gpu,
    )
    from pbmm_tpu.utils.profiling import device_time_by_scope, trace

    try:
        require_gpu(jax.devices())
    except RuntimeError as e:
        print(f"profile_stages: {e}", file=sys.stderr)
        return 1
    enable_compile_cache()
    device = describe(jax.devices())
    card = gpu_name_and_power_limit()
    print(f"device: {device}\ncard: {card}", flush=True)

    h, w, t = 1080, 1920, 16
    cfg = MagnifyConfig(pad_mode="tight")
    rng = np.random.default_rng(0)
    base = rng.random((h, w, 3)).astype(np.float32)
    frames = jax.device_put(np.stack(
        [np.roll(base, i, axis=1) * (0.95 + 0.01 * i) for i in range(t)]))
    _, state = magnify_video(frames, cfg)
    compiled = _chunk_scan.lower(frames, state, cfg=cfg).compile()
    hlo = compiled.as_text()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chunk_scan.hlo.txt"), "w") as f:
        f.write(hlo)

    out, st = _chunk_scan(frames, state, cfg)  # warm
    jax.block_until_ready((out, st))
    t0 = time.perf_counter()
    for _ in range(args.reps):
        out, st = _chunk_scan(frames, state, cfg)
    jax.block_until_ready((out, st))
    wall_ms = (time.perf_counter() - t0) / (args.reps * t) * 1e3

    logdir = os.path.join(args.out, "trace")
    with trace(logdir):
        for _ in range(args.reps):
            out, st = _chunk_scan(frames, state, cfg)
        jax.block_until_ready((out, st))
    dump_planes(logdir, os.path.join(args.out, "planes.txt"))
    kernels = {}
    ns = device_time_by_scope(logdir, hlo, module="jit__chunk_scan",
                              kernels=kernels)
    n = args.reps * t
    with open(os.path.join(args.out, "scope_ns.json"), "w") as f:
        json.dump({"frames": n, **ns, "kernels": kernels}, f, indent=1)
    ns["pbmm.blur+post"] = ns.pop("pbmm.blur", 0.0) + ns.pop("pbmm.post", 0.0)

    peak = hbm_tbps(device["kind"])
    model = stage_bytes(h, w, cfg)
    rows = []
    for s in STAGES + ("other",):
        ms = ns.get(s, 0.0) / n / 1e6
        b = model.get(s)
        floor_ms = b / (peak * 1e12) * 1e3 if b else None
        rows.append({
            "stage": s, "ms_per_frame": ms, "bytes_per_frame": b,
            "floor_ms": floor_ms,
            "floor_share": floor_ms / ms if (b and ms) else None,
        })
        print(f"{s:20s} {ms:8.4f} ms/frame"
              + (f"  {b / 1e6:7.1f} MB  floor {floor_ms:.4f} ms"
                 f"  share {floor_ms / ms if ms else float('nan'):.3f}"
                 if b else ""), flush=True)
    busy = ns.get("_busy_ns", 0.0)
    window = ns.get("_window_ns", 0.0)
    summary = {
        "device": device, "card": card, "hbm_tbps_published": peak,
        "copy_gbps_measured": copy_gbps(jax, jnp),
        "geometry": "1080p tight 1152x2048, T=16, scan engine",
        "wall_ms_per_frame_untraced": wall_ms,
        "device_busy_ms_per_frame": busy / n / 1e6,
        "idle_share_in_window": 1 - busy / window if window else None,
        "stages": rows,
        "kernel_us_per_frame": {k: v / n / 1e3
                                for k, v in sorted(kernels.items())},
        "peak_bytes_in_use": jax.devices()[0].memory_stats().get(
            "peak_bytes_in_use"),
    }
    print(json.dumps(summary))
    with open(os.path.join(args.out, "stages.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
