"""Smoke test of the magnification path on one NVIDIA GPU.

    python chip_smoke.py           # one card: phases 1-4
    python chip_smoke.py --four    # four cards: the multi-card path only

Runs in ONE process, so one JAX client holds the card, and exits non-zero
on the first failing phase:

1. device  — JAX's first device must be a GPU.  Prints the device kind,
   the device count and the card's name and power limit (`nvidia-smi`).
2. compile — compiles the 1080p chunk step (1920x1080, T=16, reference
   defaults: pyramid, L=5, phase_scale=10) at pad_mode="tight" and
   "square_pow2" and prints `compiled.memory_analysis()`.
3. end to end, at 1080p through the entry points a user calls:
   `pbmm_tpu.magnify_video` threading its state over 4 chunks of 16
   frames; one chunk each of mode="standard", orientations=4,
   chroma="rgb", IIR temporal and output_layout="planar_u8" on uint8
   planar input; the live CLI (`pbmm_tpu.cli.main --stream`) on a 1080p
   .y4m in 8-frame chunks, with f32 and with u8 ingest.  Frames/s are
   printed for information only: they include compilation.
4. parity — the first 4 frames of each phase-3 mode against the fp64
   oracle (`oracle/reference.py`): PSNR >= 55 dB.

`--four` runs only the multi-card path on 4 cards, and what it is compared
with: `magnify_batch_sharded` on a ("data", "frame") mesh and
`magnify_video_spatial` on a ("frame", "rows") mesh, each against the
single-card streaming engine on the same 1080p frames: PSNR >= 100 dB.

Precision: f32 end to end.  The FFTs are cuFFT on complex64; the path has
no matrix multiply (the colour transforms are written out as scalar
multiply-adds, `core/color.py`), so TF32 cannot enter.

The last line printed is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

HEIGHT, WIDTH, CHUNK = 1080, 1920, 16
PARITY_FRAMES = 4
PARITY_DB = 55.0  # the CPU tests' bar against the fp64 oracle
SHARDED_DB = 100.0  # sharded vs single-card engine


def log(msg: str) -> None:
    print(msg, flush=True)


def smoke_clip(h: int, w: int, t: int, seed: int = 0,
               components: int = 12, speed: float = 0.5) -> np.ndarray:
    """(t, h, w, 3) f32 frames in [0, 1]: a sum of random plane waves (up
    to 0.2 cycles/pixel) drifting `speed` pixels per frame to the right —
    sub-pixel motion in every pyramid band, the regime phase-based
    magnification targets."""
    rng = np.random.default_rng(seed)
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    out = np.full((t, h, w), 0.5, np.float64)
    for _ in range(components):
        fx, fy = rng.uniform(-0.2, 0.2, 2)
        amp = 0.35 / components
        by = 2 * np.pi * fy * y + rng.uniform(0, 2 * np.pi)
        cy, sy = np.cos(by), np.sin(by)
        for i in range(t):
            ax = 2 * np.pi * fx * (x - speed * i)
            out[i] += amp * (np.cos(ax) * cy - np.sin(ax) * sy)
    gains = np.array([1.0, 0.9, 0.8])
    return np.clip(out[..., None] * gains, 0.0, 1.0).astype(np.float32)


def phase_device(devices, n_required: int = 1) -> dict:
    from pbmm_tpu.utils.device import (
        describe,
        gpu_name_and_power_limit,
        require_gpu,
    )

    require_gpu(devices)
    if len(devices) < n_required:
        raise RuntimeError(f"needs {n_required} GPUs, JAX sees "
                           f"{len(devices)}")
    info = describe(devices)
    log(f"device: kind={info['kind']} count={info['count']}")
    log(f"nvidia-smi: {gpu_name_and_power_limit()}")
    return info


def phase_compile(h: int, w: int, t: int) -> dict:
    """Compile the chunk step at both geometries; returns the memory
    analyses by pad mode."""
    import jax
    import jax.numpy as jnp

    from pbmm_tpu.config import MagnifyConfig
    from pbmm_tpu.engine.video import _chunk_scan, video_init

    out = {}
    for pad in ("tight", "square_pow2"):
        cfg = MagnifyConfig(pad_mode=pad)
        frames = jax.ShapeDtypeStruct((t, h, w, 3), jnp.float32)
        state = jax.eval_shape(
            lambda f: video_init(f, cfg),
            jax.ShapeDtypeStruct((h, w, 3), jnp.float32))
        t0 = time.perf_counter()
        compiled = _chunk_scan.lower(frames, state, cfg=cfg).compile()
        mem = compiled.memory_analysis()
        log(f"compile {pad}: {time.perf_counter() - t0:.1f}s; "
            f"memory_analysis: {mem}")
        out[pad] = mem
    return out


def mode_configs(base):
    """The phase-3 single-chunk modes, by name."""
    from pbmm_tpu.config import TemporalConfig

    return {
        "standard": base.replace(mode="standard"),
        "orientations=4": base.replace(orientations=4),
        "chroma=rgb": base.replace(chroma="rgb"),
        "iir": base.replace(temporal=TemporalConfig(mode="iir_bandpass")),
        "planar_u8": base.replace(output_layout="planar_u8"),
    }


def _rate(t0: float, n: int) -> str:
    return f"{n / (time.perf_counter() - t0):.1f} frames/s incl. compile"


def phase_e2e(frames: np.ndarray, base, tmpdir: str,
              chunks: int = 4) -> dict:
    """Run every phase-3 path; returns {mode: (cfg, input, output)} with
    the output of the first chunk for the parity phase.  The CLI streams
    all of `frames` in 8-frame chunks."""
    import jax

    from pbmm_tpu import magnify_video
    from pbmm_tpu.cli import main as cli_main
    from pbmm_tpu.io.y4m import save_y4m

    t = frames.shape[0]
    runs = {}
    state = None
    t0 = time.perf_counter()
    for c in range(chunks):
        out, state = magnify_video(frames, base, state)
        out = np.asarray(out)
        check_frames(out, frames.shape, f"chunk {c}")
        if c == 0:
            runs["default"] = (base, frames, out)
    if int(state.frame_idx) != chunks * t:
        raise RuntimeError(f"state frame_idx {int(state.frame_idx)} after "
                           f"{chunks * t} frames")
    log(f"magnify_video x{chunks} chunks of {t}: {_rate(t0, chunks * t)}")

    for name, cfg in mode_configs(base).items():
        src = frames
        if cfg.output_layout == "planar_u8":
            src = np.moveaxis(np.round(frames * 255.0).astype(np.uint8),
                              -1, 1).copy()
        t0 = time.perf_counter()
        out = np.asarray(jax.block_until_ready(magnify_video(src, cfg)[0]))
        log(f"{name}: {_rate(t0, t)}")
        if cfg.output_layout == "planar_u8":
            if out.dtype != np.uint8 or out.shape != src.shape:
                raise RuntimeError(f"{name}: got {out.dtype} {out.shape}")
        else:
            check_frames(out, frames.shape, name)
        runs[name] = (cfg, src, out)

    y4m = os.path.join(tmpdir, "in.y4m")
    save_y4m(y4m, frames)
    for ingest, layout in (("f32", "interleaved"), ("u8", "planar_u8")):
        dst = os.path.join(tmpdir, f"out_{ingest}.npy")
        t0 = time.perf_counter()
        rc = cli_main(["--input", y4m, "--stream", "--chunk-frames", "8",
                       "--pad-mode", base.pad_mode, "--ingest", ingest,
                       "--output-layout", layout, "--output", dst])
        if rc != 0:
            raise RuntimeError(f"cli --ingest {ingest} exited {rc}")
        got = np.load(dst)
        want = (frames.shape if layout == "interleaved"
                else (t, 3) + frames.shape[1:3])
        if got.shape != want:
            raise RuntimeError(f"cli --ingest {ingest}: shape {got.shape}, "
                               f"want {want}")
        if layout == "interleaved":
            check_frames(got, want, f"cli --ingest {ingest}")
        log(f"cli --stream --ingest {ingest}: {_rate(t0, t)}")
    return runs


def check_frames(out: np.ndarray, shape, what: str) -> None:
    if out.shape != tuple(shape):
        raise RuntimeError(f"{what}: shape {out.shape}, want {shape}")
    if not np.isfinite(out).all() or out.min() < 0.0 or out.max() > 1.0:
        raise RuntimeError(f"{what}: values outside [0, 1] or non-finite")


def phase_parity(runs: dict, n: int = PARITY_FRAMES,
                 bar: float = PARITY_DB) -> dict:
    """PSNR of each mode's first `n` output frames against the fp64
    oracle on the same input frames."""
    from pbmm_tpu.oracle.reference import (
        oracle_magnify_video,
        oracle_magnify_video_iir,
    )
    from pbmm_tpu.utils.metrics import psnr

    result = {}
    for name, (cfg, src, out) in runs.items():
        if cfg.output_layout == "planar_u8":
            # uint8 planar in -> uint8 planar out: compare in [0, 1] with
            # the oracle quantized the same way.
            x = np.moveaxis(src[:n], 1, -1).astype(np.float64) / 255.0
            got = np.moveaxis(out[:n], 1, -1).astype(np.float64) / 255.0
        else:
            x, got = src[:n], out[:n]
        oracle = (oracle_magnify_video_iir
                  if cfg.temporal.mode == "iir_bandpass"
                  else oracle_magnify_video)
        want = oracle(x, cfg)
        if cfg.output_layout == "planar_u8":
            want = np.round(want * 255.0) / 255.0
        db = psnr(got, want)
        log(f"parity {name}: {db:.2f} dB vs fp64 oracle ({n} frames)")
        if not db >= bar:
            raise RuntimeError(f"parity {name}: {db:.2f} dB < {bar} dB")
        result[name] = db
    return result


def phase_four(devices, h: int, w: int, t: int,
               bar: float = SHARDED_DB) -> dict:
    """Both mesh engines on 4 devices vs the single-card engine."""
    import jax
    from jax.sharding import Mesh

    from pbmm_tpu import MagnifyConfig, magnify_video
    from pbmm_tpu.parallel.mesh import make_mesh
    from pbmm_tpu.parallel.sharding import magnify_batch_sharded
    from pbmm_tpu.parallel.spatial import magnify_video_spatial
    from pbmm_tpu.utils.metrics import psnr

    devs = list(devices)[:4]
    cfg = MagnifyConfig(pad_mode="tight")
    clips = np.stack([smoke_clip(h, w, t, seed=0), smoke_clip(h, w, t, 1)])

    def single(v):
        with jax.default_device(devs[0]):
            return np.asarray(magnify_video(v, cfg)[0])

    ref = np.stack([single(v) for v in clips])
    result = {}

    mesh = make_mesh((2, 2), devices=devs)
    t0 = time.perf_counter()
    got = np.asarray(magnify_batch_sharded(clips, cfg, mesh))
    result["data_frame"] = psnr(got, ref)
    log(f"magnify_batch_sharded ('data','frame')=(2,2): "
        f"{result['data_frame']:.2f} dB vs single card; "
        f"{_rate(t0, clips.shape[0] * t)}")

    mesh = Mesh(np.asarray(devs).reshape(2, 2), ("frame", "rows"))
    t0 = time.perf_counter()
    got = np.asarray(magnify_video_spatial(clips[0], cfg, mesh))
    result["frame_rows"] = psnr(got, ref[0])
    log(f"magnify_video_spatial ('frame','rows')=(2,2): "
        f"{result['frame_rows']:.2f} dB vs single card; {_rate(t0, t)}")
    for k, db in result.items():
        if not db >= bar:
            raise RuntimeError(f"{k}: {db:.2f} dB < {bar} dB")
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-card path, on 4 GPUs")
    return ap.parse_args(argv)


def phases(args) -> tuple:
    """Names of the phases a run with `args` executes, in order."""
    if args.four:
        return ("device", "four")
    return ("device", "compile", "e2e", "parity")


def main(argv=None) -> int:
    args = parse_args(argv)
    import jax

    try:
        info = phase_device(jax.devices(), 4 if args.four else 1)
    except Exception as e:
        print(f"chip_smoke: device: {e}", file=sys.stderr)
        return 1

    from pbmm_tpu.utils.cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    todo = phases(args)
    try:
        if "four" in todo:
            phase_four(jax.devices(), HEIGHT, WIDTH, 8)
        if "compile" in todo:
            phase_compile(HEIGHT, WIDTH, CHUNK)
        if "e2e" in todo:
            from pbmm_tpu.config import MagnifyConfig

            frames = smoke_clip(HEIGHT, WIDTH, CHUNK)
            with tempfile.TemporaryDirectory() as tmpdir:
                runs = phase_e2e(frames, MagnifyConfig(pad_mode="tight"),
                                 tmpdir)
            phase_parity(runs)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
