"""Command-line entry point.

The reference's only "config system" is Unity inspector serialization
(SURVEY.md §5); this CLI is its replacement: every pipeline
parameter is a flag, applied to a video tensor file.

    python -m pbmm_tpu.cli --input clip.npy --output out.npy --phase-scale 10
    python -m pbmm_tpu.cli --demo bar --output out.npy   # synthetic demo
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pbmm_tpu",
        description="phase-based motion magnification",
    )
    p.add_argument("--input", help="input video (.npy/.npz/.y4m, THWC), or "
                                   "'-' for a y4m stream on stdin (pipe "
                                   "mode, e.g. `ffmpeg ... -f yuv4mpegpipe "
                                   "- | pbmm --input - --stream ...`)")
    p.add_argument("--demo", choices=["bar", "blob"],
                   help="generate a synthetic demo clip instead of --input")
    p.add_argument("--output", required=True,
                   help="output path (.npy/.npz/.y4m), or '-' for a live "
                        "y4m stream on stdout (with --stream: pipe to a "
                        "player, e.g. `... --output - | mpv -`)")
    p.add_argument("--mode", default="pyramid", choices=["pyramid", "standard"])
    p.add_argument("--phase-scale", type=float, default=10.0)
    p.add_argument("--levels", type=int, default=5)
    p.add_argument("--min-frequency", type=float, default=0.05)
    p.add_argument("--max-frequency", type=float, default=0.45)
    p.add_argument("--orientations", type=int, default=0)
    p.add_argument("--magnitude-threshold", type=float, default=0.01)
    p.add_argument("--low-cutoff", type=float, default=0.05)
    p.add_argument("--high-cutoff", type=float, default=0.4)
    p.add_argument("--steepness", type=float, default=3.0)
    p.add_argument("--motion-sensitivity", type=float, default=1.5)
    p.add_argument("--edge-enhancement", type=float, default=0.8)
    p.add_argument("--no-edges", action="store_true")
    p.add_argument("--no-bandpass", action="store_true")
    p.add_argument("--chroma", default="y_only", choices=["y_only", "rgb"])
    p.add_argument("--output-layout", default="interleaved",
                   choices=["interleaved", "planar", "planar_u8"],
                   help="planar/planar_u8 ((T,3,H,W); planar_u8 quarters "
                        "the output bytes)")
    p.add_argument("--pad-mode", default="square_pow2",
                   choices=["square_pow2", "rect_pow2", "tight"],
                   help="tight: height to the next 128 multiple (1080p -> "
                        "1152x2048, 0.56x the reference's pixels)")
    p.add_argument("--reconstruct", default="magnitude",
                   choices=["magnitude", "real"])
    p.add_argument("--temporal", default="two_frame",
                   choices=["two_frame", "iir_bandpass"])
    p.add_argument("--temporal-low-hz", type=float, default=0.4)
    p.add_argument("--temporal-high-hz", type=float, default=3.0)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--checkpoint", help="state file: loaded if it exists, "
                                        "saved after the run (streaming)")
    p.add_argument("--debug-view", choices=["magnitude", "phase", "split"],
                   help="render spectrum debug views instead of magnifying "
                        "(the reference's showMagnitude/showPhase toggles)")
    p.add_argument("--stream", action="store_true",
                   help="stream the input in chunks through the native "
                        "prefetching loader (flat memory for long videos)")
    p.add_argument("--chunk-frames", type=int, default=8)
    p.add_argument("--ingest", default="f32", choices=["f32", "u8"],
                   help="u8: y4m sources decode to planar uint8 RGB on "
                        "device (adds the one 8-bit rounding every rgb24 "
                        "decoder applies)")
    p.add_argument("--stats", action="store_true",
                   help="print a JSON line of timing/shape stats to stderr")
    # --- full inspector surface (quirk switches + backend selection) ---
    p.add_argument("--no-magnify", action="store_true",
                   help="applyMotionMagnification=false bypass: frames "
                        "pass through untouched (A/B output)")
    p.add_argument("--fft-backend", default=None,
                   choices=["xla", "mxu"],
                   help="spectral backend (default: xla, i.e. jnp.fft)")
    p.add_argument("--full-spectrum", action="store_true",
                   help="use_rfft=False: literal full-complex spectra "
                        "instead of the Hermitian half")
    p.add_argument("--blur-size", type=float, default=0.5,
                   help="the anti-aliasing Gaussian's _BlurSize "
                        "(reference fixes 0.5)")
    p.add_argument("--compensate-window", action="store_true",
                   help="divide the Hann vignette back out (the reference "
                        "never does)")
    p.add_argument("--no-cache-prev-spectrum", action="store_true",
                   help="re-FFT the previous frame every frame, as the "
                        "reference literally does")
    p.add_argument("--apply-magnitude-scale", action="store_true",
                   help="apply the magnitude scale the reference computes "
                        "but drops (PhaseDifferenceComputeShader:169-178)")
    p.add_argument("--magnitude-scale", type=float, default=1.0)
    p.add_argument("--yiq-gains", type=float, nargs=3, default=None,
                   metavar=("Y", "I", "Q"),
                   help="per-channel YIQ gains (enables the reference's "
                        "inert _YIQADJUSTMENT_ON path)")
    p.add_argument("--trace", metavar="LOGDIR",
                   help="capture a jax.profiler Perfetto/XProf trace of "
                        "the run into LOGDIR")
    return p


def config_from_args(args):
    from pbmm_tpu.config import MagnifyConfig, TemporalConfig

    backend_kw = {}
    if getattr(args, "fft_backend", None):
        backend_kw["fft_backend"] = args.fft_backend
        if args.fft_backend == "mxu":
            backend_kw["use_rfft"] = True
    if getattr(args, "full_spectrum", False):
        backend_kw["use_rfft"] = False
    return MagnifyConfig(
        apply_motion_magnification=not getattr(args, "no_magnify", False),
        blur_size=getattr(args, "blur_size", 0.5),
        compensate_window=getattr(args, "compensate_window", False),
        cache_prev_spectrum=not getattr(args, "no_cache_prev_spectrum",
                                        False),
        apply_magnitude_scale=getattr(args, "apply_magnitude_scale", False),
        magnitude_scale=getattr(args, "magnitude_scale", 1.0),
        yiq_gains=tuple(args.yiq_gains) if getattr(args, "yiq_gains", None)
        else (1.0, 1.0, 1.0),
        apply_yiq_gains=bool(getattr(args, "yiq_gains", None)),
        **backend_kw,
        mode=args.mode,
        phase_scale=args.phase_scale,
        pyramid_levels=args.levels,
        min_frequency=args.min_frequency,
        max_frequency=args.max_frequency,
        orientations=args.orientations,
        magnitude_threshold=args.magnitude_threshold,
        low_freq_cutoff=args.low_cutoff,
        high_freq_cutoff=args.high_cutoff,
        filter_steepness=args.steepness,
        motion_sensitivity=args.motion_sensitivity,
        enhance_edges=not args.no_edges,
        edge_enhancement=args.edge_enhancement,
        apply_bandpass=not args.no_bandpass,
        chroma=args.chroma,
        output_layout=getattr(args, "output_layout", "interleaved"),
        pad_mode=args.pad_mode,
        reconstruct=args.reconstruct,
        temporal=TemporalConfig(
            mode=args.temporal,
            low_hz=args.temporal_low_hz,
            high_hz=args.temporal_high_hz,
            fps=args.fps,
        ),
    )


def main(argv=None) -> int:
    from pbmm_tpu.utils.cache import enable_compile_cache

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    if bool(args.input) == bool(args.demo):
        print("error: exactly one of --input / --demo is required",
              file=sys.stderr)
        return 2
    if args.input == "-" and not args.stream:
        print("error: --input - (stdin pipe) requires --stream",
              file=sys.stderr)
        return 2

    from pbmm_tpu.io.video import load_video

    if args.stream:
        # Streaming never materializes the clip here — `_run` pulls
        # bounded chunks straight from the file/pipe (io.stream).
        frames = None
    elif args.demo:
        from pbmm_tpu.oracle.synthetic import (
            oscillating_bar,
            oscillating_gaussian_blob,
        )

        frames = (oscillating_bar(bar_width=2) if args.demo == "bar"
                  else oscillating_gaussian_blob())
    else:
        frames = load_video(args.input)
    if frames is not None and (frames.ndim != 4 or frames.shape[-1] != 3):
        print(f"error: expected (T, H, W, 3) input, got {frames.shape}",
              file=sys.stderr)
        return 2

    cfg = config_from_args(args)

    if args.trace:
        from pbmm_tpu.utils.profiling import trace

        with trace(args.trace):
            return _run(args, frames, cfg)
    return _run(args, frames, cfg)


def _run(args, frames, cfg) -> int:
    from pbmm_tpu.io.video import save_video

    t0 = time.perf_counter()

    if args.debug_view:
        import jax

        from pbmm_tpu.utils.debug import debug_frame_view

        fn = jax.jit(
            lambda f: debug_frame_view(
                f,
                cfg,
                show_magnitude=args.debug_view in ("magnitude", "split"),
                show_phase=args.debug_view in ("phase", "split"),
            )
        )
        out = np.stack([np.asarray(fn(f)) for f in frames])
        save_video(args.output, out)
        return 0

    if args.stream:
        if not args.input:
            print("error: --stream requires --input", file=sys.stderr)
            return 2
        if args.checkpoint:
            # Resume loop: incremental output + atomic per-chunk state, so
            # re-running this exact command after a kill continues from the
            # last completed chunk (SURVEY.md §5 failure row).
            from pbmm_tpu.io.stream import stream_magnify_resumable

            n = stream_magnify_resumable(
                args.input, args.output, cfg,
                chunk_frames=args.chunk_frames,
                checkpoint=args.checkpoint,
                ingest=args.ingest,
            )
            if args.stats:
                print(json.dumps({"frames": n,
                                  "seconds": round(time.perf_counter() - t0,
                                                   3),
                                  "engine": "stream_resumable"}),
                      file=sys.stderr)
            return 0
        from pbmm_tpu.io.stream import stream_magnify

        if args.output == "-":
            # Live pipe loop: magnified frames leave on stdout as
            # y4m AS EACH CHUNK COMPLETES — `ffmpeg ... -f yuv4mpegpipe -
            # | pbmm --input - --stream --output - | mpv -` closes the
            # reference's interactive per-frame contract as a process
            # pipeline.  --chunk-frames 1 minimizes latency (one frame
            # in, one frame out); --stats logs the per-chunk latency.
            from pbmm_tpu.io.y4m import Y4MStreamWriter

            meta = {}
            writer = None
            n = 0
            tc = time.perf_counter()
            for chunk in stream_magnify(args.input, cfg,
                                        chunk_frames=args.chunk_frames,
                                        ingest=args.ingest, meta=meta):
                if writer is None:
                    # The source header has been parsed by now; carry its
                    # frame rate into the output header (a 60 fps
                    # source must not come out labeled F30:1).
                    writer = Y4MStreamWriter(
                        sys.stdout.buffer, fps=meta.get("fps", (30, 1)))
                writer.write_chunk(chunk)
                n += chunk.shape[0]
                if args.stats:
                    now = time.perf_counter()
                    print(json.dumps(
                        {"chunk_frames": int(chunk.shape[0]),
                         "chunk_ms": round((now - tc) * 1e3, 2)}),
                        file=sys.stderr)
                    tc = now
            if args.stats:
                print(json.dumps({"frames": n,
                                  "seconds": round(
                                      time.perf_counter() - t0, 3),
                                  "engine": "stream_pipe"}),
                      file=sys.stderr)
            return 0
        out = np.concatenate(
            list(stream_magnify(args.input, cfg,
                                chunk_frames=args.chunk_frames,
                                ingest=args.ingest))
        )
        dt = time.perf_counter() - t0
        save_video(args.output, out)
        if args.stats:
            print(json.dumps({"frames": int(out.shape[0]),
                              "seconds": round(dt, 3),
                              "engine": "stream"}), file=sys.stderr)
        return 0

    # Whole-clip run through the streaming engine (`magnify_video`), with
    # optional resume state.  (The stateless `magnify_clip_batched` is the
    # sharded multi-video API, `parallel/sharding.py`.)
    import os

    from pbmm_tpu.engine.state import load_state, save_state
    from pbmm_tpu.engine.video import magnify_video

    state = None
    if args.checkpoint and os.path.exists(args.checkpoint):
        state = load_state(args.checkpoint)
    out_j, state = magnify_video(frames, cfg, state=state)
    out = np.asarray(out_j)
    if args.checkpoint:
        save_state(state, args.checkpoint)
    dt = time.perf_counter() - t0
    save_video(args.output, out)
    if args.stats:
        print(
            json.dumps(
                {
                    "frames": int(frames.shape[0]),
                    "shape": list(frames.shape[1:3]),
                    "seconds": round(dt, 3),
                    "fps": round(frames.shape[0] / dt, 2),
                    "engine": "scan",
                }
            ),
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
