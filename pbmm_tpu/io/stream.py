"""Streaming magnification driver: native prefetch reader + chunked scan.

Overlaps host-side IO/decode (the native frame loader's prefetch thread)
with device compute, threading `VideoState` across chunks so per-device
memory stays flat for arbitrarily long videos (SURVEY.md §5 long-context
row).

`stream_magnify_resumable` adds the driver-level failure-recovery loop the
reference cannot have (its only cross-frame state is one texture rebuilt
every run, `MotionMagnificationProcessor.cs:56-57,142`; SURVEY.md §5
failure row): output frames land incrementally in a preallocated .npy and
the `VideoState` checkpoint is written atomically after every chunk, so a
killed host restarts with the same command line and resumes from the last
completed chunk, bit-identically to an uninterrupted run.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from pbmm_tpu.config import MagnifyConfig
from pbmm_tpu.engine.video import VideoState, magnify_video


def _batch_frames(frame_iter, chunk_frames: int) -> Iterator[np.ndarray]:
    """Group a frame iterator into (n, H, W, 3) chunks; memory is bounded
    by one chunk."""
    batch = []
    for fr in frame_iter:
        batch.append(np.asarray(fr, np.float32))
        if len(batch) == chunk_frames:
            yield np.stack(batch)
            batch = []
    if batch:
        yield np.stack(batch)


def _chunks_memmap_npy(path: str, chunk_frames: int) -> Iterator[np.ndarray]:
    """Chunk a .npy file through a memmap: only one chunk of pixel data is
    resident at a time (the `--stream` flat-memory contract)."""
    mm = np.load(path, mmap_mode="r")
    for i in range(0, mm.shape[0], chunk_frames):
        chunk = np.asarray(mm[i:i + chunk_frames])
        # uint8 passes through untouched (r4): `magnify_video` scales by
        # 1/255 ON DEVICE (`core.color.unit_float`), so 8-bit sources
        # cross host->device at a quarter of the f32 bytes.
        if chunk.dtype == np.uint8:
            yield chunk
        else:
            yield chunk.astype(np.float32)


def _chunks_whole(path: str, chunk_frames: int) -> Iterator[np.ndarray]:
    from pbmm_tpu.io.video import load_video

    frames = load_video(path)
    for i in range(0, len(frames), chunk_frames):
        yield frames[i : i + chunk_frames]


def frame_chunks(path: str, chunk_frames: int) -> Iterator[np.ndarray]:
    """Bounded-memory chunk source for `--stream`.

    - "-": y4m from stdin (a pipe, e.g. `ffmpeg ... -f yuv4mpegpipe - |`),
      the offline analog of the reference's live per-frame feed;
    - .y4m: frame-at-a-time iterator (`io.y4m.read_y4m_stream`);
    - .npy: memmap slices (uint8 or f32 on disk);
    - anything else: whole-file fallback (the container requires it).
    """
    if path == "-":
        import sys

        from pbmm_tpu.io.y4m import read_y4m_stream

        yield from _batch_frames(
            read_y4m_stream(sys.stdin.buffer, "<stdin>"), chunk_frames
        )
        return
    lower = path.lower()
    if lower.endswith(".y4m"):
        from pbmm_tpu.io.y4m import read_y4m_frames

        yield from _batch_frames(read_y4m_frames(path), chunk_frames)
        return
    if lower.endswith(".npy"):
        yield from _chunks_memmap_npy(path, chunk_frames)
        return
    yield from _chunks_whole(path, chunk_frames)


def _y4m_device_chunks(plane_iter, chunk_frames: int,
                       planar_u8: bool = False):
    """Batch raw uint8 y4m planes and decode to RGB ON DEVICE (r4): the
    chroma upsample + BT.601 matrix run as one jitted computation
    (`io.device_decode.ycbcr_planes_to_rgb`), so a C420 stream crosses
    host->device at ~1.5 bytes/px instead of 12 for host-decoded f32.

    planar_u8 (`--ingest u8`): emit (T, 3, H, W) uint8 planar RGB — a
    quarter of the f32 bytes into the engine (one extra 8-bit rounding
    vs the f32 decode, the same rounding every rgb24 decoder applies)."""
    from pbmm_tpu.io.device_decode import (
        ycbcr_planes_to_rgb,
        ycbcr_planes_to_rgb_planar_u8,
    )

    fn = ycbcr_planes_to_rgb_planar_u8 if planar_u8 else ycbcr_planes_to_rgb

    def decode(batch):
        y = np.stack([b[0] for b in batch])
        cb = np.stack([b[1] for b in batch])
        cr = np.stack([b[2] for b in batch])
        h, w = y.shape[1:]
        return fn(y, cb, cr, h, w)

    batch = []
    for planes in plane_iter:
        batch.append(planes)
        if len(batch) == chunk_frames:
            yield decode(batch)
            batch = []
    if batch:
        yield decode(batch)


def _open_chunk_source(path: str, chunk_frames: int,
                       planar_u8: bool = False, meta: dict = None):
    """(loader_or_None, chunk_iterator): the native double-buffered loader
    for .npy when available (decode prefetch off the main thread),
    device-side YCbCr decode for y4m sources (file or stdin pipe),
    otherwise the bounded-memory python sources above."""
    if path != "-" and path.lower().endswith(".npy"):
        try:
            from pbmm_tpu.native import NativeFrameLoader

            loader = NativeFrameLoader(path, chunk_frames)
            return loader, iter(loader)
        except (RuntimeError, ValueError):
            pass
    if path == "-":
        import sys

        from pbmm_tpu.io.y4m import read_y4m_planes

        return None, _y4m_device_chunks(
            read_y4m_planes(sys.stdin.buffer, "<stdin>", meta=meta),
            chunk_frames, planar_u8)
    if path.lower().endswith(".y4m"):
        from pbmm_tpu.io.y4m import read_y4m_planes

        def _file_planes():
            with open(path, "rb") as f:
                yield from read_y4m_planes(f, path, meta=meta)

        return None, _y4m_device_chunks(_file_planes(), chunk_frames,
                                        planar_u8)
    return None, frame_chunks(path, chunk_frames)


def stream_magnify(
    path: str,
    cfg: MagnifyConfig,
    chunk_frames: int = 8,
    state: Optional[VideoState] = None,
    ingest: str = "f32",
    meta: dict = None,
) -> Iterator[np.ndarray]:
    """Yield magnified chunks (layout per `cfg.output_layout`).

    Memory stays flat for long videos: .npy inputs stream through the
    native double-buffered loader (or a memmap), .y4m inputs through the
    frame-at-a-time parser, and `path="-"` reads a y4m stream from stdin.

    ingest="u8": y4m sources decode to planar uint8 RGB on device (one
    8-bit rounding vs the f32 decode — the rounding every rgb24 decoder
    applies anyway).
    """
    loader, chunk_iter = _open_chunk_source(path, chunk_frames,
                                            planar_u8=(ingest == "u8"),
                                            meta=meta)
    try:
        for chunk in chunk_iter:
            out, state = magnify_video(chunk, cfg, state=state)
            yield np.asarray(out)
    finally:
        if loader is not None:
            loader.close()


def stream_magnify_resumable(
    input_path: str,
    output_path: str,
    cfg: MagnifyConfig,
    chunk_frames: int = 8,
    checkpoint: str = "",
    max_chunks: Optional[int] = None,
    ingest: str = "f32",
) -> int:
    """Stream `input_path` -> magnified `output_path` (.npy), checkpointing
    after every chunk so a killed run resumes exactly where it stopped.

    Protocol per chunk: write the magnified frames into the preallocated
    output memmap, flush, then atomically replace the checkpoint (state +
    frame_idx).  A crash between those two steps only re-runs one chunk on
    resume — frames are rewritten with identical values, never skipped or
    duplicated.  Resume requires the same `chunk_frames` (checkpoints land
    on chunk boundaries).

    `max_chunks` is the fault-injection hook: stop (as a kill would) after
    that many chunks.  Returns the number of frames completed in total.
    """
    from pbmm_tpu.engine.state import load_state, save_state
    from pbmm_tpu.io.video import video_shape

    if input_path == "-":
        raise ValueError("resumable streaming needs a re-readable input "
                         "file (resume re-reads completed chunks); pipe "
                         "input works with the non-checkpointed --stream")
    if not output_path.endswith(".npy"):
        raise ValueError("resumable streaming writes incremental .npy "
                         f"output, got {output_path!r}")
    t, h, w, c = video_shape(input_path)
    # The preallocated memmap's shape/dtype follow the configured output
    # layout (r5): interleaved f32 (t,h,w,3), planar f32 (t,3,h,w), or
    # planar uint8.
    if cfg.output_layout == "interleaved":
        out_shape, out_dtype = (t, h, w, c), np.float32
    else:
        out_shape = (t, c, h, w)
        out_dtype = (np.uint8 if cfg.output_layout == "planar_u8"
                     else np.float32)

    start = 0
    state: Optional[VideoState] = None
    if checkpoint and os.path.exists(checkpoint):
        state = load_state(checkpoint)
        start = int(np.asarray(state.frame_idx))
        if start % chunk_frames != 0 and start < t:
            raise ValueError(
                f"checkpoint frame_idx={start} is not a multiple of "
                f"chunk_frames={chunk_frames}; resume with the original "
                "chunk size"
            )

    if os.path.exists(output_path) and start > 0:
        out_mm = np.lib.format.open_memmap(output_path, mode="r+")
        if out_mm.shape != out_shape or out_mm.dtype != out_dtype:
            raise ValueError(
                f"existing output {output_path!r} has "
                f"{out_mm.dtype}{out_mm.shape}, expected "
                f"{np.dtype(out_dtype).name}{out_shape}"
            )
    else:
        out_mm = np.lib.format.open_memmap(
            output_path, mode="w+", dtype=out_dtype, shape=out_shape
        )
        start = 0
        state = None

    pos = start
    done_chunks = 0
    for chunk_out, state in _resume_chunks(
        input_path, cfg, chunk_frames, start, state, ingest
    ):
        n = chunk_out.shape[0]
        out_mm[pos:pos + n] = chunk_out
        out_mm.flush()
        pos += n
        if checkpoint:
            save_state(state, checkpoint)
        done_chunks += 1
        if max_chunks is not None and done_chunks >= max_chunks:
            break
    return pos


def _resume_chunks(
    input_path: str,
    cfg: MagnifyConfig,
    chunk_frames: int,
    skip_frames: int,
    state: Optional[VideoState],
    ingest: str = "f32",
) -> Iterator[tuple]:
    """Yield (magnified_chunk, new_state) starting at frame `skip_frames`.

    The native prefetch loader has no seek, so already-completed chunks are
    read and discarded (cheap: decode only, no device work); the memmap
    fallback slices directly.
    """
    loader, chunk_iter = _open_chunk_source(
        input_path, chunk_frames, planar_u8=(ingest == "u8"))
    seen = 0
    try:
        for chunk in chunk_iter:
            n = chunk.shape[0]
            if seen + n <= skip_frames:
                seen += n
                continue
            seen += n
            out, state = magnify_video(chunk, cfg, state=state)
            yield np.asarray(out), state
    finally:
        if loader is not None:
            loader.close()
