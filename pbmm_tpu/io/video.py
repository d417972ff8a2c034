"""Video tensor I/O.

The reference has no video I/O at all — frames arrive from Unity's renderer
(`OnRenderImage`).  This framework is offline/streaming, so clips are
exchanged as arrays: .npy/.npz/.y4m natively (y4m is a zero-dependency numpy parser,
`io/y4m.py`); other containers via imageio/cv2 when available (gated —
neither ships in the baked image).
"""

from __future__ import annotations

import os

import numpy as np


def _to_float01(frames: np.ndarray) -> np.ndarray:
    if frames.dtype == np.uint8:
        return frames.astype(np.float32) / 255.0
    return frames.astype(np.float32)


def load_video(path: str) -> np.ndarray:
    """-> (T, H, W, 3) f32 in [0, 1]."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return _to_float01(np.load(path))
    if ext == ".npz":
        with np.load(path) as z:
            key = "frames" if "frames" in z else list(z.keys())[0]
            return _to_float01(z[key])
    if ext == ".y4m":
        from pbmm_tpu.io.y4m import load_y4m

        return load_y4m(path)
    try:  # pragma: no cover - optional dependency
        import imageio.v3 as iio

        return _to_float01(np.asarray(iio.imread(path)))
    except ImportError as e:
        raise RuntimeError(
            f"cannot read {path!r}: only .npy/.npz/.y4m supported without imageio"
        ) from e


def video_shape(path: str) -> tuple:
    """(T, H, W, C) of a video file without loading the pixel data when the
    container allows it (.npy header / memmap, .y4m header + seek); others
    fall back to a full read."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return tuple(np.load(path, mmap_mode="r").shape)
    if ext == ".y4m":
        return _y4m_shape(path)
    return tuple(load_video(path).shape)


def _y4m_shape(path: str) -> tuple:
    """Count .y4m frames by seeking over the fixed-size frame payloads —
    no pixel decode, O(T) tiny reads."""
    from pbmm_tpu.io.y4m import _chroma_dims

    with open(path, "rb") as f:
        header = f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError(f"{path!r} is not a YUV4MPEG2 stream")
        w = h = 0
        cs = "420jpeg"
        for tok in header.split()[1:]:
            if tok[0] == "W":
                w = int(tok[1:])
            elif tok[0] == "H":
                h = int(tok[1:])
            elif tok[0] == "C":
                cs = tok[1:]
        cw, ch = _chroma_dims(w, h, cs)
        frame_bytes = w * h + 2 * cw * ch
        size = os.path.getsize(path)
        t = 0
        while True:
            marker = f.readline()
            if not marker or not marker.startswith(b"FRAME"):
                break
            if f.tell() + frame_bytes > size:
                break  # truncated trailing frame
            f.seek(frame_bytes, 1)
            t += 1
    return (t, h, w, 3)


def save_video(path: str, frames: np.ndarray) -> None:
    """Save (T, H, W, 3) float frames; .npy/.npz as f32, containers via
    imageio as uint8."""
    ext = os.path.splitext(path)[1].lower()
    frames = np.asarray(frames)
    # uint8 passes through unconverted (the planar_u8 output layout, r5);
    # everything else normalizes to f32.
    dt = np.uint8 if frames.dtype == np.uint8 else np.float32
    if ext == ".npy":
        np.save(path, frames.astype(dt))
        return
    if ext == ".npz":
        np.savez_compressed(path, frames=frames.astype(dt))
        return
    if ext == ".y4m":
        from pbmm_tpu.io.y4m import save_y4m

        save_y4m(path, frames)
        return
    try:  # pragma: no cover - optional dependency
        import imageio.v3 as iio

        # Normalize the r5 layouts for the container writer: planar
        # (T, 3, H, W) -> interleaved; uint8 stays 0-255 (clip*255 on
        # u8 data would near-binarize every pixel).
        if frames.ndim == 4 and frames.shape[1] == 3 \
                and frames.shape[-1] != 3:
            frames = np.moveaxis(frames, 1, -1)
        if frames.dtype != np.uint8:
            frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
        iio.imwrite(path, frames)
    except ImportError as e:
        raise RuntimeError(
            f"cannot write {path!r}: only .npy/.npz/.y4m supported without imageio"
        ) from e
