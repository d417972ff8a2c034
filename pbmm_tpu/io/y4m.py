"""YUV4MPEG2 (.y4m) reader/writer — pure numpy, zero dependencies.

The reference has no video I/O (frames come from Unity's renderer,
`OnRenderImage`); for this offline framework .y4m is the lingua franca
uncompressed interchange format (`ffmpeg -i in.mp4 out.y4m`), so clips can
move in/out without optional decoders in the image.

Supports C420 (all jpeg/mpeg2/paldv siting variants, treated as co-sited
averages), C422 and C444, 8-bit.  Color math is BT.601 limited-range
("studio swing"), the same NTSC-era matrix family as the reference's YIQ
pipeline (`RGBToYIQ.shader:46-50`).
"""

from __future__ import annotations

import io
from typing import Iterator, Tuple

import numpy as np

# BT.601 limited-range YCbCr <-> full-range RGB (float in [0,1]).
_KR, _KG, _KB = 0.299, 0.587, 0.114


def _ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    yf = (y.astype(np.float32) - 16.0) / 219.0
    pb = (cb.astype(np.float32) - 128.0) / 224.0
    pr = (cr.astype(np.float32) - 128.0) / 224.0
    r = yf + 2.0 * (1.0 - _KR) * pr
    b = yf + 2.0 * (1.0 - _KB) * pb
    g = (yf - _KR * r - _KB * b) / _KG
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def _rgb_to_ycbcr(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rgb = np.clip(rgb.astype(np.float32), 0.0, 1.0)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    yf = _KR * r + _KG * g + _KB * b
    pb = (b - yf) / (2.0 * (1.0 - _KB))
    pr = (r - yf) / (2.0 * (1.0 - _KR))
    y = np.clip(np.round(yf * 219.0 + 16.0), 0, 255).astype(np.uint8)
    cb = np.clip(np.round(pb * 224.0 + 128.0), 0, 255).astype(np.uint8)
    cr = np.clip(np.round(pr * 224.0 + 128.0), 0, 255).astype(np.uint8)
    return y, cb, cr


def _chroma_dims(w: int, h: int, cs: str) -> Tuple[int, int]:
    if cs.startswith("420"):
        return (w + 1) // 2, (h + 1) // 2
    if cs.startswith("422"):
        return (w + 1) // 2, h
    if cs.startswith("444"):
        return w, h
    raise ValueError(f"unsupported y4m colorspace C{cs}")


def _upsample(plane: np.ndarray, w: int, h: int) -> np.ndarray:
    """Nearest-neighbor chroma upsample to (h, w)."""
    ry = h // plane.shape[0] if plane.shape[0] else 1
    rx = w // plane.shape[1] if plane.shape[1] else 1
    return np.repeat(np.repeat(plane, ry, axis=0), rx, axis=1)[:h, :w]


def _downsample(plane: np.ndarray, cw: int, ch: int) -> np.ndarray:
    """Box-average chroma downsample from (h, w) to (ch, cw)."""
    h, w = plane.shape
    ry, rx = max(h // ch, 1), max(w // cw, 1)
    trimmed = plane[: ch * ry, : cw * rx].astype(np.float32)
    return trimmed.reshape(ch, ry, cw, rx).mean(axis=(1, 3))


def _read_exact(f, n: int) -> bytes:
    """Read exactly n bytes, looping over short reads (pipes/stdin deliver
    partial buffers)."""
    chunks = []
    got = 0
    while got < n:
        b = f.read(n - got)
        if not b:
            break
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def _read_line(f) -> bytes:
    """readline() that works on raw streams without universal newlines."""
    if hasattr(f, "readline"):
        return f.readline()
    out = bytearray()
    while True:
        b = f.read(1)
        if not b:
            break
        out += b
        if b == b"\n":
            break
    return bytes(out)


def read_y4m_planes(f, name: str = "<stream>", meta: dict = None
                    ) -> Iterator[
        Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield raw (y (H,W), cb (ch,cw), cr (ch,cw)) uint8 planes per frame
    from an open binary stream — the zero-conversion reader the
    device-decode streaming path builds on (planes cross host->device
    as ~1.5 bytes/px instead of 12 for decoded f32 RGB, and the chroma
    upsample + BT.601 matrix run on the device, `io.device_decode`).

    `meta`: optional dict populated from the header before the first
    frame is yielded ({"w", "h", "colorspace", "fps"}) — the pipe loop
    propagates the source frame rate to its output header (r5)."""
    header = _read_line(f).decode("ascii", "replace").strip()
    if not header.startswith("YUV4MPEG2"):
        raise ValueError(f"{name!r} is not a YUV4MPEG2 stream")
    w = h = 0
    cs = "420jpeg"
    fps = (30, 1)
    for tok in header.split()[1:]:
        if tok[0] == "W":
            w = int(tok[1:])
        elif tok[0] == "H":
            h = int(tok[1:])
        elif tok[0] == "C":
            cs = tok[1:]
        elif tok[0] == "F" and ":" in tok:
            num, den = tok[1:].split(":", 1)
            try:
                fps = (int(num), int(den))
            except ValueError:
                pass
    if not (w and h):
        raise ValueError(f"{name!r}: missing W/H in y4m header")
    if meta is not None:
        meta.update(w=w, h=h, colorspace=cs, fps=fps)
    cw, ch = _chroma_dims(w, h, cs)
    ysz, csz = w * h, cw * ch
    while True:
        marker = _read_line(f)
        if not marker:
            return
        if not marker.startswith(b"FRAME"):
            raise ValueError(f"{name!r}: bad frame marker {marker[:20]!r}")
        raw = _read_exact(f, ysz + 2 * csz)
        if len(raw) < ysz + 2 * csz:
            return
        y = np.frombuffer(raw, np.uint8, ysz).reshape(h, w)
        cb = np.frombuffer(raw, np.uint8, csz, ysz).reshape(ch, cw)
        cr = np.frombuffer(raw, np.uint8, csz, ysz + csz).reshape(ch, cw)
        yield y, cb, cr


def read_y4m_stream(f, name: str = "<stream>") -> Iterator[np.ndarray]:
    """Yield (H, W, 3) f32 RGB frames in [0, 1] from an open binary
    stream — frame at a time, never materializing the whole clip.  Works
    on non-seekable streams (pipes / stdin), the offline analog of the
    reference's live per-frame `OnRenderImage` feed
    (`MotionMagnificationProcessor.cs:101`)."""
    for y, cb, cr in read_y4m_planes(f, name):
        h, w = y.shape
        yield _ycbcr_to_rgb(y, _upsample(cb, w, h), _upsample(cr, w, h))


def read_y4m_frames(path: str) -> Iterator[np.ndarray]:
    """Yield (H, W, 3) f32 RGB frames in [0, 1] from a .y4m file."""
    with open(path, "rb") as f:
        yield from read_y4m_stream(f, path)


def load_y4m(path: str) -> np.ndarray:
    """-> (T, H, W, 3) f32 RGB in [0, 1]."""
    frames = list(read_y4m_frames(path))
    if not frames:
        raise ValueError(f"{path!r}: no frames")
    return np.stack(frames)


class Y4MStreamWriter:
    """Incremental y4m writer for the live pipe loop (r5): header on the
    first chunk, then frames as they are produced — the downstream
    consumer (a player, ffmpeg) starts rendering before the stream ends.

        ffmpeg -i in.mp4 -f yuv4mpegpipe - \
          | python -m pbmm_tpu.cli --input - --stream --output - \
          | mpv -

    closes the reference's interactive per-frame loop
    (`OnRenderImage`, `MotionMagnificationProcessor.cs:101`) as a
    process pipeline.  Accepts interleaved (n, H, W, 3) f32/u8 or planar
    (n, 3, H, W) chunks.
    """

    def __init__(self, f, fps: Tuple[int, int] = (30, 1),
                 colorspace: str = "444"):
        self._f = f
        self._fps = fps
        self._cs = colorspace
        self._started = False

    def write_chunk(self, frames: np.ndarray) -> None:
        frames = np.asarray(frames)
        if frames.ndim == 4 and frames.shape[1] == 3 \
                and frames.shape[-1] != 3:
            frames = np.moveaxis(frames, 1, -1)
        if frames.dtype == np.uint8:
            frames = frames.astype(np.float32) / 255.0
        t, h, w = frames.shape[:3]
        cw, ch = _chroma_dims(w, h, self._cs)
        if not self._started:
            self._f.write(
                f"YUV4MPEG2 W{w} H{h} F{self._fps[0]}:{self._fps[1]} "
                f"Ip A1:1 C{self._cs}\n".encode("ascii")
            )
            self._started = True
        for i in range(t):
            y, cb, cr = _rgb_to_ycbcr(frames[i])
            if (cw, ch) != (w, h):
                cb = np.clip(np.round(_downsample(cb, cw, ch)), 0, 255)
                cr = np.clip(np.round(_downsample(cr, cw, ch)), 0, 255)
            self._f.write(b"FRAME\n")
            self._f.write(y.astype(np.uint8).tobytes())
            self._f.write(cb.astype(np.uint8).tobytes())
            self._f.write(cr.astype(np.uint8).tobytes())
        self._f.flush()


def save_y4m(path: str, frames: np.ndarray, fps: Tuple[int, int] = (30, 1),
             colorspace: str = "444") -> None:
    """Write (T, H, W, 3) float RGB in [0, 1] — or the planar
    (T, 3, H, W) f32/uint8 layouts (`output_layout`, r5) — as 8-bit
    y4m."""
    frames = np.asarray(frames)
    if frames.ndim == 4 and frames.shape[1] == 3 and frames.shape[-1] != 3:
        frames = np.moveaxis(frames, 1, -1)
    if frames.dtype == np.uint8:
        frames = frames.astype(np.float32) / 255.0
    t, h, w = frames.shape[:3]
    cw, ch = _chroma_dims(w, h, colorspace)
    buf = io.BytesIO()
    buf.write(
        f"YUV4MPEG2 W{w} H{h} F{fps[0]}:{fps[1]} Ip A1:1 "
        f"C{colorspace}\n".encode("ascii")
    )
    for i in range(t):
        y, cb, cr = _rgb_to_ycbcr(frames[i])
        if (cw, ch) != (w, h):
            cb = np.clip(np.round(_downsample(cb, cw, ch)), 0, 255)
            cr = np.clip(np.round(_downsample(cr, cw, ch)), 0, 255)
        buf.write(b"FRAME\n")
        buf.write(y.astype(np.uint8).tobytes())
        buf.write(cb.astype(np.uint8).tobytes())
        buf.write(cr.astype(np.uint8).tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())
