"""ctypes bindings for the native streaming frame loader.

Builds `libpbmm_native.so` from `frameloader.cpp` on first use (g++ -O3,
cached next to the source); everything degrades gracefully to numpy when no
compiler is available (`native_available()` -> False).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "frameloader.cpp")
_LIB = os.path.join(_HERE, "libpbmm_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    # Build into a private file and rename it into place: processes that
    # build at the same time (test workers) never load a half-written
    # library.
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (subprocess.SubprocessError, OSError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            if not _build():
                _build_failed = True
                return None
        lib = ctypes.CDLL(_LIB)
        lib.fl_open.restype = ctypes.c_void_p
        lib.fl_open.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.fl_info.restype = ctypes.c_int
        lib.fl_info.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_long)
        ] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.fl_next.restype = ctypes.c_long
        lib.fl_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float)]
        lib.fl_close.restype = None
        lib.fl_close.argtypes = [ctypes.c_void_p]
        lib.convert_u8_to_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
        ]
        lib.rgb_to_yiq_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeFrameLoader:
    """Streaming .npy reader with background prefetch + u8->f32 conversion
    in native code.  Iterate chunks of (n, H, W, 3) f32 arrays."""

    def __init__(self, path: str, chunk_frames: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable (no g++?)")
        self._lib = lib
        self._h = lib.fl_open(path.encode(), chunk_frames)
        if not self._h:
            raise ValueError(
                f"cannot open {path!r}: need .npy THWC u8/f32 C-order"
            )
        t = ctypes.c_long()
        hh = ctypes.c_long()
        w = ctypes.c_long()
        c = ctypes.c_long()
        dt = ctypes.c_int()
        lib.fl_info(self._h, t, hh, w, c, dt)
        self.num_frames = t.value
        self.shape = (hh.value, w.value, c.value)
        self.chunk_frames = chunk_frames

    def __iter__(self):
        buf = np.empty((self.chunk_frames,) + self.shape, np.float32)
        while True:
            n = self._lib.fl_next(
                self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            )
            if n <= 0:
                return
            yield buf[:n].copy()

    def close(self):
        if self._h:
            self._lib.fl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def convert_u8_frames(frames_u8: np.ndarray) -> np.ndarray:
    """u8 -> f32/255 via the native loop (falls back to numpy)."""
    lib = _load()
    frames_u8 = np.ascontiguousarray(frames_u8)
    if lib is None:
        return frames_u8.astype(np.float32) / 255.0
    out = np.empty(frames_u8.shape, np.float32)
    lib.convert_u8_to_f32(
        frames_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames_u8.size,
    )
    return out
