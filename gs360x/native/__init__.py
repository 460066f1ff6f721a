"""ctypes bindings for the C++ host library (``native/gs360x_native.cpp``).

Builds the shared library on first import when a compiler is available and
caches it next to this package; every consumer degrades gracefully to the
numpy implementation when ``HAS_NATIVE`` is False (no toolchain, build
failure, unusual platform).
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import sys
from typing import Optional, Tuple

import numpy as np

_PKG_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _PKG_DIR.parent.parent / "native" / "gs360x_native.cpp"
_LIB_PATH = _PKG_DIR / "libgs360x_native.so"

_lib: Optional[ctypes.CDLL] = None
HAS_NATIVE = False


class AviInfo(ctypes.Structure):
    _fields_ = [("width", ctypes.c_int32), ("height", ctypes.c_int32),
                ("fps_num", ctypes.c_int32), ("fps_den", ctypes.c_int32),
                ("n_frames", ctypes.c_int64)]


def _build() -> bool:
    if not _SRC.exists() or shutil.which("g++") is None:
        return False
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", str(_LIB_PATH), str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        return True
    except (subprocess.SubprocessError, OSError):
        return False


def _load() -> None:
    global _lib, HAS_NATIVE
    if not _LIB_PATH.exists() or (
            _SRC.exists()
            and _SRC.stat().st_mtime > _LIB_PATH.stat().st_mtime):
        if not _build():
            return
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return
    i64 = ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.gs_yuv444_to_rgb.argtypes = [u8p, u8p, i64, i64]
    lib.gs_yuv420_to_rgb.argtypes = [u8p, u8p, i64, i64]
    lib.gs_avi_scan.argtypes = [u8p, i64, ctypes.POINTER(i64),
                                ctypes.POINTER(i64), i64,
                                ctypes.POINTER(AviInfo)]
    lib.gs_avi_scan.restype = i64
    _lib = lib
    HAS_NATIVE = True


_load()


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def yuv444_to_rgb(yuv_planar: np.ndarray) -> np.ndarray:
    """(3, H, W) limited-range BT.601 → (H, W, 3) RGB."""
    yuv_planar = np.ascontiguousarray(yuv_planar, np.uint8)
    _, h, w = yuv_planar.shape
    if not HAS_NATIVE:
        from gs360x.io.video import yuv601_to_rgb

        return yuv601_to_rgb(np.moveaxis(yuv_planar, 0, -1))
    out = np.empty((h, w, 3), np.uint8)
    _lib.gs_yuv444_to_rgb(_u8p(yuv_planar), _u8p(out), h, w)
    return out


def yuv420_to_rgb(yuv_planar_bytes: np.ndarray, h: int, w: int) -> np.ndarray:
    """Flat (H*W*3//2,) planar 4:2:0 bytes → (H, W, 3) RGB."""
    buf = np.ascontiguousarray(yuv_planar_bytes, np.uint8)
    if not HAS_NATIVE:
        from gs360x.io.video import yuv601_to_rgb

        ysz, csz = h * w, h * w // 4
        y = buf[:ysz].reshape(h, w)
        u = np.repeat(np.repeat(buf[ysz:ysz + csz].reshape(h // 2, w // 2),
                                2, 0), 2, 1)
        v = np.repeat(np.repeat(buf[ysz + csz:].reshape(h // 2, w // 2),
                                2, 0), 2, 1)
        return yuv601_to_rgb(np.stack([y, u, v], -1))
    out = np.empty((h, w, 3), np.uint8)
    _lib.gs_yuv420_to_rgb(_u8p(buf), _u8p(out), h, w)
    return out


def avi_scan(data: bytes) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Scan AVI bytes for MJPEG frame chunks. Returns (offsets, sizes,
    info dict). Raises ValueError for non-AVI input."""
    arr = np.frombuffer(data, np.uint8)
    max_frames = max(16, len(data) // 1024)
    offsets = np.zeros(max_frames, np.int64)
    sizes = np.zeros(max_frames, np.int64)
    if not HAS_NATIVE:
        raise RuntimeError("native library unavailable")
    info = AviInfo()
    n = _lib.gs_avi_scan(_u8p(arr), len(data),
                         offsets.ctypes.data_as(
                             ctypes.POINTER(ctypes.c_int64)),
                         sizes.ctypes.data_as(
                             ctypes.POINTER(ctypes.c_int64)),
                         max_frames, ctypes.byref(info))
    if n < 0:
        raise ValueError("not an AVI file")
    return offsets[:n].copy(), sizes[:n].copy(), {
        "width": info.width, "height": info.height,
        "fps": info.fps_num / max(info.fps_den, 1),
        "n_frames": int(info.n_frames)}
