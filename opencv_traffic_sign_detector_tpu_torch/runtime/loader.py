"""ctypes binding for the native JPEG loader (with transparent fallback).

The port's own copy of ``opencv_traffic_sign_detector_tpu/runtime/
loader.py`` with its own copy of ``loader.cpp``.  The library is built with
g++ against libjpeg at first use into ``build/loader/<hash>/`` at the
repository root (git-ignored), keyed by a hash of the source and flags,
never beside the source.  ``available()`` is False when the build fails
(no g++ or no libjpeg headers); callers (data/images.py) then fall back to
PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name("loader.cpp")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "loader"
LIB_NAME = "libtsd_loader.so"
GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
_lib = None
_tried = False


def build() -> Path | None:
    """Compile ``loader.cpp`` unless this source hash is already built;
    None when the compiler or libjpeg is missing."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    lib_path = BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME
    if lib_path.exists():
        return lib_path
    try:
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
            tmp_lib = os.path.join(tmp, LIB_NAME)
            res = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp_lib,
                                  "-ljpeg", "-lpthread"],
                                 capture_output=True, text=True, timeout=120)
            if res.returncode != 0:
                return None
            os.replace(tmp_lib, lib_path)  # atomic: concurrent builds agree
    except (OSError, subprocess.TimeoutExpired):
        return None
    return lib_path


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.tsd_decode_jpeg_bgr.restype = ctypes.c_int
    lib.tsd_decode_jpeg_bgr.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.tsd_decode_jpeg_bgr_batch.restype = ctypes.c_int
    lib.tsd_decode_jpeg_bgr_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    if hasattr(lib, "tsd_decode_jpeg_bgr_patches8_batch"):
        lib.tsd_decode_jpeg_bgr_patches8_batch.restype = ctypes.c_int
        lib.tsd_decode_jpeg_bgr_patches8_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
    if hasattr(lib, "tsd_decode_jpeg_yuv420"):
        lib.tsd_decode_jpeg_yuv420.restype = ctypes.c_int
        lib.tsd_decode_jpeg_yuv420.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.tsd_decode_jpeg_yuv420_batch.restype = ctypes.c_int
        lib.tsd_decode_jpeg_yuv420_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
    if hasattr(lib, "tsd_decode_jpeg_yuv420_patches_batch"):
        lib.tsd_decode_jpeg_yuv420_patches_batch.restype = ctypes.c_int
        lib.tsd_decode_jpeg_yuv420_patches_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def probe_size(path: str) -> tuple[int, int] | None:
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int32(0)
    w = ctypes.c_int32(0)
    rc = lib.tsd_decode_jpeg_bgr(
        path.encode(), None, 0, ctypes.byref(h), ctypes.byref(w)
    )
    return (h.value, w.value) if rc == 0 else None


def decode_jpeg_bgr(path: str) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    size = probe_size(path)
    if size is None:
        return None
    h, w = size
    buf = np.empty((h, w, 3), np.uint8)
    oh = ctypes.c_int32(0)
    ow = ctypes.c_int32(0)
    rc = lib.tsd_decode_jpeg_bgr(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        buf.nbytes,
        ctypes.byref(oh),
        ctypes.byref(ow),
    )
    return buf if rc == 0 else None


def decode_jpeg_bgr_batch(
    paths: list[str], n_threads: int | None = None
) -> list[np.ndarray] | None:
    """Decode same-sized JPEGs in parallel; None on any setup failure."""
    lib = _load()
    if lib is None or not paths:
        return None
    size = probe_size(paths[0])
    if size is None:
        return None
    h, w = size
    n = len(paths)
    buf = np.empty((n, h, w, 3), np.uint8)
    status = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    bad = lib.tsd_decode_jpeg_bgr_batch(
        arr,
        n,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h,
        w,
        n_threads,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if bad:  # mixed sizes or decode errors: let the caller fall back
        return None
    return [buf[i] for i in range(n)]


def decode_jpeg_bgr_patches8_batch(
    paths: list[str], n_threads: int | None = None
) -> np.ndarray | None:
    """Threaded decode of same-sized JPEGs into the ``patches8`` layout
    [n, h/8, w/8, 192] uint8 (k = ky*24 + kx*3 + c — flattened HWIO).

    Same bytes as the BGR batch, repacked at decode time so the stem
    consumes them as one K=192 matmul with zero on-device relayout
    (models/cnn_detector.py: _PatchifyStem).  None on failure or when
    h or w is not a multiple of 8 (caller falls back to BGR)."""
    lib = _load()
    if (lib is None or not paths
            or not hasattr(lib, "tsd_decode_jpeg_bgr_patches8_batch")):
        return None
    size = probe_size(paths[0])
    if size is None:
        return None
    h, w = size
    if h % 8 or w % 8:
        return None
    n = len(paths)
    buf = np.empty((n, h // 8, w // 8, 192), np.uint8)
    status = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    bad = lib.tsd_decode_jpeg_bgr_patches8_batch(
        arr,
        n,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h,
        w,
        n_threads,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return None if bad else buf


def decode_jpeg_yuv420(
    path: str,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Raw 4:2:0 planes (y [h,w], cb/cr [(h+1)//2,(w+1)//2]) — half the
    bytes of BGR across the host->device link; convert on device with
    ops.yuv.yuv420_to_bgr.  None if the library or the file's sampling
    layout is unavailable (caller falls back to decode_jpeg_bgr)."""
    lib = _load()
    if lib is None or not hasattr(lib, "tsd_decode_jpeg_yuv420"):
        return None
    size = probe_size(path)
    if size is None:
        return None
    h, w = size
    y = np.empty((h, w), np.uint8)
    cb = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    cr = np.empty_like(cb)
    rc = lib.tsd_decode_jpeg_yuv420(
        path.encode(),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h,
        w,
    )
    return (y, cb, cr) if rc == 0 else None


def decode_jpeg_yuv420_patches_batch(
    paths: list[str], n_threads: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Threaded raw-plane decode straight into the patchified layouts
    (y [n, h/8, w/8, 64], cb/cr [n, h/8, w/8, 16]) — same 1.5 bytes/px as
    the tight planes, zero on-device relayout (consumed by
    ops/yuv.py: yuv420_patches_to_bgr_patches8).  None on any failure
    (caller falls back to tight planes + host repack, then to BGR)."""
    lib = _load()
    if (lib is None or not paths
            or not hasattr(lib, "tsd_decode_jpeg_yuv420_patches_batch")):
        return None
    size = probe_size(paths[0])
    if size is None:
        return None
    h, w = size
    if h % 8 or w % 8:
        return None
    n = len(paths)
    y = np.empty((n, h // 8, w // 8, 64), np.uint8)
    cb = np.empty((n, h // 8, w // 8, 16), np.uint8)
    cr = np.empty_like(cb)
    status = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    bad = lib.tsd_decode_jpeg_yuv420_patches_batch(
        arr,
        n,
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h,
        w,
        n_threads,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if bad:
        return None
    return y, cb, cr


def decode_jpeg_yuv420_batch(
    paths: list[str], n_threads: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Threaded raw-plane decode of same-sized JPEGs.

    Returns (y [n,h,w], cb [n,ch,cw], cr [n,ch,cw]) or None on any failure
    (mixed sizes, unsupported sampling — caller falls back to the BGR
    batch path)."""
    lib = _load()
    if lib is None or not paths or not hasattr(lib, "tsd_decode_jpeg_yuv420"):
        return None
    size = probe_size(paths[0])
    if size is None:
        return None
    h, w = size
    n = len(paths)
    y = np.empty((n, h, w), np.uint8)
    cb = np.empty((n, (h + 1) // 2, (w + 1) // 2), np.uint8)
    cr = np.empty_like(cb)
    status = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    bad = lib.tsd_decode_jpeg_yuv420_batch(
        arr,
        n,
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h,
        w,
        n_threads,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if bad:
        return None
    return y, cb, cr
