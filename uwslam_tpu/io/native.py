"""ctypes bindings for the native C++ loader (native/loader.cpp).

A thread-pool decoder (libpng/libjpeg/PGM) with a bounded in-order ring so
disk I/O and decode overlap device compute (the reference decodes with a
blocking cv::imread, /root/reference/src/System.cpp:228).

The shared library is not shipped: it is built from native/loader.cpp at
first use into native/build/ (g++ with libpng16/libjpeg headers). Several
processes may build at once: each compiles into its own temporary file and
renames it into place. A failed build or load means "not available", and
callers fall back (io.dataset decodes PGM in numpy, other formats by Pillow).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SRC = os.path.abspath(os.path.join(_NATIVE_DIR, "loader.cpp"))
LIB_PATH = os.path.abspath(
    os.path.join(_NATIVE_DIR, "build", "libuwslam_native.so")
)

_lib = None
_tried = False


def _build() -> str | None:
    """Path of an up-to-date library, compiling it if needed; None if the
    source or a compiler is missing or the build fails."""
    if os.path.exists(LIB_PATH) and (
        not os.path.exists(_SRC)
        or os.path.getmtime(LIB_PATH) >= os.path.getmtime(_SRC)
    ):
        return LIB_PATH
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None or not os.path.exists(_SRC):
        return None
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        prefix=".libuwslam_native.", suffix=".so",
        dir=os.path.dirname(LIB_PATH),
    )
    os.close(fd)
    cmd = [cxx, "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp, _SRC,
           "-lpng16", "-ljpeg", "-lz", "-lpthread"]
    try:
        ok = subprocess.run(cmd, capture_output=True, timeout=300).returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        ok = False
    if not ok:
        os.unlink(tmp)
        return None
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.uws_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.uws_decode.restype = ctypes.c_int
    lib.uws_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.uws_loader_create.restype = ctypes.c_void_p
    lib.uws_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.uws_loader_next.restype = ctypes.c_int
    lib.uws_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


MAX_PIXELS = 4096 * 4096


def decode(path: str) -> np.ndarray:
    """Decode one image to float32 grayscale (native; raises on failure)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader not available (see io.native)")
    buf = np.empty(MAX_PIXELS, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.uws_decode(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        MAX_PIXELS,
        ctypes.byref(w),
        ctypes.byref(h),
    )
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class NativeLoader:
    """In-order multithreaded prefetching image loader.

    Iterate -> (index, float32 image). Decoding of frame i+lookahead proceeds
    while frame i is consumed."""

    def __init__(self, paths: list[str], lookahead: int = 8, threads: int = 2):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader not available (see io.native)")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.uws_loader_create(
            arr, len(self._paths), lookahead, threads
        )
        self._buf = np.empty(MAX_PIXELS, np.float32)

    def __iter__(self):
        while True:
            idx = ctypes.c_int()
            w = ctypes.c_int()
            h = ctypes.c_int()
            rc = self._lib.uws_loader_next(
                self._handle,
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                MAX_PIXELS,
                ctypes.byref(idx),
                ctypes.byref(w),
                ctypes.byref(h),
            )
            if rc == 1:
                return
            if rc < 0:
                raise IOError(f"native loader error {rc} at frame {idx.value}")
            yield idx.value, (
                self._buf[: w.value * h.value]
                .reshape(h.value, w.value)
                .copy()
            )

    def close(self):
        if self._handle:
            self._lib.uws_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
