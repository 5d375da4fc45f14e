"""ctypes bindings to the native ingestion runtime (native/viso_native.cpp).

C++ PNG/PGM decoding plus a multi-threaded prefetch ring — the
reference's `FrameSequence` (frame_sequence.h:25-38) decoded on the
consumer thread; at >=10 FPS on KITTI-size frames decode must overlap
the accelerator step, which is what the native prefetcher provides.

Builds lazily via `make -C native` on first use; `available()` reports
whether the shared library could be built/loaded, and `require()`
raises with the reason (make's stderr) when it could not.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libviso_native.so"))

_lib = None
_load_error: str | None = None


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        if not os.path.exists(_LIB_PATH):
            # Build under a private name and rename into place: processes
            # that build at the same time never load a half-written file.
            tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
            build = subprocess.run(
                ["make", "-C", os.path.abspath(_NATIVE_DIR),
                 f"TARGET={os.path.basename(tmp)}"],
                capture_output=True,
                text=True,
            )
            if build.returncode != 0:
                raise RuntimeError(
                    f"make -C native failed ({build.returncode}): "
                    f"{build.stderr.strip()}"
                )
            os.replace(tmp, _LIB_PATH)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.viso_decode_gray.restype = ctypes.c_int
        lib.viso_decode_gray.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.viso_prefetcher_create.restype = ctypes.c_void_p
        lib.viso_prefetcher_create.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.viso_prefetcher_next.restype = ctypes.c_int
        lib.viso_prefetcher_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.viso_prefetcher_destroy.restype = None
        lib.viso_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    except (OSError, RuntimeError, AttributeError) as e:
        _load_error = str(e)
    return _lib


def available() -> bool:
    return _load() is not None


def require():
    """The loaded library; raises with the build/load error otherwise."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
    return lib


MAX_PIXELS = 4096 * 3072


def decode_gray(path: str) -> np.ndarray | None:
    """Decode a PNG/PGM file to (H, W) float32, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    buf = np.empty(MAX_PIXELS, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.viso_decode_gray(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(w),
        ctypes.byref(h),
        MAX_PIXELS,
    )
    if rc != 0:
        return None
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class Prefetcher:
    """In-order multi-threaded decode-ahead over a list of image paths."""

    def __init__(self, paths, ring: int = 8, threads: int = 2):
        lib = require()
        self._lib = lib
        blob = b"".join(p.encode() + b"\0" for p in paths) + b"\0"
        self._handle = lib.viso_prefetcher_create(
            blob, len(paths), ring, threads
        )
        self._n = len(paths)
        self._buf = np.empty(MAX_PIXELS, np.float32)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = self._lib.viso_prefetcher_next(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(w),
            ctypes.byref(h),
            MAX_PIXELS,
        )
        if rc == 1:
            raise StopIteration
        if rc != 0:
            raise IOError("native decode failed")
        return self._buf[: w.value * h.value].reshape(h.value, w.value).copy()

    def close(self):
        if self._handle:
            self._lib.viso_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
