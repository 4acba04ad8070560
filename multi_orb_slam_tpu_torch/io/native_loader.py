"""ctypes wrapper for the port's native asynchronous dataset loader.

Counterpart of `multi_orb_slam_tpu/io/native_loader.py`.  The C++ source is
the port's own copy, `csrc/dataloader.cc`; it is built with g++ (libpng,
libjpeg, zlib) into the git-ignored `_build/` at first use, under a name that
hashes the source and flags (`ops/_build.build_host_library`), and never
touches the reference package's files.  The loader is host I/O: a thread
pool decodes frames ahead of the consumer.

`native_available()` is False where the build fails (no compiler or no
libpng / libjpeg headers); `build_error()` then says why, and the drivers read
through `io/png.py` instead.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..ops import _build

SOURCE = _build.CSRC / "dataloader.cc"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-Wall"]
LIBS = ["-lpng", "-ljpeg", "-lz", "-pthread"]
_LIB = None
_ERROR = None
_LOCK = threading.Lock()


def _build_and_load():
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(_build.build_host_library(
                SOURCE, "libslamloader", CXX_FLAGS, LIBS)))
        except (RuntimeError, OSError) as e:
            _ERROR = str(e).strip() or type(e).__name__
            raise
        lib.dl_create.restype = ctypes.c_void_p
        lib.dl_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        lib.dl_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_float]
        lib.dl_next.restype = ctypes.c_int
        lib.dl_next.argtypes = [
            ctypes.c_void_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int]
        _LIB, _ERROR = lib, None
        return lib


def native_available() -> bool:
    """Whether the loader builds and loads here (built once per process)."""
    try:
        _build_and_load()
        return True
    except (RuntimeError, OSError):
        return False


def build_error():
    """Why the last build or load failed (None if it did not)."""
    return _ERROR


class AsyncRGBDLoader:
    """Prefetching iterator over (gray [H, W] f32, depth [H, W] f32) frames.

    `items`: list of (rgb_path, depth_path_or_None).  Frames are decoded by
    a native thread pool `prefetch` frames ahead and yielded in order; depth
    is divided by `depth_factor` (metres), and is all zeros without a depth
    path.
    """

    def __init__(self, items, height: int, width: int,
                 depth_factor: float = 5000.0,
                 n_threads: int = 2, prefetch: int = 6):
        self.items = list(items)
        self.h, self.w = height, width
        self.depth_factor = depth_factor
        self._lib = _build_and_load()
        self._handle = self._lib.dl_create(n_threads, prefetch)
        self._submitted = 0
        self._prefetch = prefetch

    def _submit_upto(self, n):
        while self._submitted < min(n, len(self.items)):
            rgb, dep = self.items[self._submitted]
            self._lib.dl_submit(
                self._handle, self._submitted, rgb.encode(),
                dep.encode() if dep else None,
                ctypes.c_float(self.depth_factor))
            self._submitted += 1

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        gray = np.empty((self.h, self.w), np.float32)
        depth = np.empty((self.h, self.w), np.float32)
        for i in range(len(self.items)):
            self._submit_upto(i + self._prefetch)
            depth[:] = 0.0
            r = self._lib.dl_next(
                self._handle, i,
                gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.h, self.w)
            if r != 1:
                raise IOError(f"failed to load frame {i}: {self.items[i]} (code {r})")
            yield gray.copy(), depth.copy()

    def close(self):
        if self._handle:
            self._lib.dl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
