"""Build and load the port's CUDA kernels (`csrc/*.cu`) on first use.

The sources are compiled with `nvcc -gencode arch=compute_90a,code=sm_90a`
into one shared library with a plain C interface, and loaded with `ctypes`.
The library lands in `multi_orb_slam_tpu_torch/_build/` under a name that
hashes the sources and flags, so an edited source rebuilds and an unchanged
one loads at once.  Only the repository's own sources are compiled.

Nothing here runs at import: `load()` is called by the kernel wrappers in
`ops/kernels.py` the first time a kernel is launched on a CUDA tensor.  A
missing `nvcc` or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (all return cudaError_t as int)
SIGNATURES = {
    "fast_score_launch": [_P, _P, _P, _P, _I, _I, _I, _P],
    "gather_patches_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "window_match_launch": [_P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                            _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; cached per process.

    The compiler's report (`-Xptxas -v`: registers, shared memory, spills
    per kernel) is kept beside the library as `<name>.log`.
    """
    srcs = sources()
    lib_path = BUILD_DIR / f"libmost_kernels_{_digest(srcs)}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        lib_path.with_suffix(".log").write_text(
            f"build seconds: {time.perf_counter() - t0:.2f}\n"
            f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    """The compiler report of the loaded library ('' if not built here)."""
    log = BUILD_DIR / f"libmost_kernels_{_digest(sources())}.log"
    return log.read_text() if log.exists() else ""
