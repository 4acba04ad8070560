"""Build and load the port's CUDA kernels (`csrc/*.cu`) on first use.

The sources are compiled with `nvcc -gencode arch=compute_90a,code=sm_90a`
(one `nvcc -c` per source, all started together) and linked into one shared
library with a plain C interface, loaded with `ctypes`.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (all return cudaError_t as int)
SIGNATURES = {
    "fast_score_launch": [_P, _P, _P, _P, _I, _I, _I, _P],
    "gather_patches_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "window_match_launch": [_P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                            _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "point_sums_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
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


def library_path(srcs: list[Path]) -> Path:
    return BUILD_DIR / f"libmost_kernels_{_digest(srcs)}.so"


def build_library(srcs: list[Path]) -> Path:
    """Compile `srcs` (if not built yet) into one shared library; returns
    its path.

    The compiler's report (`-Xptxas -v`: registers, shared memory, spills
    per kernel) is kept beside the library as `<name>.log`.
    """
    lib_path = library_path(srcs)
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{lib_path.stem}.{s.stem}.{os.getpid()}.o" for s in srcs]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)]
    report = "".join(p.communicate()[0] for p in procs)
    failed = [s.name for s, p in zip(srcs, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{report}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    lib_path.with_suffix(".log").write_text(
        f"build seconds: {time.perf_counter() - t0:.2f}\n{report}")
    os.replace(tmp, lib_path)
    return lib_path


def bind(lib_path: Path) -> ctypes.CDLL:
    """Load a kernel library and give its entry points their C types."""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Compile (if needed) and load the port's kernel library; cached per
    process."""
    return bind(build_library(sources()))


def build_log() -> str:
    """The compiler report of the loaded library ('' if not built here)."""
    return build_log_of(library_path(sources()))


def build_log_of(lib_path: Path) -> str:
    log = lib_path.with_suffix(".log")
    return log.read_text() if log.exists() else ""
