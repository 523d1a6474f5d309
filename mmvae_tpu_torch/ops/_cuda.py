"""Build and bind the port's CUDA kernels.

Every ``mmvae_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library with a plain C interface, at first
use, into ``build/mmvae_tpu_torch/`` under the checkout; it is rebuilt
whenever a source is newer than the library.  The library is loaded with
``ctypes``: every pointer and the CUDA stream go in as ``c_void_p`` (a
pointer passed without argtypes is cut to 32 bits), and every C entry
returns ``cudaGetLastError()`` after its launch, which :func:`check`
turns into an exception.

Nothing here runs at import time: the CPU tests import every module, and
the CPU host has no ``nvcc``.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mmvae_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libmmvae_torch_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_int64


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "of mmvae_tpu_torch are built from source at first use")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources())


def build(force: bool = False) -> str:
    """Compile the kernel library if missing or stale; return its path.

    The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept in :data:`BUILD_LOG`."""
    if not force and not _stale():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()],
                           capture_output=True, text=True, timeout=900)
        with open(BUILD_LOG, "w") as f:
            f.write(r.stdout + r.stderr)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({r.returncode}):\n{r.stderr[-4000:]}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIB_PATH


def _bind(lib) -> None:
    lib.mmvae_count_encode_fwd.argtypes = [
        _vp, _i32, _i64, _i64,   # x, dtype code, M, D
        _vp, _i32, _vp, _i32,    # WL, nl, WX, nx
        _vp, _i64, _vp, _i64,    # hL, ldl, hX, ldx
        _vp,                     # cudaStream_t
    ]
    lib.mmvae_count_encode_fwd.restype = _i32


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            _bind(handle)
            _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
