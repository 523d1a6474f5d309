"""Build and bind the port's CUDA kernels.

Every ``mmvae_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and the
objects are linked into ONE shared library with a plain C interface, at
first use, into ``build/mmvae_tpu_torch/`` under the checkout; it is
rebuilt whenever a source or header is newer than the library.  The
library is loaded with ``ctypes``: every pointer and the CUDA stream go
in as ``c_void_p`` (a pointer passed without argtypes is cut to 32
bits), and every C entry returns ``cudaGetLastError()`` after its
launches, which :func:`check` turns into an exception.

Nothing here runs at import time: the CPU tests import every module, and
the CPU host has no ``nvcc``.  A failed build raises.  Processes that
build at once (the ranks of a data-parallel run on one machine) take
turns on an exclusive ``flock`` of ``build.lock`` beside the library:
the first builds, the others find it fresh; the library is written
under a temporary name and renamed, so a half-written one never loads.
"""

from __future__ import annotations

import ctypes
import fcntl
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
BUILD_LOCK = os.path.join(BUILD_DIR, "build.lock")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

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
    deps = sources() + glob.glob(os.path.join(SRC_DIR, "*.cuh"))
    return any(os.path.getmtime(s) > built for s in deps)


def build(force: bool = False) -> str:
    """Compile the kernel library if missing or stale; return its path.

    The compilers' output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept in :data:`BUILD_LOG`.  Holds
    :data:`BUILD_LOCK` while it checks and builds."""
    if not force and not _stale():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(BUILD_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not force and not _stale():
            return LIB_PATH
        return _build()


def _build() -> str:
    nvcc = _nvcc()
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    objs = [os.path.join(BUILD_DIR, os.path.basename(s) + ".o")
            for s in sources()]
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources(), objs)]
        logs, failed = [], []
        for s, proc in zip(sources(), procs):
            out, _ = proc.communicate(timeout=900)
            logs.append(f"== {os.path.basename(s)}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(s)} ({proc.returncode}):"
                              f"\n{out[-4000:]}")
        if not failed:
            r = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                                *objs], capture_output=True, text=True,
                               timeout=300)
            logs.append(f"== link\n{r.stdout}{r.stderr}")
            if r.returncode != 0:
                failed.append(f"link ({r.returncode}):\n{r.stderr[-4000:]}")
        with open(BUILD_LOG, "w") as f:
            f.write("\n".join(logs))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, LIB_PATH)
    finally:
        for path in [tmp, *objs]:
            if os.path.exists(path):
                os.remove(path)
    return LIB_PATH


def _bind(lib) -> None:
    lib.mmvae_count_encode_fwd.argtypes = [
        _vp, _i32, _i64, _i64,   # x, dtype code, M, D
        _vp, _i32, _vp, _i32,    # WL, nl, WX, nx
        _vp, _i64, _vp, _i64,    # hL, ldl, hX, ldx
        _vp, _vp,                # row stats, filter (or null)
        _vp, _i64, _vp,          # workspace, its floats, stream
    ]
    lib.mmvae_count_encode_fwd.restype = _i32
    lib.mmvae_count_encode_bwd.argtypes = [
        _vp, _i32, _i64, _i64,   # x, dtype code, B, D
        _vp, _i32, _i64,         # g1, r1, ld1
        _vp, _i32, _i64,         # g2, r2, ld2
        _i32, _i32, _i32,        # the plan: fixed instance, tile, chunks
        _vp, _vp,                # dWL, dWX
        _vp, _i64, _vp,          # workspace, its floats, stream
    ]
    lib.mmvae_count_encode_bwd.restype = _i32
    rows = [_vp, _vp, _vp, _vp]  # zc, zn, depth, lse
    dims = [_i64, _i64, _i32, _i32, _i32]  # B, D, R, C, Rn
    # lse: zc, W, B, D, R, C, the plan (fixed instance, tile), ws, ws
    # floats, lse, stream
    lib.mmvae_nb_lse.argtypes = [_vp, _vp, _i64, _i64, _i32, _i32, _i32,
                                 _i32, _vp, _i64, _vp, _vp]
    # value: ..., with_const, joint, the plan (fixed instance, tile,
    # chunks), ws, ws floats, out, stream
    lib.mmvae_nb_value.argtypes = [_vp, _i32, *rows, _vp, *dims, _i32, _i32,
                                   _i32, _i32, _i32, _vp, _i64, _vp, _vp]
    # valgrad: ..., joint, need_value, the plan (fixed instance, tile,
    # chunks), gout, ws, ws floats, rowout, value, stream
    lib.mmvae_nb_valgrad.argtypes = [_vp, _i32, *rows, _vp, *dims, _i32,
                                     _i32, _i32, _i32, _i32, _vp, _vp, _i64,
                                     _vp, _vp, _vp]
    # finish: zc, lse, rsum, W, B, D, R, C, the plan (fixed instance,
    # tile, chunks), fout, ws, ws floats, u2, stream
    lib.mmvae_nb_finish.argtypes = [_vp, _vp, _vp, _vp, _i64, _i64, _i32,
                                    _i32, _i32, _i32, _i32, _vp, _vp, _i64,
                                    _vp, _vp]
    # elbo fwd: x, dtype, h, nu_pre, depth, B, D, with_const, the plan
    # (cluster, threads, slice, onchip), ws (the rows), ws floats, out,
    # stream; bwd: g, x, dtype, h, nu_pre, depth, lse, rowsum, B, D, the
    # plan's columns a block, dh, dnu, stream
    lib.mmvae_nb_elbo_fwd.argtypes = [_vp, _i32, _vp, _vp, _vp, _i64, _i64,
                                      _i32, _i32, _i32, _i64, _i32, _vp,
                                      _i64, _vp, _vp]
    lib.mmvae_nb_elbo_bwd.argtypes = [_vp, _vp, _i32, _vp, _vp, _vp, _vp,
                                      _vp, _i64, _i64, _i32, _vp, _vp, _vp]
    # roofline probe: x, B, D, op, nrep, chains, reps, out, stream
    lib.mmvae_roofline_elementwise.argtypes = [_vp, _i64, _i64, _i32, _i32,
                                               _i32, _i32, _vp, _vp]
    for name in ("mmvae_nb_lse", "mmvae_nb_value", "mmvae_nb_valgrad",
                 "mmvae_nb_finish", "mmvae_nb_elbo_fwd", "mmvae_nb_elbo_bwd",
                 "mmvae_roofline_elementwise"):
        getattr(lib, name).restype = _i32


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            from ..utils.profiling import annotate

            with annotate("kernels.load"):
                handle = ctypes.CDLL(build())
                _bind(handle)
            _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
