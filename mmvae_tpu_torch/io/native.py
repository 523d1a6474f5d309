"""ctypes bridge to the native IO extension (csrc/mmvae_io.cc).

Loads ``_native.so`` from ``build/mmvae_tpu_torch/`` under the checkout,
building it there with g++ on first use if the toolchain is available.  Every entry point has a
pure-Python fallback in ``mmvae_tpu_torch.io.mtx`` / ``.index``; callers use
:func:`available` to pick the path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))
# built beside the CUDA kernels, never inside a package directory
_SO = os.path.join(_ROOT, "build", "mmvae_tpu_torch", "_native.so")
_SRC = os.path.join(_ROOT, "csrc", "mmvae_io.cc")

_lock = threading.Lock()
_lib = None
_tried = False

_i64 = ctypes.c_int64
_pi64 = ctypes.POINTER(ctypes.c_int64)
_pf32 = ctypes.POINTER(ctypes.c_float)


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    # compile to a private name, then rename: test workers may build at once
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread",
             "-shared", _SRC, "-lz", "-o", tmp],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            if not _build() and not os.path.exists(_SO):
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None

        try:
            _bind(lib)
        except AttributeError:
            # stale _native.so missing newer entry points and no working
            # toolchain to rebuild: fall back to pure Python
            return None
        _lib = lib
        return _lib


def _bind(lib) -> None:
        lib.mmvae_free.argtypes = [ctypes.c_void_p]
        lib.mmvae_free.restype = None
        lib.mmvae_peek_header.argtypes = [ctypes.c_char_p, _pi64]
        lib.mmvae_peek_header.restype = ctypes.c_int
        lib.mmvae_build_index.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(_pi64),
            ctypes.POINTER(_pi64),
        ]
        lib.mmvae_build_index.restype = _i64
        lib.mmvae_read_block.argtypes = [
            ctypes.c_char_p, _i64, _i64,
            ctypes.POINTER(_pi64), ctypes.POINTER(_pi64),
            ctypes.POINTER(_pf32),
        ]
        lib.mmvae_read_block.restype = _i64
        lib.mmvae_read_batch.argtypes = [
            ctypes.c_char_p,
            _pi64, _pi64, _i64,        # begs, ends, nblocks
            _pi64, _i64,               # ucols, nu
            _pi64, _pi64,              # dup_start, dup_flat
            _i64, _pf32,               # D, out
        ]
        lib.mmvae_read_batch.restype = _i64
        lib.mmvae_read_batch_mt.argtypes = (
            lib.mmvae_read_batch.argtypes + [ctypes.c_int]
        )
        lib.mmvae_read_batch_mt.restype = _i64
        _pi32 = ctypes.POINTER(ctypes.c_int32)
        lib.mmvae_read_csc.argtypes = [
            ctypes.c_char_p, _i64,
            ctypes.POINTER(_pi32), ctypes.POINTER(_pf32),
            ctypes.POINTER(_pi64),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.mmvae_read_csc.restype = _i64
        lib.mmvae_read_csc_mt.argtypes = [
            ctypes.c_char_p, _i64, _i64,
            _pi64, _pi64, _i64,        # begs, col_lo, nranges
            ctypes.POINTER(_pi32), ctypes.POINTER(_pf32),
            ctypes.POINTER(_pi64),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.mmvae_read_csc_mt.restype = _i64
        lib.mmvae_ell_fill.argtypes = [
            _pi32, _pf32, _pi64, _i64, _i64,
            _pi32, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.mmvae_ell_fill.restype = None
        lib.mmvae_dense_fill.argtypes = [
            _pi32, _pf32, _pi64, _i64,
            _pi64, _i64, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.mmvae_dense_fill.restype = None
        lib.mmvae_csr_fill.argtypes = [
            _pi32, _pf32, _pi64, _pi64, _i64, _i64, _i64,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.mmvae_csr_fill.restype = None


def available() -> bool:
    return _load() is not None


def peek_header(path: str) -> tuple[int, int, int]:
    lib = _load()
    dims = (ctypes.c_int64 * 3)()
    rc = lib.mmvae_peek_header(os.fspath(path).encode(), dims)
    if rc != 0:
        raise IOError(f"native peek_header failed for {path}")
    return int(dims[0]), int(dims[1]), int(dims[2])


def build_index(path: str) -> list[tuple[int, int]]:
    lib = _load()
    cols_p = _pi64()
    voffs_p = _pi64()
    n = lib.mmvae_build_index(
        os.fspath(path).encode(), ctypes.byref(cols_p), ctypes.byref(voffs_p)
    )
    if n == -2:
        raise ValueError("MTX must be sorted by columns")
    if n < 0:
        raise IOError(f"native build_index failed for {path}")
    try:
        cols = np.ctypeslib.as_array(cols_p, shape=(n,)).copy()
        voffs = np.ctypeslib.as_array(voffs_p, shape=(n,)).copy()
    finally:
        lib.mmvae_free(cols_p)
        lib.mmvae_free(voffs_p)
    return list(zip(cols.tolist(), voffs.tolist()))


def read_block(
    path: str, beg: int, end: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    lib = _load()
    rows_p, cols_p, vals_p = _pi64(), _pi64(), _pf32()
    n = lib.mmvae_read_block(
        os.fspath(path).encode(), beg, end,
        ctypes.byref(rows_p), ctypes.byref(cols_p), ctypes.byref(vals_p),
    )
    if n < 0:
        raise IOError(f"native read_block failed for {path}")
    try:
        if n == 0:
            return (
                np.zeros(0, np.int64),
                np.zeros(0, np.int64),
                np.zeros(0, np.float32),
            )
        rows = np.ctypeslib.as_array(rows_p, shape=(n,)).copy()
        cols = np.ctypeslib.as_array(cols_p, shape=(n,)).copy()
        vals = np.ctypeslib.as_array(vals_p, shape=(n,)).copy()
    finally:
        lib.mmvae_free(rows_p)
        lib.mmvae_free(cols_p)
        lib.mmvae_free(vals_p)
    return rows, cols, vals


def read_csc(path: str, ncols: int):
    """One-pass whole-file CSC read for column-sorted matrices.

    Returns (rows_i32, vals_f32, indptr_i64, stats) where stats =
    {"integral", "vmax", "vmin", "k_max"}; None when the file is not
    column-sorted (caller falls back to triplets + lexsort)."""
    lib = _load()
    _pi32 = ctypes.POINTER(ctypes.c_int32)
    rows_p, vals_p, indptr_p = _pi32(), _pf32(), _pi64()
    stats = (ctypes.c_double * 4)()
    n = lib.mmvae_read_csc(
        os.fspath(path).encode(), ncols,
        ctypes.byref(rows_p), ctypes.byref(vals_p),
        ctypes.byref(indptr_p), stats,
    )
    return _unpack_csc(lib, n, rows_p, vals_p, indptr_p, stats, ncols,
                       path)


def _unpack_csc(lib, n, rows_p, vals_p, indptr_p, stats, ncols, path):
    if n == -2:
        return None
    if n < 0:
        raise IOError(f"native read_csc failed for {path}")
    try:
        rows = (np.ctypeslib.as_array(rows_p, shape=(n,)).copy()
                if n else np.zeros(0, np.int32))
        vals = (np.ctypeslib.as_array(vals_p, shape=(n,)).copy()
                if n else np.zeros(0, np.float32))
        indptr = np.ctypeslib.as_array(indptr_p, shape=(ncols + 1,)).copy()
    finally:
        if n:
            lib.mmvae_free(rows_p)
            lib.mmvae_free(vals_p)
        lib.mmvae_free(indptr_p)
    return rows, vals, indptr, {
        "integral": bool(stats[0]),
        "vmax": float(stats[1]),
        "vmin": float(stats[2]),
        "k_max": int(stats[3]),
    }


def read_csc_threaded(path: str, ncols: int, nrows: int, idx_file: str,
                      nthreads: int | None = None):
    """Threaded :func:`read_csc`: the column index partitions the file
    into column-disjoint voffset ranges parsed in parallel, each with a
    private BGZF reader; the merge reproduces the serial reader's
    output bitwise (ranges tile the file in order).  Designed for
    multi-core TPU hosts where the one-pass parse is the cold-start
    bottleneck.  Returns None when threading is not applicable (one
    usable range, missing index) or when the index and file disagree —
    callers fall back to :func:`read_csc`."""
    lib = _load()
    if nthreads is None:
        nthreads = decode_threads()
    if nthreads <= 1:
        return None
    from .index import read_mmutil_index
    from .mtx import header_end_voffset

    try:
        tab = read_mmutil_index(idx_file)
    except (OSError, ValueError):
        return None
    start0 = header_end_voffset(path)
    col_lo = [0]
    begs = [int(start0)]
    for k in range(1, int(nthreads)):
        c = k * ncols // int(nthreads)
        if c >= len(tab) or c <= col_lo[-1]:
            continue
        off = int(tab[c])
        if off > begs[-1]:
            col_lo.append(int(c))
            begs.append(off)
    if len(begs) < 2:
        return None
    begs_a = np.asarray(begs, np.int64)
    lo_a = np.asarray(col_lo, np.int64)
    _pi32 = ctypes.POINTER(ctypes.c_int32)
    rows_p, vals_p, indptr_p = _pi32(), _pf32(), _pi64()
    stats = (ctypes.c_double * 4)()
    n = lib.mmvae_read_csc_mt(
        os.fspath(path).encode(), ncols, nrows,
        begs_a.ctypes.data_as(_pi64), lo_a.ctypes.data_as(_pi64),
        len(begs),
        ctypes.byref(rows_p), ctypes.byref(vals_p),
        ctypes.byref(indptr_p), stats,
    )
    return _unpack_csc(lib, n, rows_p, vals_p, indptr_p, stats, ncols,
                       path)


def ell_fill(rows: np.ndarray, vals: np.ndarray, indptr: np.ndarray,
             k_max: int, val_dtype) -> tuple[np.ndarray, np.ndarray]:
    """Padded-ELL (ncols, k_max) arrays filled in one native pass."""
    lib = _load()
    _pi32 = ctypes.POINTER(ctypes.c_int32)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    ncols = len(indptr) - 1
    vd = np.dtype(val_dtype)
    code = {"float32": 0, "int16": 1, "int8": 2}[vd.name]
    ell_rows = np.empty((ncols, k_max), np.int32)
    ell_vals = np.empty((ncols, k_max), vd)
    lib.mmvae_ell_fill(
        rows.ctypes.data_as(_pi32), vals.ctypes.data_as(_pf32),
        indptr.ctypes.data_as(_pi64), ncols, k_max,
        ell_rows.ctypes.data_as(_pi32),
        ell_vals.ctypes.data_as(ctypes.c_void_p), code,
    )
    return ell_rows, ell_vals


def dense_fill(rows: np.ndarray, vals: np.ndarray, indptr: np.ndarray,
               D: int, val_dtype, order: np.ndarray | None = None
               ) -> np.ndarray:
    """Whole-matrix host densify: (nrows, D) in val_dtype, one C pass.

    ``order`` reorders output rows (row i <- column order[i])."""
    lib = _load()
    _pi32 = ctypes.POINTER(ctypes.c_int32)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    ncols = len(indptr) - 1
    vd = np.dtype(val_dtype)
    code = {"float32": 0, "int16": 1, "int8": 2}[vd.name]
    nrows = ncols if order is None else len(order)
    out = np.zeros((nrows, D), vd)
    order_p = None
    if order is not None:
        order = np.ascontiguousarray(order, dtype=np.int64)
        order_p = order.ctypes.data_as(_pi64)
    lib.mmvae_dense_fill(
        rows.ctypes.data_as(_pi32), vals.ctypes.data_as(_pf32),
        indptr.ctypes.data_as(_pi64), D,
        order_p, nrows, out.ctypes.data_as(ctypes.c_void_p), code,
    )
    return out


def csr_fill(rows: np.ndarray, vals: np.ndarray, indptr: np.ndarray,
             ids: np.ndarray, B: int, nnz_pad: int, row_dtype,
             idx_dtype, val_dtype
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batch-packed CSR shard fill (rotation tier, data/shards.py):
    (nb, nnz_pad) triplet arrays in one native pass."""
    lib = _load()
    _pi32 = ctypes.POINTER(ctypes.c_int32)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    nb = len(ids) // B
    rbd, cid, vd = (np.dtype(row_dtype), np.dtype(idx_dtype),
                    np.dtype(val_dtype))
    rb_code = {"int8": 0, "int16": 1}[rbd.name]
    cid_code = {"int16": 0, "int32": 1}[cid.name]
    v_code = {"float32": 0, "int16": 1, "int8": 2}[vd.name]
    rows_b = np.empty((nb, nnz_pad), rbd)
    cols = np.empty((nb, nnz_pad), cid)
    out_vals = np.empty((nb, nnz_pad), vd)
    lib.mmvae_csr_fill(
        rows.ctypes.data_as(_pi32), vals.ctypes.data_as(_pf32),
        indptr.ctypes.data_as(_pi64), ids.ctypes.data_as(_pi64),
        len(ids), B, nnz_pad,
        rows_b.ctypes.data_as(ctypes.c_void_p), rb_code,
        cols.ctypes.data_as(ctypes.c_void_p), cid_code,
        out_vals.ctypes.data_as(ctypes.c_void_p), v_code,
    )
    return rows_b, cols, out_vals


def decode_threads() -> int:
    """Decoder thread count for the streaming batch reader: the CPU
    count by default (the design target is a multi-core TPU host
    feeding several chips), clamped by MMVAE_DECODE_THREADS.

    The default leaves headroom for the training process's own XLA
    host threads and the prefetch thread — cpu_count - 2, capped at 8
    (several prefetched batch reads run concurrently, so per-call
    width times prefetch depth is the real footprint)."""
    env = os.environ.get("MMVAE_DECODE_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            from ..utils.logging import WLOG

            WLOG(f"ignoring non-integer MMVAE_DECODE_THREADS={env!r}")
    return max(1, min(8, (os.cpu_count() or 1) - 2))


def read_batch(
    path: str,
    begs: np.ndarray,
    ends: np.ndarray,
    ucols: np.ndarray,
    dup_start: np.ndarray,
    dup_flat: np.ndarray,
    out: np.ndarray,
    nthreads: int | None = None,
) -> int:
    """Fused block-read + scatter into the (B, D) row-major batch
    buffer.  Block ranges decode across ``nthreads`` native threads
    (default :func:`decode_threads`); output is thread-count-invariant
    because each requested column lives in exactly one range."""
    lib = _load()
    begs = np.ascontiguousarray(begs, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    ucols = np.ascontiguousarray(ucols, dtype=np.int64)
    dup_start = np.ascontiguousarray(dup_start, dtype=np.int64)
    dup_flat = np.ascontiguousarray(dup_flat, dtype=np.int64)
    assert out.dtype == np.float32 and out.flags.c_contiguous
    if nthreads is None:
        nthreads = decode_threads()
    n = lib.mmvae_read_batch_mt(
        os.fspath(path).encode(),
        begs.ctypes.data_as(_pi64), ends.ctypes.data_as(_pi64), len(begs),
        ucols.ctypes.data_as(_pi64), len(ucols),
        dup_start.ctypes.data_as(_pi64), dup_flat.ctypes.data_as(_pi64),
        out.shape[1], out.ctypes.data_as(_pf32), int(nthreads),
    )
    if n < 0:
        raise IOError(f"native read_batch failed for {path}")
    return int(n)
