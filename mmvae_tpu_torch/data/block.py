"""Minibatch memory layer: random column subsets as dense (B, D) batches.

The DATA_BLOCK contract (ctor ``(mtx, idx, batch_size)``, ``read(subcol)``,
``clear()``, array view, ``size/nfeature/ntot/dim``) follows the
reference's two implementations:

- :class:`MtxDataBlock` — out-of-core: coalesce requested columns into
  nearby virtual-offset intervals (gap=10) and scatter the triplets of
  each interval into a preallocated row-major (B, D) buffer
  (reference: include/mmvae_io.hh:49-290).
- :class:`MtxMemoryBlock` — load everything once into an in-memory CSC
  matrix and densify requested columns from RAM
  (reference: include/mmvae_mem.hh:17-170).

Both yield float32 numpy (B, D) ready for ``jax.device_put``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..io.index import read_mmutil_index
from ..io.mtx import LAST_POS, peek_mtx_header, read_mtx_block
from ..io import native
from ..utils.logging import TLOG


def narrow_value_dtype(vals=None, stats: dict | None = None):
    """Narrowest lossless storage dtype for count values.

    Counts are non-negative integers in practice; int8/int16 storage
    halves-to-quarters HBM/host traffic and widens back to f32
    bit-exactly.  ``stats`` (from the native reader) avoids scanning
    ``vals``.  The single source of the int8<=127 / int16<=32767 rule.
    """
    if stats is not None:
        integral = stats["integral"]
        vmax, vmin = stats["vmax"], stats["vmin"]
    elif vals is not None and len(vals):
        vmax = float(vals.max())
        vmin = float(vals.min())
        integral = bool(np.all(vals == np.trunc(vals)))
    else:
        return np.float32
    if integral and vmin >= 0.0:
        if vmax <= 127.0:
            return np.int8
        if vmax <= 32767.0:
            return np.int16
    return np.float32


@dataclass(frozen=True)
class MemoryBlock:
    """One coalesced read interval (reference: memory_block_t,
    include/mmvae_io.hh:30-35)."""

    lb: int       # first column (inclusive)
    lb_mem: int   # virtual offset of lb's first line
    ub: int       # one-past-last column
    ub_mem: int   # virtual offset bound (LAST_POS = read to EOF)


def find_consecutive_blocks(
    index_tab: np.ndarray,
    subcol,
    gap: int = 10,
) -> list[MemoryBlock]:
    """Coalesce requested columns into read intervals.

    Nearby columns (within ``gap``) are fetched in one sequential BGZF
    scan rather than separate seeks — the reference's key I/O
    optimization (include/mmvae_io.hh:150-204).
    """
    n = len(index_tab)
    assert n > 1, "Empty index map"
    sorted_cols = np.sort(np.asarray(subcol, dtype=np.int64))

    intervals: list[tuple[int, int]] = []
    beg = int(sorted_cols[0])
    end = beg
    for ii in sorted_cols[1:]:
        ii = int(ii)
        if ii >= end + gap:
            intervals.append((beg, end + 1))
            beg = ii
            end = ii
        else:
            end = ii
    intervals.append((beg, end + 1))

    ret = []
    for lb, ub in intervals:
        if lb >= n:
            continue
        lb_mem = int(index_tab[lb])
        ub_mem = int(index_tab[ub]) if ub < n else LAST_POS
        ret.append(MemoryBlock(lb, lb_mem, ub, ub_mem))
    return ret


class MtxDataBlock:
    """Out-of-core minibatch loader over an indexed bgzipped .mtx.

    Reference: ``mmvae::mtx_data_block_t`` (include/mmvae_io.hh:49-290).
    """

    def __init__(self, mtx_file: str | os.PathLike, idx_file: str | os.PathLike,
                 batch_size: int):
        self.mtx_file = os.fspath(mtx_file)
        self.idx_file = os.fspath(idx_file)
        self.B = int(batch_size)
        info = peek_mtx_header(self.mtx_file)
        self.D = info.rows
        self.N = info.cols
        TLOG(f"Sparse Mtx Data: {self.D} x {self.N} from {self.mtx_file}")
        self.idx_tab = read_mmutil_index(self.idx_file)
        self._mem = np.zeros((self.B, self.D), dtype=np.float32)
        self._use_native = native.available()

    # --- DATA_BLOCK contract -------------------------------------------
    def size(self) -> int:
        return self.B

    def nfeature(self) -> int:
        return self.D

    def ntot(self) -> int:
        return self.N

    def dim(self) -> tuple[int, int]:
        return self.D, self.N

    @property
    def array(self) -> np.ndarray:
        """(B, D) float32 view of the current batch (zero-copy)."""
        return self._mem

    def torch_tensor(self) -> np.ndarray:  # name kept for contract parity
        return self._mem

    def clear(self) -> None:
        self._mem.fill(0.0)

    def read(self, subcol) -> np.ndarray:
        """Populate the (B, D) buffer with the requested columns.

        Duplicate-aware: every batch slot whose column matches a triplet
        receives the value (reference: dup lists,
        include/mmvae_io.hh:208-245).
        """
        return self.read_into(subcol, self._mem)

    def read_into(self, subcol, out: np.ndarray) -> np.ndarray:
        """Stateless variant of :meth:`read`: scatter into a caller
        buffer (must be zeroed, (B, D) float32 C-contiguous).  Touches no
        shared mutable state, so concurrent calls with distinct buffers
        are safe — the multi-threaded prefetch loader relies on this
        (the native extension releases the GIL for the whole read)."""
        subcol = np.asarray(subcol, dtype=np.int64)
        assert len(subcol) == self.B, f"Need the columns for {self.B} samples"

        ucols, inv = np.unique(subcol, return_inverse=True)
        # CSR-style duplicate lists: slots owning each unique column
        order = np.argsort(inv, kind="stable")
        counts = np.bincount(inv, minlength=len(ucols))
        dup_start = np.zeros(len(ucols) + 1, dtype=np.int64)
        np.cumsum(counts, out=dup_start[1:])
        dup_flat = order.astype(np.int64)

        blocks = find_consecutive_blocks(self.idx_tab, subcol)
        begs = np.array([b.lb_mem for b in blocks], dtype=np.int64)
        ends = np.array([b.ub_mem for b in blocks], dtype=np.int64)

        if self._use_native:
            native.read_batch(
                self.mtx_file, begs, ends, ucols, dup_start, dup_flat, out
            )
        else:
            col2k = {int(c): k for k, c in enumerate(ucols)}
            for beg, end in zip(begs, ends):
                rows, cols, vals = read_mtx_block(self.mtx_file, int(beg), int(end))
                for r, c, w in zip(rows, cols, vals):
                    k = col2k.get(int(c))
                    if k is None:
                        continue
                    for j in dup_flat[dup_start[k]: dup_start[k + 1]]:
                        out[j, r] = w
        return out


class MtxMemoryBlock:
    """In-memory variant: CSC sparse matrix densified per batch.

    Reference: ``mmvae::mtx_memory_block_t`` (include/mmvae_mem.hh:17-170).
    """

    def __init__(self, mtx_file: str | os.PathLike,
                 idx_file: str | os.PathLike = "",
                 batch_size: int = 100,
                 count_dtype: str = "float32"):
        self.mtx_file = os.fspath(mtx_file)
        self.idx_file = os.fspath(idx_file) if idx_file else ""
        self.B = int(batch_size)
        self._want_narrow = count_dtype == "auto"
        from ..io.bgzf import is_bgzf
        from ..io.mtx import header_end_voffset, read_mtx_any

        self._stats = None  # native-gathered value stats, when available
        csc_done = False
        if is_bgzf(self.mtx_file):
            info = peek_mtx_header(self.mtx_file)
            self.D, self.N = info.rows, info.cols
            if native.available():
                # one-pass native CSC read: builds indptr and value
                # stats during the parse — on slow hosts the numpy
                # lexsort/gather/scan passes over ~100M nonzeros cost
                # minutes (None when the file isn't column-sorted).
                # With a column index and spare cores the parse runs
                # range-parallel (bitwise-identical merge); any
                # index/file disagreement falls back to the serial pass
                got = None
                if self.idx_file and os.path.exists(self.idx_file):
                    got = native.read_csc_threaded(
                        self.mtx_file, self.N, self.D, self.idx_file
                    )
                if got is None:
                    got = native.read_csc(self.mtx_file, self.N)
                if got is not None:
                    self._rows, self._vals, self._indptr, self._stats = got
                    csc_done = True
            if not csc_done:
                data_start = header_end_voffset(self.mtx_file)
                if native.available():
                    rows, cols, vals = native.read_block(
                        self.mtx_file, data_start, LAST_POS
                    )
                else:
                    rows, cols, vals = read_mtx_block(
                        self.mtx_file, data_start, LAST_POS
                    )
        else:
            # plain gzip / uncompressed .mtx: no random access, but the
            # in-memory path only needs one full read
            # (reference: visit_matrix_market_file, io_alg.hh:216-236)
            info, rows, cols, vals = read_mtx_any(self.mtx_file)
            self.D, self.N = info.rows, info.cols
        if not csc_done:
            # CSC layout: column-sorted triplets -> indptr by column
            order = np.lexsort((rows, cols))
            self._rows = rows[order].astype(np.int64)
            self._vals = vals[order].astype(np.float32)
            colcounts = np.bincount(cols[order], minlength=self.N)
            self._indptr = np.zeros(self.N + 1, dtype=np.int64)
            np.cumsum(colcounts, out=self._indptr[1:])
        # ``count_dtype="auto"``: emit the narrowest lossless integer
        # batch buffer (counts are integers) — host->device transfer of
        # the (B, D) batch is the CLI bottleneck at large D, and the
        # compute paths widen integers to f32 bit-exactly.
        self.val_dtype = np.float32
        if len(self._vals) and (self._stats is not None or self._want_narrow):
            self.val_dtype = narrow_value_dtype(self._vals, self._stats)
        buf_dtype = self.val_dtype if self._want_narrow else np.float32
        self._mem = np.zeros((self.B, self.D), dtype=buf_dtype)
        TLOG(f"Loaded sparse matrix in memory: {self.D} x {self.N}"
             + (f" ({np.dtype(buf_dtype).name} batches)"
                if buf_dtype is not np.float32 else ""))

    def size(self) -> int:
        return self.B

    def nfeature(self) -> int:
        return self.D

    def ntot(self) -> int:
        return self.N

    def dim(self) -> tuple[int, int]:
        return self.D, self.N

    @property
    def array(self) -> np.ndarray:
        return self._mem

    def torch_tensor(self) -> np.ndarray:
        return self._mem

    def clear(self) -> None:
        self._mem.fill(0.0)

    def read(self, subcol) -> np.ndarray:
        return self.read_into(subcol, self._mem)

    def read_into(self, subcol, out: np.ndarray) -> np.ndarray:
        """Stateless densify into a caller-provided zeroed (B, D) buffer.

        Touches no shared mutable state (the CSC arrays are read-only
        after construction), so concurrent calls with distinct buffers
        are safe — required by the multi-threaded prefetch loader.
        Vectorized: one flat gather/scatter instead of a per-column
        Python loop (reference contract: include/mmvae_mem.hh:56-72).
        """
        subcol = np.asarray(subcol, dtype=np.int64)
        assert len(subcol) == self.B, f"Need the columns for {self.B} samples"
        valid = np.flatnonzero((subcol >= 0) & (subcol < self.N))
        cols = subcol[valid]
        lo = self._indptr[cols]
        lens = self._indptr[cols + 1] - lo
        total = int(lens.sum())
        if total:
            # concatenate the CSC ranges [lo_i, lo_i+len_i) without a loop
            ends = np.cumsum(lens)
            pos = np.repeat(lo, lens) + np.arange(total) + np.repeat(
                lens - ends, lens
            )
            out[np.repeat(valid, lens), self._rows[pos]] = self._vals[pos]
        return out

    # Extra capability beyond the reference: export the CSC arrays in a
    # device-friendly padded layout for the on-device densify kernel.
    def csc_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self._rows, self._vals, self._indptr

    def k_max(self) -> int:
        """Largest per-column nonzero count (the padded-ELL row width)."""
        if self.N == 0:
            return 0
        return int(np.diff(self._indptr).max())


def create_ones_like(data_block, out_file: str) -> None:
    """Write a 1 x N all-ones covariate .mtx for a data block.

    Reference: ``create_ones_like`` (include/mmvae_io.hh:293-310); used
    by the CLIs when no covariate file is given
    (src/nb_vae_main.cc:68-78).
    """
    from ..io.writers import write_matrix_market_file

    n = data_block.ntot()
    rows = np.zeros(n, dtype=np.int64)
    cols = np.arange(n, dtype=np.int64)
    vals = np.ones(n, dtype=np.float32)
    write_matrix_market_file(out_file, rows, cols, vals, (1, n))
