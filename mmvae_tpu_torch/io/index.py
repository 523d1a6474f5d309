"""Column -> virtual-offset index for bgzipped MatrixMarket files.

The index is the component that makes out-of-core minibatching possible:
with one ``(column, virtual offset)`` pair per column, any subset of
columns (cells) can be fetched by independent BGZF seeks.

Reimplements the exact sidecar semantics of the reference
(include/mmutil_index.hh): column-sorted input required, offsets point
at the first line of each column, the sidecar is gzipped ``col voff``
text, reads forward-fill missing columns from the next known offset.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from .bgzf import is_bgzf
from .mtx import LAST_POS, peek_mtx_header, read_mtx_block, visit_mtx_triplets
from ..utils.logging import TLOG, WLOG, ELOG

# Reference: MISSING_POS == 0 (include/mmutil_bgzf_util.hh:17)
MISSING_POS = 0


def build_mmutil_index(mtx_file: str | os.PathLike, index_file: str = "") -> str:
    """Build the ``.index`` sidecar for a bgzipped, column-sorted .mtx.

    Semantics follow ``build_mmutil_index`` (include/mmutil_index.hh:
    138-190): reject non-BGZF input, keep an existing index, record the
    virtual offset of the first line of every column (change-point scan,
    :66-87), fail unless the last column of the matrix was indexed, and
    write gzipped ``col voff`` lines.

    Returns the index path.  Raises on failure (the reference exits).
    """
    mtx_file = os.fspath(mtx_file)
    if not index_file:
        index_file = mtx_file + ".index"

    if not is_bgzf(mtx_file):
        raise ValueError(f"This file is not bgzipped: {mtx_file}")

    if os.path.exists(index_file):
        WLOG("Index file exists:", index_file)
        return index_file

    info = peek_mtx_header(mtx_file)

    try:
        from . import native

        if native.available():
            col2off = native.build_index(mtx_file)
        else:
            col2off = _build_index_python(mtx_file)
    except ImportError:  # pragma: no cover
        col2off = _build_index_python(mtx_file)

    last_col = col2off[-1][0] if col2off else 0
    if last_col != info.cols - 1:
        ELOG(f"Failed to index all the columns: {last_col} < {info.cols - 1}")
        raise ValueError(
            "Failed to index all the columns; filter out empty columns first"
        )

    with gzip.open(index_file, "wt") as f:
        for col, off in col2off:
            f.write(f"{col} {off}\n")
    TLOG("Built the index file:", index_file)
    return index_file


def _build_index_python(mtx_file: str) -> list[tuple[int, int]]:
    """Pure-Python change-point scan (reference: mmutil_index.hh:38-107)."""
    col2off: list[tuple[int, int]] = []
    last_col = 0
    last_off = 0
    first = True
    prev_end_off = None  # voffset after the previous line == start of this one
    for row, col, w, end_off in visit_mtx_triplets(mtx_file):
        if first:
            # start of the first data line: recover it as (end_off of the
            # header) — visit_mtx_triplets yields post-line offsets, so
            # compute the first line's start from the header end.
            from .mtx import header_end_voffset

            col2off.append((col, header_end_voffset(mtx_file)))
            last_col = col
            first = False
        elif col != last_col:
            if col < last_col:
                raise ValueError("MTX must be sorted by columns")
            col2off.append((col, prev_end_off))
            last_col = col
        prev_end_off = end_off
    return col2off


def read_mmutil_index(index_file: str | os.PathLike) -> np.ndarray:
    """Load the sidecar into a dense per-column voffset table.

    Reference: ``read_mmutil_index`` (include/mmutil_index.hh:192-228)
    including the ascending forward-fill of missing columns from the
    next known offset (:219-224).
    """
    cols, offs = [], []
    with gzip.open(index_file, "rt") as f:
        for ln in f:
            parts = ln.split()
            if len(parts) >= 2:
                cols.append(int(parts[0]))
                offs.append(int(parts[1]))
    if not cols:
        raise ValueError(f"empty index file: {index_file}")
    max_idx = max(cols)
    tab = np.full(max_idx + 1, MISSING_POS, dtype=np.int64)
    tab[np.asarray(cols)] = np.asarray(offs)
    # exact reference quirk: single ascending pass, j < MaxIdx - 1.
    # Because the pass is ascending, tab[j] copies the ORIGINAL tab[j+1]
    # (a run of missing columns fills only its last element), which a
    # snapshot-based vectorized update reproduces exactly.
    if max_idx >= 1:
        head = tab[: max_idx - 1]
        miss = head == MISSING_POS
        head[miss] = tab[1:max_idx][miss]
    # SAFETY beyond the reference: a run of >=2 consecutive empty
    # columns leaves MISSING_POS (voffset 0 = file start) after the
    # single-step fill above; a block read starting there would parse
    # the MatrixMarket size line as a triplet and silently corrupt the
    # batch (the reference shares this hole).  Complete the fill with
    # the next KNOWN offset (backward pass over the original values);
    # trailing missing entries take the last known offset, yielding an
    # empty read interval.
    miss = tab == MISSING_POS
    if miss.any() and not miss.all():
        n = len(tab)
        # first known index >= j (reverse cumulative minimum); positions
        # past the last known one fall back to the last known offset,
        # which produces an empty read interval
        nxt = np.where(miss, n, np.arange(n))
        nxt = np.minimum.accumulate(nxt[::-1])[::-1]
        last_known = int(np.flatnonzero(~miss)[-1])
        src = np.where(nxt < n, np.minimum(nxt, n - 1), last_known)
        tab = np.where(miss, tab[src], tab)
    return tab


def check_index_tab(mtx_file: str | os.PathLike, index_tab: np.ndarray) -> bool:
    """Re-read the mtx at each indexed offset and verify the column found.

    Reference: ``check_index_tab`` (include/mmutil_index.hh:265-298).
    """
    info = peek_mtx_header(mtx_file)
    if len(index_tab) < info.cols:
        return False
    nerr = 0
    for j in range(info.cols - 1):
        beg = int(index_tab[j])
        if beg == MISSING_POS:
            # voffset 0 never points at data (the header precedes it):
            # an unresolvable empty column is a warning, like the
            # reference's read-to-EOF probe concludes
            WLOG("Found an empty column:", j)
            continue
        rows, cols, vals = read_mtx_block(mtx_file, beg, beg if beg != LAST_POS else 1)
        found = int(cols[-1]) if len(cols) else -1
        if found > j:
            WLOG("Found an empty column:", j)
            continue
        if found != j:
            nerr += 1
            ELOG(f"Expected: {j} at {beg}, but found: {found}")
    return nerr == 0
