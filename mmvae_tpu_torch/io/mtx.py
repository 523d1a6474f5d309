"""MatrixMarket triplet access over BGZF files.

Reimplements the visitor semantics of the reference's streaming parsers
(reference: include/mmutil_bgzf_util.hh — ``peek_bgzf_header`` :155-251,
``visit_bgzf`` :255-437, ``visit_bgzf_block`` :53-151) as vectorized
numpy parsing: a whole decompressed byte range is tokenized at once
instead of per-character FSM parsing.  The native extension
(csrc/mmvae_io.cc) provides the same functions with a C++ inner loop;
``mmvae_tpu_torch.io.native`` transparently dispatches to it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from .bgzf import BgzfReader

# Virtual offset 0 doubles as the reference's LAST_POS/MISSING_POS
# sentinel (include/mmutil_bgzf_util.hh:17-18): an end position of 0
# means "read to end of file".
LAST_POS = 0


@dataclass(frozen=True)
class MtxHeader:
    rows: int
    cols: int
    nnz: int


def _parse_text_triplets(
    text: bytes,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse ``row col value`` lines into 0-based numpy triplet arrays.

    Tolerates comment lines (leading ``%``) and incomplete lines, which
    the reference skips with a warning (mmutil_bgzf_util.hh:104-136).
    """
    lines = text.split(b"\n")
    rows, cols, vals = [], [], []
    for ln in lines:
        if not ln or ln[0] == 0x25:  # '%'
            continue
        parts = ln.split()
        if len(parts) < 3:
            continue
        try:
            r, c, w = int(parts[0]), int(parts[1]), float(parts[2])
        except ValueError:
            continue  # malformed line: skip, like the reference's parser
        rows.append(r)
        cols.append(c)
        vals.append(w)
    return (
        np.asarray(rows, dtype=np.int64) - 1,
        np.asarray(cols, dtype=np.int64) - 1,
        np.asarray(vals, dtype=np.float32),
    )


def _fast_parse_clean(text: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Vectorized parse via numpy's C text reader; None on doubt.

    ``np.loadtxt`` (C engine, numpy >= 1.23; ``np.fromstring`` text mode
    is gone in numpy 2.x) strips ``%`` comment lines itself, so a
    mid-file comment — which the reference tolerates
    (mmutil_bgzf_util.hh:104-109) — no longer demotes the whole read to
    the per-line fallback.  Short/ragged lines still do.
    """
    import io

    try:
        flat = np.loadtxt(io.BytesIO(text), dtype=np.float64, comments="%",
                          ndmin=2)
    except Exception:
        return None
    if flat.size == 0:
        z = np.zeros(0)
        return z.astype(np.int64), z.astype(np.int64), z.astype(np.float32)
    if flat.shape[1] != 3:
        return None
    return (
        flat[:, 0].astype(np.int64) - 1,
        flat[:, 1].astype(np.int64) - 1,
        flat[:, 2].astype(np.float32),
    )


def parse_triplet_text(text: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    out = _fast_parse_clean(text)
    if out is not None:
        return out
    return _parse_text_triplets(text)


def peek_mtx_header(path: str | os.PathLike) -> MtxHeader:
    """Read only the ``rows cols nnz`` size line of a bgzipped .mtx.

    Reference: ``peek_bgzf_header`` + ``mm_info_reader_t``
    (include/mmutil_bgzf_util.hh:155-251, include/mmutil_index.hh:109-132).
    """
    with BgzfReader(path) as r:
        while True:
            ln = r.readline()
            if ln is None:
                raise ValueError(f"{path}: no MatrixMarket header found")
            if not ln or ln.startswith(b"%"):
                continue
            parts = ln.split()
            if len(parts) == 3:
                return MtxHeader(int(parts[0]), int(parts[1]), int(parts[2]))


def header_end_voffset(path: str | os.PathLike) -> int:
    """Virtual offset of the first data line (right after the header)."""
    with BgzfReader(path) as r:
        while True:
            ln = r.readline()
            if ln is None:
                raise ValueError(f"{path}: no MatrixMarket header found")
            if not ln or ln.startswith(b"%"):
                continue
            if len(ln.split()) == 3:
                return r.tell_voffset()


def visit_mtx_triplets(
    path: str | os.PathLike,
) -> Iterator[tuple[int, int, float, int]]:
    """Stream ``(row0, col0, value, voffset_after_line)`` over the file.

    The trailing element is ``bgzf_tell`` *after* the line was consumed,
    i.e. the virtual offset of the start of the next line — the quantity
    the column indexer records (include/mmutil_index.hh:83).
    Reference: ``visit_bgzf`` (include/mmutil_bgzf_util.hh:255-437).
    """
    with BgzfReader(path) as r:
        # skip to past the header
        while True:
            ln = r.readline()
            if ln is None:
                return
            if not ln or ln.startswith(b"%"):
                continue
            if len(ln.split()) == 3:
                break
        while True:
            ln = r.readline()
            if ln is None:
                return
            if not ln or ln.startswith(b"%"):
                continue
            parts = ln.split()
            if len(parts) < 3:
                continue
            yield (
                int(parts[0]) - 1,
                int(parts[1]) - 1,
                float(parts[2]),
                r.tell_voffset(),
            )


def sniff_format(path: str | os.PathLike) -> str:
    """'bgzf' | 'gz' | 'plain' — the reference's stream dispatch
    (include/io_alg.hh:218-236)."""
    from .bgzf import is_bgzf

    if is_bgzf(path):
        return "bgzf"
    with open(path, "rb") as f:
        magic = f.read(2)
    return "gz" if magic == b"\x1f\x8b" else "plain"


def read_mtx_any(
    path: str | os.PathLike,
) -> tuple[MtxHeader, np.ndarray, np.ndarray, np.ndarray]:
    """Whole-file triplet read for bgzf, plain-gzip, or uncompressed .mtx.

    Only BGZF supports random access (and hence out-of-core blocks);
    this reader exists for in-memory loading of any MatrixMarket file,
    mirroring ``visit_matrix_market_file`` (include/io_alg.hh:216-236).
    """
    import gzip as _gzip

    fmt = sniff_format(path)
    if fmt == "bgzf":
        hdr = peek_mtx_header(path)
        rows, cols, vals = read_mtx_block(path, header_end_voffset(path),
                                          LAST_POS)
        return hdr, rows, cols, vals
    opener = _gzip.open if fmt == "gz" else open
    with opener(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    hdr = None
    body_start = 0
    for i, ln in enumerate(lines):
        if not ln or ln.startswith(b"%"):
            continue
        parts = ln.split()
        if len(parts) == 3:
            hdr = MtxHeader(int(parts[0]), int(parts[1]), int(parts[2]))
            body_start = i + 1
            break
    if hdr is None:
        raise ValueError(f"{path}: no MatrixMarket header found")
    rows, cols, vals = parse_triplet_text(b"\n".join(lines[body_start:]))
    return hdr, rows, cols, vals


def read_mtx_block(
    path: str | os.PathLike,
    beg_voffset: int,
    end_voffset: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Triplets in the virtual-offset range ``[beg, end)`` as 0-based arrays.

    ``end_voffset == LAST_POS`` (0) reads to end of file.  Matching the
    reference (include/mmutil_bgzf_util.hh:102-144), reading stops after
    the first line whose post-read offset is >= ``end_voffset``, so the
    line straddling ``end`` is included.
    """
    with BgzfReader(path) as r:
        r.seek_voffset(beg_voffset)
        if end_voffset == LAST_POS:
            text = r.read_all()
        else:
            chunks = []
            while True:
                ln = r.readline()
                if ln is None:
                    break
                chunks.append(ln)
                if r.tell_voffset() >= end_voffset:
                    break
            text = b"\n".join(chunks)
    return parse_triplet_text(text)
