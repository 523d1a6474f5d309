"""Gzipped whitespace-text artifact readers/writers.

Reproduces the reference's artifact surface (SURVEY §2.6): all outputs
are gzipped text keyed by an ``--out`` header.  Dense matrices are
space-separated rows (reference: ``write_data_stream``,
include/io.hh:522-544); vectors are one value per line
(``write_vector_stream``, include/io.hh:308-331); MatrixMarket output is
column-sorted, 1-based, and **bgzf-compressed** when the name ends in
``.gz`` so it can immediately be indexed (``write_matrix_market_file``,
include/io.hh:189-242).
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from .bgzf import BgzfWriter


def _fmt(x) -> str:
    """C++ ``ostream << float`` default formatting (6 significant digits)."""
    return "%g" % x


def _open_text_out(path: str):
    if path.endswith(".gz"):
        # zlib default level (6), like the reference's ogzstream — level
        # 9 is ~3x slower for no meaningful size gain on these artifacts
        return gzip.open(path, "wt", compresslevel=6)
    return open(path, "w")


def write_data_file(path: str | os.PathLike, mat: np.ndarray) -> None:
    """Dense matrix as space-separated text rows (gz when ``.gz``).

    Formatting is vectorized (``np.char.mod`` runs the C printf per
    element): recording epochs write N x latent matrices plus every
    parameter, so a Python-level ``"%g" %`` loop dominated recording
    throughput."""
    path = os.fspath(path)
    mat = np.asarray(mat)
    if mat.ndim == 1:
        mat = mat[:, None]
    elif mat.ndim == 0:
        mat = mat.reshape(1, 1)
    elif mat.ndim > 2:
        mat = mat.reshape(mat.shape[0], -1)
    cells = np.char.mod("%g", mat)
    body = "\n".join(" ".join(row) for row in cells.tolist())
    with _open_text_out(path) as f:
        f.write(body)
        if body:
            f.write("\n")


def write_vector_file(path: str | os.PathLike, vec) -> None:
    """One value per line (reference: include/io.hh:308-331)."""
    path = os.fspath(path)
    with _open_text_out(path) as f:
        for v in vec:
            f.write(_fmt(v) + "\n")


def write_matrix_market_file(
    path: str | os.PathLike,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
) -> None:
    """Column-sorted 1-based coordinate MatrixMarket; BGZF when ``.gz``.

    BGZF output (rather than plain gzip) is what makes the written file
    immediately indexable — the reference achieves the same through its
    ``obgzf_stream`` (include/utils/bgzstream.hh:15-102).
    """
    path = os.fspath(path)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    order = np.lexsort((rows, cols))  # sorted by column then row
    header = (
        "%%MatrixMarket matrix coordinate integer general\n"
        f"{shape[0]} {shape[1]} {len(vals)}\n"
    )

    out = BgzfWriter(path) if path.endswith(".gz") else open(path, "wb")
    try:
        out.write(header.encode())
        # chunked vectorized formatting (C-level printf per element): a
        # per-triplet Python loop over ~100M nonzeros costs minutes and
        # a single in-memory string costs GBs
        CHUNK = 1 << 20
        for s in range(0, len(order), CHUNK):
            k = order[s: s + CHUNK]
            r_s = np.char.mod("%d", rows[k] + 1)
            c_s = np.char.mod("%d", cols[k] + 1)
            v_s = np.char.mod("%g", vals[k])
            merged = np.char.add(
                np.char.add(np.char.add(r_s, " "),
                            np.char.add(c_s, " ")),
                v_s,
            )
            out.write(("\n".join(merged.tolist()) + "\n").encode())
    finally:
        out.close()


def _open_text_in(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_data_file(path: str | os.PathLike) -> np.ndarray:
    """Dense whitespace matrix (NaN for missing trailing fields)."""
    path = os.fspath(path)
    rows = []
    with _open_text_in(path) as f:
        for ln in f:
            parts = ln.split()
            if parts:
                rows.append([float(p) for p in parts])
    if not rows:
        return np.zeros((0, 0), dtype=np.float32)
    ncol = max(len(r) for r in rows)
    out = np.full((len(rows), ncol), np.nan, dtype=np.float64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def read_vector_file(path: str | os.PathLike) -> list[str]:
    with _open_text_in(os.fspath(path)) as f:
        return [ln.strip() for ln in f if ln.strip()]


def read_pair_file(path: str | os.PathLike) -> list[tuple[str, str]]:
    out = []
    with _open_text_in(os.fspath(path)) as f:
        for ln in f:
            parts = ln.split()
            if len(parts) >= 2:
                out.append((parts[0], parts[1]))
    return out
