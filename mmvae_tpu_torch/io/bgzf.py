"""BGZF (block-gzip) reader/writer with virtual-offset random access.

BGZF is the SAMtools block-compression format: a concatenation of
independent gzip members, each holding <= 64KiB of uncompressed payload
and carrying its own compressed size in a gzip "extra" subfield
(SI1='B', SI2='C').  Because every block inflates independently, a
*virtual offset* ``(compressed_block_start << 16) | within_block_offset``
addresses any byte and supports O(1) seek.

This module is a fresh implementation of the subset of BGZF the
framework needs (the reference vendors the tabix C library for the same
purpose: src/ext/tabix/bgzf.c, include/ext/tabix/bgzf.h).  The Python
classes here serve index building on small files, artifact writing, and
as the fallback when the native extension (csrc/mmvae_io.cc) is not
built; the training hot path goes through the native reader.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

# gzip member header with FEXTRA; the BC subfield carries BSIZE =
# (total block size - 1) as a uint16.
_HDR = struct.Struct("<4BI2BH2BHH")  # magic,CM,FLG,MTIME,XFL,OS,XLEN,SI1,SI2,SLEN,BSIZE
_BLOCK_HEADER_LEN = 18
_BLOCK_FOOTER_LEN = 8
# Maximum uncompressed payload per block.  64KiB minus headroom so the
# deflate output always fits in a 64KiB block even if incompressible.
MAX_BLOCK_PAYLOAD = 0xFF00

# The canonical 28-byte BGZF EOF marker block (empty payload).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def make_voffset(coffset: int, uoffset: int) -> int:
    """Pack a (compressed offset, within-block offset) virtual offset."""
    return (coffset << 16) | (uoffset & 0xFFFF)


def split_voffset(voffset: int) -> tuple[int, int]:
    return voffset >> 16, voffset & 0xFFFF


def is_bgzf(path: str | os.PathLike) -> bool:
    """True if *path* starts with a valid BGZF block header.

    Mirrors tabix's ``bgzf_is_bgzf`` check used to reject plain gzip
    inputs (reference: include/mmutil_index.hh:147-150).
    """
    try:
        with open(path, "rb") as f:
            hdr = f.read(_BLOCK_HEADER_LEN)
    except OSError:
        return False
    if len(hdr) < _BLOCK_HEADER_LEN:
        return False
    return (
        hdr[0] == 0x1F
        and hdr[1] == 0x8B
        and hdr[3] & 0x04  # FEXTRA
        and hdr[12] == 0x42  # 'B'
        and hdr[13] == 0x43  # 'C'
    )


def _compress_block(payload: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    bsize = _BLOCK_HEADER_LEN + len(comp) + _BLOCK_FOOTER_LEN
    if bsize > 0x10000:
        raise ValueError("BGZF block overflow (incompressible payload)")
    header = _HDR.pack(
        0x1F, 0x8B, 8, 4,  # magic, CM=deflate, FLG=FEXTRA
        0,  # MTIME
        0, 0xFF,  # XFL, OS=unknown
        6,  # XLEN
        0x42, 0x43, 2,  # 'B', 'C', SLEN
        bsize - 1,
    )
    footer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    return header + comp + footer


class BgzfWriter(io.RawIOBase):
    """Write a BGZF file; output is also a valid multi-member gzip file."""

    def __init__(self, path: str | os.PathLike):
        self._fh = open(path, "wb")
        self._buf = bytearray()

    def writable(self) -> bool:  # pragma: no cover - io protocol
        return True

    def write(self, data) -> int:
        if isinstance(data, str):
            data = data.encode()
        self._buf += data
        while len(self._buf) >= MAX_BLOCK_PAYLOAD:
            self._flush_block(MAX_BLOCK_PAYLOAD)
        return len(data)

    def _flush_block(self, n: int) -> None:
        payload = bytes(self._buf[:n])
        del self._buf[:n]
        self._fh.write(_compress_block(payload))

    def tell_voffset(self) -> int:
        """Virtual offset of the next byte to be written."""
        return make_voffset(self._fh.tell(), len(self._buf))

    def close(self) -> None:
        if self._fh.closed:
            return
        while self._buf:
            self._flush_block(min(len(self._buf), MAX_BLOCK_PAYLOAD))
        self._fh.write(BGZF_EOF)
        self._fh.close()
        super().close()


class BgzfReader:
    """Random-access BGZF reader with ``seek``/``tell`` on virtual offsets.

    Provides the reader contract the reference gets from tabix
    (``bgzf_open/seek/tell/getline``): ``readline`` returns one
    uncompressed line (without the newline) and ``tell_voffset`` reports
    the virtual offset of the *next* unread byte -- the invariant the
    column indexer depends on (reference: include/mmutil_index.hh:66-87).
    """

    def __init__(self, path: str | os.PathLike):
        self._fh = open(path, "rb")
        self._block_coffset = 0  # compressed offset of the cached block
        self._block = b""
        self._block_next_coffset = 0
        self._within = 0
        self._load_block(0)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _load_block(self, coffset: int) -> bool:
        """Inflate the block starting at compressed offset *coffset*."""
        self._fh.seek(coffset)
        hdr = self._fh.read(_BLOCK_HEADER_LEN)
        if len(hdr) < _BLOCK_HEADER_LEN:
            self._block = b""
            self._block_coffset = coffset
            self._block_next_coffset = coffset
            self._within = 0
            return False
        fields = _HDR.unpack(hdr)
        xlen = fields[7]
        if fields[8] == 0x42 and fields[9] == 0x43 and fields[10] == 2:
            bsize = fields[-1] + 1
            if xlen > 6:
                # BC-first header with further extra subfields: the
                # compressed payload starts after ALL of them
                self._fh.seek(coffset + _BLOCK_HEADER_LEN + xlen - 6)
        else:
            # scan extra subfields for the BC entry (robust to other writers)
            extra = hdr[12:] + self._fh.read(max(0, xlen - 6))
            bsize = None
            p = 0
            while p + 4 <= len(extra):
                si1, si2 = extra[p], extra[p + 1]
                slen = int.from_bytes(extra[p + 2: p + 4], "little")
                if si1 == 0x42 and si2 == 0x43 and slen == 2:
                    bsize = int.from_bytes(extra[p + 4: p + 6], "little") + 1
                    break
                p += 4 + slen
            if bsize is None:
                raise ValueError("not a BGZF block (no BC subfield)")
            self._fh.seek(coffset + _BLOCK_HEADER_LEN + max(0, xlen - 6))
        comp = self._fh.read(bsize - _BLOCK_HEADER_LEN - max(0, xlen - 6))
        payload = comp[: -(_BLOCK_FOOTER_LEN)]
        self._block = zlib.decompress(payload, -15)
        self._block_coffset = coffset
        self._block_next_coffset = coffset + bsize
        self._within = 0
        return True

    def seek_voffset(self, voffset: int) -> None:
        coffset, uoffset = split_voffset(voffset)
        if coffset != self._block_coffset or not self._block:
            self._load_block(coffset)
        self._within = uoffset

    def tell_voffset(self) -> int:
        if self._within >= len(self._block):
            # normalized: point at the start of the next block
            return make_voffset(self._block_next_coffset, 0)
        return make_voffset(self._block_coffset, self._within)

    def _advance_block(self) -> bool:
        return self._load_block(self._block_next_coffset)

    def readline(self) -> bytes | None:
        """One line without the trailing newline; ``None`` at EOF."""
        chunks: list[bytes] = []
        while True:
            if self._within < len(self._block):
                nl = self._block.find(b"\n", self._within)
                if nl >= 0:
                    chunks.append(self._block[self._within: nl])
                    self._within = nl + 1
                    return b"".join(chunks)
                chunks.append(self._block[self._within:])
                self._within = len(self._block)
            # need the next block; an empty (EOF-marker) block ends the file
            if not self._advance_block() or not self._block:
                return b"".join(chunks) if chunks else None

    def read_all(self) -> bytes:
        """Inflate the remainder of the file from the current position."""
        chunks = [self._block[self._within:]]
        self._within = len(self._block)
        while self._advance_block() and self._block:
            chunks.append(self._block)
            self._within = len(self._block)
        return b"".join(chunks)
