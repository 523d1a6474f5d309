"""Host-resident shard store for training beyond the device budget.

Port of ``mmvae_tpu/data/shards.py`` (``Shard``, ``ShardStore``,
``_csr_fill_np``, ``_dense_fill_np``) with the same plan, so the two
packages' stores hold the same arrays: when neither device-resident
layout (dense or padded ELL, :mod:`mmvae_tpu_torch.ops.densify`) fits the
device budget, the dataset is cut into R shards of whole batches that
live in host memory and rotate through the device, the next shard's
copy overlapping the current shard's compute.

Layouts, chosen by the fewest bytes a batch (or ``MMVAE_SHARD_LAYOUT``):

- ``dense``: (rows, D) in the narrowest lossless count dtype;
- ``ell``: (rows, k_max) padded (gene, value) pairs;
- ``csr``: (nb, nnz_pad) batch-packed (row-in-batch, gene, value)
  triplets, padded to the largest batch's nonzeros with row sentinel B.

Gene indices travel as int16 when D < 32767 and widen on the device
after the gather.  Shards are whole-batch row ranges of the sequential
wrap-around schedule (mmvae_alg.hh:261-266), materialized in schedule
order, so every batch, the final wrap-around one included, is a
contiguous slice of its shard.

``pinned_idx`` keeps the JAX package's name: the shards that stay
resident in device memory after their first copy.  The page-locked host
memory that CUDA calls "pinned" is the :class:`HostStager`'s staging
ring.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..io import native
from ..ops.densify import ell_fill_host

_STAGE_ALIGN = 64  # bytes between arrays in a staging slot
# staging slots: at the prefetch point the previous shard's compute may
# still be queued, the current shard is in use and the next one copies
_STAGE_SLOTS = 3


@dataclass
class Shard:
    b0: int                      # first global batch id
    nb: int                      # number of batches
    arrays: tuple                # host arrays: (dense,), (rows, vals) or
                                 # (rows_in_batch, genes, vals)


class ShardCopy:
    """A shard's device arrays and the host->device copy that fills them.
    :meth:`take` hands the arrays to the current stream: it waits for the
    copy there (the host does not wait) and tells the caching allocator
    that the current stream uses them."""

    def __init__(self, arrays: tuple, record: list | None = None):
        self.arrays, self._record = arrays, record

    def take(self) -> tuple:
        if self._record is not None:
            stream = torch.cuda.current_stream(self.arrays[0].device)
            if self._record[2] is None:
                # marks where compute reached the shard: a copy that ends
                # after it is time the compute stream waited
                self._record[2] = torch.cuda.Event(enable_timing=True)
                self._record[2].record(stream)
            stream.wait_event(self._record[1])
            for a in self.arrays:
                a.record_stream(stream)
        return self.arrays


class HostStager:
    """Host->device copies of shards on a side stream, through a ring of
    page-locked staging slots of ``slot_bytes`` each.  A host
    ``memcpy`` fills a slot and the copy engine moves it to the device
    while the compute stream runs on; the slot is reused only after its
    copy has finished.  Data beyond device memory may be too large to
    page-lock whole, so the ring is all that is page-locked.  A failed
    copy raises: nothing falls back to a synchronous copy."""

    def __init__(self, device, slot_bytes: int):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.slots = [torch.empty(slot_bytes, dtype=torch.uint8,
                                  pin_memory=True)
                      for _ in range(_STAGE_SLOTS)]
        self._free: list = [None] * _STAGE_SLOTS
        self._next = 0
        self._records: list = []   # [start, done, consume] a copy
        self.reset_stats()

    def reset_stats(self) -> None:
        self.copies, self.bytes, self.host_s = 0, 0, 0.0
        self._busy = self._wait = 0.0
        self._waits = 0

    def _fold(self) -> None:
        """Add the times of the copies that compute has reached and that
        have finished to the totals, and drop their events."""
        keep = []
        for rec in self._records:
            start, done, consume = rec
            if consume is None or not (done.query() and consume.query()):
                keep.append(rec)
                continue
            self._busy += start.elapsed_time(done)
            lag = consume.elapsed_time(done)
            if lag > 0:
                self._waits += 1
                self._wait += lag
        self._records = keep

    def copy(self, arrays: tuple) -> ShardCopy:
        k = self._next
        self._next = (k + 1) % len(self.slots)
        if self._free[k] is not None:
            self._free[k].synchronize()
        t0 = time.perf_counter()
        slot, off, staged = self.slots[k], 0, []
        for a in arrays:
            t = slot[off:off + a.nbytes].view(
                torch.from_numpy(a[:0]).dtype).view(a.shape)
            t.numpy()[...] = a
            staged.append(t)
            off += -(-a.nbytes // _STAGE_ALIGN) * _STAGE_ALIGN
        self.host_s += time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            start.record(self.stream)
            out = tuple(t.to(self.device, non_blocking=True) for t in staged)
            done.record(self.stream)
        self._free[k] = done
        self.copies += 1
        self.bytes += sum(a.nbytes for a in arrays)
        record = [start, done, None]
        if len(self._records) >= 64:
            self._fold()
        self._records.append(record)
        return ShardCopy(out, record)

    def stats(self) -> dict:
        """Since :meth:`reset_stats`: the copies issued, their bytes and
        the host memcpy ms into the ring; of the copies that compute has
        reached, the copy stream's busy ms and how many the compute
        stream waited on, and for how long (ms).  Synchronizes the
        device."""
        torch.cuda.synchronize(self.device)
        self._fold()
        return {"copies": self.copies, "bytes": self.bytes,
                "host_memcpy_ms": self.host_s * 1e3,
                "copy_stream_ms": self._busy, "compute_waits": self._waits,
                "compute_wait_ms": self._wait}


@dataclass
class ShardStore:
    layout: str                  # "dense" | "ell" | "csr"
    D: int
    ntot: int
    B: int
    nbatch: int
    val_dtype: np.dtype
    shards: list[Shard] = field(default_factory=list)
    pinned_idx: frozenset = frozenset()   # device-resident shard indices
    device: torch.device = torch.device("cpu")
    stager: HostStager | None = None
    _cache: dict = field(default_factory=dict)

    @property
    def nshards(self) -> int:
        return len(self.shards)

    def shard_bytes(self, r: int) -> int:
        return sum(a.nbytes for a in self.shards[r].arrays)

    def put(self, r: int) -> ShardCopy:
        """Shard ``r`` on the device.  Shards in ``pinned_idx`` are copied
        once and stay resident; a rotating shard starts a fresh copy,
        which on a CUDA device runs on the stager's stream behind
        whatever compute is queued.  On the CPU the arrays are the host
        arrays themselves."""
        if r in self._cache:
            return self._cache[r]
        arrays = self.shards[r].arrays
        if self.device.type == "cuda":
            if self.stager is None:
                slot = max(sum(-(-a.nbytes // _STAGE_ALIGN) * _STAGE_ALIGN
                               for a in s.arrays) for s in self.shards)
                self.stager = HostStager(self.device, slot)
            dev = self.stager.copy(arrays)
        else:
            dev = ShardCopy(tuple(torch.from_numpy(a).to(self.device)
                                  for a in arrays))
        if r in self.pinned_idx:
            self._cache[r] = dev
        return dev

    @classmethod
    def build(cls, block, B: int, shard_budget: int | None = None,
              layout: str | None = None, pin_budget: int | None = None,
              device: torch.device | str = "cpu") -> "ShardStore":
        """Partition ``block`` (an in-memory CSC data block) into
        host-resident shards of whole batches, each within
        ``shard_budget`` bytes (``MMVAE_SHARD_BYTES``, default 2 GiB; the
        training loop passes its own default).  ``pin_budget``
        (``MMVAE_PIN_BYTES``) keeps as many shards as fit resident on
        the device; the rest rotate, spread evenly over the epoch
        (Bresenham) so each copy hides behind resident shards' compute."""
        if shard_budget is None:
            shard_budget = int(os.environ.get("MMVAE_SHARD_BYTES", 2 << 30))
        rows_c, vals_c, indptr = block.csc_arrays()
        vd = np.dtype(getattr(block, "val_dtype", np.float32))
        D, ntot = block.nfeature(), block.ntot()
        k_max = block.k_max()
        nbatch = ntot // B + (1 if ntot % B else 0)

        idx_dtype = np.int16 if D < (1 << 15) - 1 else np.int32
        # batch-packed CSR pads to the largest batch's nonzeros, not to
        # the densest cell's: fewer bytes for skewed count distributions
        counts = np.diff(indptr)
        sched = np.arange(nbatch * B, dtype=np.int64) % ntot
        batch_nnz = counts[sched].reshape(nbatch, B).sum(axis=1)
        nnz_pad = int(batch_nnz.max()) if nbatch else 0
        row_in_b_dtype = np.int8 if B < (1 << 7) - 1 else np.int16
        csr_batch = nnz_pad * (np.dtype(row_in_b_dtype).itemsize
                               + np.dtype(idx_dtype).itemsize
                               + vd.itemsize)
        dense_row = D * vd.itemsize
        ell_row = k_max * (np.dtype(idx_dtype).itemsize + vd.itemsize)
        if layout is None:
            layout = os.environ.get("MMVAE_SHARD_LAYOUT") or min(
                ("dense", dense_row * B), ("ell", ell_row * B),
                ("csr", csr_batch), key=lambda kv: kv[1])[0]
        if layout not in ("dense", "ell", "csr"):
            raise ValueError(f"unknown shard layout {layout!r}")
        batch_bytes = {"dense": dense_row * B, "ell": ell_row * B,
                       "csr": csr_batch}[layout]

        # balanced whole-batch shards under the budget, R minimal: at
        # most two distinct shard sizes
        cap = max(1, shard_budget // max(1, batch_bytes))
        R = -(-nbatch // cap)
        s = -(-nbatch // R)

        store = cls(layout=layout, D=D, ntot=ntot, B=B, nbatch=nbatch,
                    val_dtype=vd, device=torch.device(device))

        ell_rows = ell_vals = None
        if layout == "ell":
            # one host ELL fill; shards are row slices of it (views, but
            # the wrap-padded final shard)
            ell_rows, ell_vals = ell_fill_host(rows_c, vals_c, indptr, k_max,
                                               vd, ntot)
            if idx_dtype is np.int16:
                ell_rows = ell_rows.astype(np.int16)  # the -1 pad fits

        for r in range(R):
            b0, b1 = r * s, min(nbatch, (r + 1) * s)
            ids = np.arange(b0 * B, b1 * B, dtype=np.int64) % ntot
            if layout == "dense":
                if native.available():
                    x = native.dense_fill(rows_c, vals_c, indptr, D, vd, ids)
                else:
                    x = _dense_fill_np(rows_c, vals_c, indptr, D, vd, ids)
                arrays = (x,)
            elif layout == "csr":
                fill = native.csr_fill if native.available() else _csr_fill_np
                arrays = fill(rows_c, vals_c, indptr, ids, B, nnz_pad,
                              row_in_b_dtype, idx_dtype, vd)
            else:
                lo, hi = b0 * B, b1 * B
                if hi <= ntot:
                    arrays = (ell_rows[lo:hi], ell_vals[lo:hi])
                else:  # the final shard wraps: the head rows after
                    arrays = (
                        np.concatenate([ell_rows[lo:ntot],
                                        ell_rows[:hi - ntot]]),
                        np.concatenate([ell_vals[lo:ntot],
                                        ell_vals[:hi - ntot]]))
            store.shards.append(Shard(b0=b0, nb=b1 - b0, arrays=arrays))

        if pin_budget is None:
            pin_budget = int(os.environ.get("MMVAE_PIN_BYTES", "0"))
        if pin_budget > 0 and R > 1:
            per = max(store.shard_bytes(i) for i in range(R))
            P = min(R - 1, pin_budget // per)
            n_rot = R - P
            # rotating shards at evenly spread positions, so their copies
            # overlap resident shards' compute, not each other
            rot = {int(j * R / n_rot) for j in range(n_rot)}
            store.pinned_idx = frozenset(range(R)) - rot
        return store


def _csr_fill_np(rows_c, vals_c, indptr, ids, B, nnz_pad,
                 row_dtype, idx_dtype, vd):
    """Batch-packed CSR shard fill, (nb, nnz_pad) triplet arrays: each
    batch's cells' nonzeros packed back to back as (row-in-batch, gene,
    value), padded with row sentinel ``B``.  One vectorized numpy pass
    (the native fill's fallback)."""
    nb = len(ids) // B
    starts = indptr[ids]
    cnt = (indptr[ids + 1] - starts).astype(np.int64)
    rows_b = np.full((nb, nnz_pad), B, row_dtype)
    cols = np.zeros((nb, nnz_pad), idx_dtype)
    vals = np.zeros((nb, nnz_pad), vd)
    tot = int(cnt.sum())
    if tot:
        cum = np.concatenate([[0], np.cumsum(cnt)])
        # source positions in the CSC arrays (a multi-range gather)
        pos = (np.arange(tot, dtype=np.int64)
               - np.repeat(cum[:-1], cnt) + np.repeat(starts, cnt))
        batch_of_cell = np.arange(len(ids), dtype=np.int64) // B
        # a cell's base in its batch: the nnz cumsum at the cell minus
        # at its batch's first cell
        off_base = cum[:-1] - cum[batch_of_cell * B]
        dst_col = (np.repeat(off_base, cnt)
                   + (np.arange(tot, dtype=np.int64)
                      - np.repeat(cum[:-1], cnt)))
        dst_row = np.repeat(batch_of_cell, cnt)
        rows_b[dst_row, dst_col] = np.repeat(
            (np.arange(len(ids)) % B).astype(row_dtype), cnt)
        cols[dst_row, dst_col] = rows_c[pos].astype(idx_dtype)
        vals[dst_row, dst_col] = vals_c[pos].astype(vd)
    return rows_b, cols, vals


def _dense_fill_np(rows_c, vals_c, indptr, D, vd, ids):
    """Numpy subset densify (the native fill's fallback): one vectorized
    multi-range gather and scatter."""
    starts = indptr[ids]
    cnt = indptr[ids + 1] - starts
    out = np.zeros((len(ids), D), vd)
    tot = int(cnt.sum())
    if tot:
        cum = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        pos = (np.arange(tot, dtype=np.int64)
               - np.repeat(cum, cnt) + np.repeat(starts, cnt))
        out_row = np.repeat(np.arange(len(ids)), cnt)
        out[out_row, rows_c[pos]] = vals_c[pos]
    return out
