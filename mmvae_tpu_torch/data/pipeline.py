"""Async host-side input pipeline.

The reference's training loop blocks on synchronous BGZF reads between
optimizer steps (reference: include/mmvae_alg.hh:268-311).  On TPU the
step runs asynchronously under jit dispatch, so the host can decode the
next minibatches while the device computes.  :class:`PrefetchLoader`
runs the data/covariate block reads on a background thread pool and
hands out ready (x, c) batch pairs a configurable depth ahead.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np


def sequential_batches(ntot: int, batch_size: int) -> list[np.ndarray]:
    """The reference's deterministic batch schedule: sequential,
    non-shuffled, wrap-around — batch[j] = (b*B + j) % ntot
    (reference: include/mmvae_alg.hh:261-266)."""
    nbatch = ntot // batch_size
    if nbatch * batch_size < ntot:
        nbatch += 1
    return [
        (np.arange(batch_size, dtype=np.int64) + b * batch_size) % ntot
        for b in range(nbatch)
    ]


class PrefetchLoader:
    """Iterate (batch_indices, x, c) with multi-threaded prefetch.

    ``data_block`` and ``covar_block`` follow the DATA_BLOCK contract.
    ``workers`` batches decode concurrently, each into its own buffer
    (``read_into`` is stateless and the native BGZF reader releases the
    GIL), and results are yielded strictly in schedule order.  At
    atlas-scale feature widths the per-batch triplet parse dominates the
    host side; threading it is what keeps 8 chips fed (SURVEY §7.3.2).
    """

    def __init__(self, data_block, covar_block, batches: Sequence[np.ndarray],
                 depth: int = 2, workers: int = 4):
        self.data_block = data_block
        self.covar_block = covar_block
        self.batches = list(batches)
        self.depth = max(1, depth)
        self.workers = max(1, workers)

    def __len__(self) -> int:
        return len(self.batches)

    @staticmethod
    def _read_block(blk, batch: np.ndarray) -> np.ndarray:
        if hasattr(blk, "read_into"):
            # fresh buffer per call, matching the block's own buffer dtype
            # (keeps the int8/int16 narrow-transfer optimization alive)
            dtype = getattr(blk, "array", None)
            dtype = dtype.dtype if dtype is not None else np.float32
            return blk.read_into(
                batch, np.zeros((blk.size(), blk.nfeature()), dtype)
            )
        # Foreign blocks without a stateless reader mutate shared state:
        # serialize them (a races-by-default fallback corrupted batches
        # in round 1).
        with PrefetchLoader._FALLBACK_LOCK:
            blk.clear()
            return blk.read(batch).copy()

    _FALLBACK_LOCK = threading.Lock()

    def _load_one(self, batch: np.ndarray):
        x = self._read_block(self.data_block, batch)
        c = self._read_block(self.covar_block, batch)
        return batch, x, c

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending = []
            nahead = self.workers + self.depth
            it = iter(self.batches)
            for batch in it:
                pending.append(pool.submit(self._load_one, batch))
                if len(pending) >= nahead:
                    break
            for batch in it:
                yield pending.pop(0).result()
                pending.append(pool.submit(self._load_one, batch))
            for fut in pending:
                yield fut.result()
