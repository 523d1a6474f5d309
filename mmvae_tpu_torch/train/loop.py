"""Whole-dataset encoding sweeps and the dense device-resident matrix.

Ports of ``mmvae_tpu/train/loop.py`` ``_as_memory_block`` /
``_build_dense`` and of the two sweeps of ``mmvae_tpu/cli/encode.py``:

- :func:`encode_resident`: the (N, D) counts live on the device in their
  narrow integer dtype; ``chunk`` batches of B rows go through the
  encoder per kernel launch (the encoder works row by row, so grouping
  changes no result);
- :func:`encode_streaming`: batches read from the out-of-core block in
  the reference's sequential wrap-around order, ``chunk`` batches per
  host->device copy.

The training epoch runners come with the training port.
"""

from __future__ import annotations

import numpy as np
import torch

from mmvae_tpu.data.block import MtxDataBlock, MtxMemoryBlock
from mmvae_tpu.data.pipeline import sequential_batches
from mmvae_tpu.io import native
from mmvae_tpu.utils.logging import TLOG


def as_memory_block(block):
    """Coerce a data block to an in-memory (CSC) block."""
    if isinstance(block, MtxDataBlock):
        return MtxMemoryBlock(block.mtx_file, block.idx_file, block.B)
    return block


def build_dense(block, device: torch.device | str) -> torch.Tensor:
    """The (N, D) count matrix on ``device`` in the block's ``val_dtype``
    (int8, int16 or float32): filled on the host — the native one-pass
    fill when the C++ extension loads, a numpy scatter of the CSC arrays
    otherwise — then ONE host->device copy."""
    blk = as_memory_block(block)
    rows, vals, indptr = blk.csc_arrays()
    vd = np.dtype(getattr(blk, "val_dtype", np.float32))
    if native.available():
        TLOG("dense fill: native")
        host = native.dense_fill(rows, vals, indptr, blk.nfeature(), vd)
    else:
        TLOG("dense fill: numpy (native extension unavailable)")
        host = np.zeros((len(indptr) - 1, blk.nfeature()), vd)
        cols = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
        host[cols, rows] = vals.astype(vd)
    return torch.from_numpy(host).to(device)


def encode_resident(model, params: dict, data: torch.Tensor, B: int,
                    chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, R) mean and log-variance of every row of the device-resident
    ``data`` (N % B == 0), ``chunk`` batches per encoder call."""
    N = data.shape[0]
    if N % B:
        raise ValueError(f"resident sweep needs N % B == 0 (N={N}, B={B})")
    prep = model.prepare_encoder(params)
    rows = max(1, chunk) * B
    means, lnvars = [], []
    for lo in range(0, N, rows):
        mean, lnvar = model.encode_prepared(params, prep, data[lo:lo + rows])
        means.append(mean)
        lnvars.append(lnvar)
    return torch.cat(means), torch.cat(lnvars)


def encode_streaming(model, params: dict, db, B: int, chunk: int,
                     device: torch.device | str
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(N, R) host mean and log-variance over the reference's
    sequential wrap-around batches read from ``db``; ``chunk`` batches
    ride one host->device copy and one encoder call."""
    N, D = db.ntot(), db.nfeature()
    batches = sequential_batches(N, B)
    prep = model.prepare_encoder(params)
    chunk = max(1, chunk)
    mean_out = lnvar_out = None
    for i in range(0, len(batches), chunk):
        grp = batches[i:i + chunk]
        xs = np.empty((len(grp) * B, D), np.float32)
        for j, batch in enumerate(grp):
            db.clear()
            xs[j * B:(j + 1) * B] = db.read(batch)
        mean, lnvar = model.encode_prepared(
            params, prep, torch.from_numpy(xs).to(device))
        mean, lnvar = mean.cpu().numpy(), lnvar.cpu().numpy()
        if mean_out is None:
            mean_out = np.zeros((N, mean.shape[1]), np.float32)
            lnvar_out = np.zeros((N, lnvar.shape[1]), np.float32)
        for j, batch in enumerate(grp):
            # wrapped duplicates rewrite identical rows
            mean_out[batch] = mean[j * B:(j + 1) * B]
            lnvar_out[batch] = lnvar[j * B:(j + 1) * B]
    return mean_out, lnvar_out
