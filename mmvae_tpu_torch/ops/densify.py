"""Device-side densification of sparse count layouts.

Port of ``mmvae_tpu/ops/densify.py`` (``ell_fill_host``, ``DeviceCSC``,
``densify_ell``, ``densify_gathered``, ``densify_triplets``).  The JAX
package computes these in XLA (no Pallas kernel), so the port computes
them in plain PyTorch on the tensors' device.

JAX routes padding out of bounds and drops it (``mode="drop"``).
PyTorch has no drop mode: a ``-1`` index would wrap to gene ``D - 1``
and an index ``>= D`` raises (on the card, a device assert).  So every
scatter here writes into a flat ``(B * D + 1,)`` buffer whose last slot
takes every padded or out-of-bounds entry, and the first ``B * D``
elements are viewed as the (B, D) batch without a copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io import native


def ell_fill_host(rows, vals, indptr, k_max: int, val_dtype, N: int):
    """Host padded-ELL fill from CSC arrays: (N, k_max) int32 rows,
    ``-1``-padded, and values in ``val_dtype`` — the native one-pass
    fill when the extension loads, a vectorized numpy scatter otherwise.
    Shared by :class:`DeviceCSC` and the rotating
    :class:`~mmvae_tpu_torch.data.shards.ShardStore`."""
    if native.available() and k_max > 0:
        return native.ell_fill(rows, vals, indptr, k_max, val_dtype)
    ell_rows = np.full((N, k_max), -1, dtype=np.int32)
    ell_vals = np.zeros((N, k_max), dtype=val_dtype)
    if len(rows):
        counts = np.diff(indptr)
        col_ids = np.repeat(np.arange(N, dtype=np.int64), counts)
        offs = np.arange(len(rows), dtype=np.int64) - np.repeat(
            indptr[:-1].astype(np.int64), counts)
        ell_rows[col_ids, offs] = rows
        ell_vals[col_ids, offs] = vals
    return ell_rows, ell_vals


class DeviceCSC:
    """A sparse (D, N) matrix resident on ``device`` in padded-ELL
    layout: for each of the N columns (cells), up to ``k_max`` (gene,
    value) pairs, padded with (-1, 0).  Memory: N * k_max * (4 + value
    bytes), proportional to the densest cell, not to N * D."""

    def __init__(self, rows: np.ndarray, vals: np.ndarray,
                 indptr: np.ndarray, shape: tuple[int, int],
                 count_dtype: str = "float32", val_dtype=None,
                 device: torch.device | str = "cpu"):
        self.D, self.N = shape
        if val_dtype is None:
            from ..data.block import narrow_value_dtype

            val_dtype = (narrow_value_dtype(vals)
                         if count_dtype == "auto" else np.float32)
        counts = np.diff(indptr)
        self.k_max = int(counts.max()) if len(counts) else 0
        ell_rows, ell_vals = ell_fill_host(rows, vals, indptr, self.k_max,
                                           val_dtype, self.N)
        self.ell_rows = torch.from_numpy(ell_rows).to(device)
        self.ell_vals = torch.from_numpy(ell_vals).to(device)

    @classmethod
    def from_memory_block(cls, block, count_dtype: str = "float32",
                          device: torch.device | str = "cpu"
                          ) -> "DeviceCSC":
        rows, vals, indptr = block.csc_arrays()
        # reuse the block's value-dtype decision when it matches the
        # request (no second scan of the values)
        vd = getattr(block, "val_dtype", None)
        return cls(rows, vals, indptr, (block.nfeature(), block.ntot()),
                   count_dtype=count_dtype,
                   val_dtype=(vd if count_dtype == "auto" else None),
                   device=device)

    def densify(self, cols: torch.Tensor) -> torch.Tensor:
        """(B,) column ids -> the dense (B, D) batch, on the device."""
        return densify_ell(self.ell_rows, self.ell_vals, cols, self.D)


def _scatter(flat: torch.Tensor, ok: torch.Tensor, v: torch.Tensor,
             B: int, D: int) -> torch.Tensor:
    """Set ``v`` at the flat (B * D) positions ``flat`` where ``ok``;
    every other entry goes to one spill slot past the batch."""
    idx = torch.where(ok, flat, torch.full_like(flat, B * D))
    out = torch.zeros(B * D + 1, dtype=v.dtype, device=v.device)
    out[idx.reshape(-1)] = v.reshape(-1)
    return out[:B * D].view(B, D)


def densify_ell(ell_rows: torch.Tensor, ell_vals: torch.Tensor,
                cols: torch.Tensor, D: int) -> torch.Tensor:
    """Gather the ELL rows of ``cols`` and scatter them into a zeroed
    (B, D) batch.  Duplicate ``cols`` each get their column's values,
    as the duplicate-aware host reader gives them."""
    cols = cols.to(device=ell_rows.device, dtype=torch.long)
    return densify_gathered(ell_rows.index_select(0, cols),
                            ell_vals.index_select(0, cols), D)


def densify_gathered(r: torch.Tensor, v: torch.Tensor, D: int
                     ) -> torch.Tensor:
    """Scatter pre-gathered (B, K) ELL slices into a dense (B, D) batch
    in ``v``'s dtype.  ``r`` may be any signed integer dtype: the
    rotating tier ships int16 gene indices and they are widened here,
    after the gather, where the slice is only (B, K).  Entries outside
    [0, D) (the ``-1`` pad) are dropped."""
    B, K = r.shape
    r = r.long()
    flat = torch.arange(B, device=r.device).unsqueeze(1) * D + r
    return _scatter(flat, (r >= 0) & (r < D), v, B, D)


def densify_triplets(r: torch.Tensor, c: torch.Tensor, v: torch.Tensor,
                     B: int, D: int) -> torch.Tensor:
    """Scatter one batch of packed (row-in-batch, gene, value) triplets
    (the rotating tier's batch-packed CSR layout) into a dense (B, D)
    batch in ``v``'s dtype.  Pads carry the row sentinel ``B`` and are
    dropped, as is any entry outside the (B, D) batch.  Narrow indices
    widen here."""
    r, c = r.long(), c.long()
    ok = (r >= 0) & (r < B) & (c >= 0) & (c < D)
    return _scatter(r * D + c, ok, v, B, D)
