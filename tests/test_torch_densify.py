"""The port's densify ops (mmvae_tpu_torch.ops.densify) against the JAX
package's (mmvae_tpu.ops.densify) on the same seeded numpy inputs,
bitwise: the padded-ELL gather and scatter, the pre-gathered scatter,
the batch-packed triplet scatter and ``DeviceCSC.from_memory_block``.

The JAX functions drop padding with an out-of-bounds scatter; the port
routes it to a spill slot, so the cases put a pad next to a nonzero at
gene D - 1 (where a wrapped ``-1`` would land) and repeat columns."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.data import MtxMemoryBlock as JBlock
from mmvae_tpu.ops import densify as jd
from mmvae_tpu_torch.data.block import MtxMemoryBlock
from mmvae_tpu_torch.ops import densify as pd

VAL_DTYPES = [np.int8, np.int16, np.float32]


def _ell(rng, N, D, K, val_dtype, idx_dtype=np.int32):
    """(N, K) ELL rows and values: each cell's genes unique, ascending,
    ``-1``-padded after them; every cell has gene D - 1 as its last
    nonzero, so the first pad sits right after it."""
    rows = np.full((N, K), -1, idx_dtype)
    vals = np.zeros((N, K), val_dtype)
    for n in range(N):
        k = int(rng.integers(1, K))  # at least one pad
        genes = np.sort(rng.choice(D - 1, size=k - 1, replace=False))
        rows[n, :k] = np.append(genes, D - 1)
        v = rng.integers(1, 120, size=k)
        vals[n, :k] = (v + 0.25 if val_dtype == np.float32 else v)
    return rows, vals


@pytest.mark.parametrize("val_dtype", VAL_DTYPES)
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int16])
def test_densify_ell_matches_jax(val_dtype, idx_dtype):
    rng = np.random.default_rng(3)
    N, D, K, B = 30, 50, 9, 12
    rows, vals = _ell(rng, N, D, K, val_dtype, idx_dtype)
    cols = np.array([4, 4, 0, 29, 4, 17, 17, 3, 3, 3, 11, 28])  # duplicates
    want = np.asarray(jd.densify_ell(jnp.asarray(rows), jnp.asarray(vals),
                                     jnp.asarray(cols), D))
    got = pd.densify_ell(torch.from_numpy(rows), torch.from_numpy(vals),
                         torch.from_numpy(cols), D).numpy()
    assert got.dtype == want.dtype == val_dtype and got.shape == (B, D)
    np.testing.assert_array_equal(got, want)
    # every batch row holds its cell's gene D - 1 and nothing else wraps
    np.testing.assert_array_equal(got[:, D - 1], vals[cols, (rows[cols] >= 0)
                                  .sum(1) - 1])


@pytest.mark.parametrize("val_dtype", VAL_DTYPES)
def test_densify_gathered_matches_jax(val_dtype):
    """Pre-gathered int16 slices (the rotating tier's ELL shards), with
    an index outside [0, D) besides the pads."""
    rng = np.random.default_rng(4)
    B, D, K = 16, 40, 7
    r, v = _ell(rng, B, D, K, val_dtype, np.int16)
    r[5, -1], v[5, -1] = D + 3, 9  # out of bounds: dropped by both
    want = np.asarray(jd.densify_gathered(jnp.asarray(r), jnp.asarray(v), D))
    got = pd.densify_gathered(torch.from_numpy(r), torch.from_numpy(v),
                              D).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("val_dtype", VAL_DTYPES)
@pytest.mark.parametrize("row_dtype,idx_dtype", [(np.int8, np.int16),
                                                 (np.int16, np.int32)])
def test_densify_triplets_matches_jax(val_dtype, row_dtype, idx_dtype):
    """One batch of packed (row-in-batch, gene, value) triplets padded
    with row sentinel B (gene 0), next to real entries at gene D - 1."""
    rng = np.random.default_rng(5)
    B, D, nnz_pad = 10, 60, 80
    r = np.full(nnz_pad, B, row_dtype)
    c = np.zeros(nnz_pad, idx_dtype)
    v = np.zeros(nnz_pad, val_dtype)
    at = 0
    for b in range(B):
        genes = np.append(np.sort(rng.choice(D - 1, 4, replace=False)),
                          D - 1)
        n = len(genes)
        r[at:at + n], c[at:at + n] = b, genes
        v[at:at + n] = rng.integers(1, 100, n)
        at += n
    want = np.asarray(jd.densify_triplets(jnp.asarray(r), jnp.asarray(c),
                                          jnp.asarray(v), B, D))
    got = pd.densify_triplets(torch.from_numpy(r), torch.from_numpy(c),
                              torch.from_numpy(v), B, D).numpy()
    assert got.dtype == val_dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("count_dtype", ["float32", "auto"])
def test_device_csc_from_memory_block_matches_jax(mtx_file, count_dtype):
    """The ELL arrays, ``k_max`` and densified batches of the two
    packages' ``DeviceCSC`` over the same file, bitwise."""
    path, idx, dens = mtx_file
    B = 12
    jcsc = jd.DeviceCSC.from_memory_block(JBlock(path, idx, B),
                                          count_dtype=count_dtype)
    pcsc = pd.DeviceCSC.from_memory_block(MtxMemoryBlock(path, idx, B),
                                          count_dtype=count_dtype,
                                          device="cpu")
    assert pcsc.k_max == jcsc.k_max and (pcsc.D, pcsc.N) == (jcsc.D, jcsc.N)
    np.testing.assert_array_equal(pcsc.ell_rows.numpy(),
                                  np.asarray(jcsc.ell_rows))
    np.testing.assert_array_equal(pcsc.ell_vals.numpy(),
                                  np.asarray(jcsc.ell_vals))
    assert pcsc.ell_vals.numpy().dtype == np.asarray(jcsc.ell_vals).dtype
    cols = np.array([3, 3, 0, 119, 3, 7, 8, 9, 10, 110, 111, 3])
    got = pcsc.densify(torch.from_numpy(cols)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jcsc.densify(jnp.asarray(cols))))
    np.testing.assert_array_equal(got.astype(np.float32), dens[:, cols].T)


def test_ell_fill_host_numpy_matches_native(mtx_file, monkeypatch):
    """The numpy fill (no native extension) gives the native fill's
    arrays."""
    from mmvae_tpu_torch.io import native

    path, idx, _ = mtx_file
    blk = MtxMemoryBlock(path, idx, 12)
    rows, vals, indptr = blk.csc_arrays()
    args = (rows, vals, indptr, blk.k_max(), np.int8, blk.ntot())
    want = pd.ell_fill_host(*args)
    monkeypatch.setattr(native, "available", lambda: False)
    got = pd.ell_fill_host(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
