"""Shared CLI scaffolding of the port's trainers: one parser over the
option groups, index auto-build and covariate auto-creation.

Port of the JAX-free part of ``mmvae_tpu/cli/common.py`` (that module
loads JAX at import), mirroring the setup phase of the reference mains
(src/nb_vae_main.cc:51-82).  Multi-host setup is not ported (ROADMAP.md
Queue 1 item 13).
"""

from __future__ import annotations

import argparse
import os

from mmvae_tpu.data.block import MtxDataBlock, MtxMemoryBlock, create_ones_like
from mmvae_tpu.io.index import build_mmutil_index
from mmvae_tpu.io.mtx import peek_mtx_header
from mmvae_tpu.utils.logging import TLOG, WLOG

from ..train.config import MMVaeOptions, TrainingOptions

# auto data mode: hold the CSC arrays in host RAM below this estimate
_INMEM_BYTES = int(os.environ.get("MMVAE_INMEM_BYTES", 4 << 30))


def compose_parsers(description: str, model_group) -> argparse.ArgumentParser:
    """One argparse parser carrying all three option groups."""
    p = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    MMVaeOptions.add_args(p)
    TrainingOptions.add_args(p)
    model_group(p.add_argument_group("model"))
    return p


def warn_unknown_args(unknown) -> None:
    """Warn about flags no option group claims (the reference parses
    tolerantly; a leftover flag is most likely a typo)."""
    if unknown:
        WLOG("ignoring unrecognized arguments:", " ".join(unknown))


def add_relu_flags(g) -> None:
    g.add_argument("--relu", dest="do_relu", action="store_true",
                   default=False)
    g.add_argument("--no_relu", "--no-relu", dest="do_relu",
                   action="store_false")


def _pick_block_type(opts: MMVaeOptions):
    """Streaming vs in-memory data block (``--data_mode``); batch
    contents are identical either way."""
    if opts.data_mode == "stream":
        return MtxDataBlock
    if opts.data_mode == "memory":
        return MtxMemoryBlock
    hdr = peek_mtx_header(opts.mtx)
    est = hdr.nnz * 8 + (hdr.cols + 1) * 8
    if est <= _INMEM_BYTES:
        TLOG(f"Data fits in memory (~{est / 1e6:,.0f} MB) — "
             "using the in-memory block (--data_mode stream to override)")
        return MtxMemoryBlock
    return MtxDataBlock


def prepare_blocks(opts: MMVaeOptions):
    """Build indexes as needed and construct the data and covariate
    blocks (reference src/nb_vae_main.cc:58-82); without ``--covar`` an
    all-ones 1 x N covariate is written next to the output and flagged
    ``auto_ones``."""
    B = opts.batch_size
    if not os.path.exists(opts.idx):
        build_mmutil_index(opts.mtx, opts.idx)
    block_type = _pick_block_type(opts)
    if block_type is MtxMemoryBlock:
        data_block = block_type(opts.mtx, opts.idx, B, count_dtype="auto")
    else:
        data_block = block_type(opts.mtx, opts.idx, B)

    covar_mtx, covar_idx = opts.covar_mtx, opts.covar_idx
    auto_covar = not covar_mtx or not os.path.exists(covar_mtx)
    if auto_covar:
        covar_mtx = opts.out + ".covar.mtx.gz"
        covar_idx = covar_mtx + ".index"
        create_ones_like(data_block, covar_mtx)
        TLOG("No covariate file is given. So we use this:", covar_mtx)
        if os.path.exists(covar_idx):
            os.remove(covar_idx)
        build_mmutil_index(covar_mtx, covar_idx)
    elif not os.path.exists(covar_idx):
        build_mmutil_index(covar_mtx, covar_idx)
    covar_block = block_type(covar_mtx, covar_idx, B)
    if auto_covar:
        covar_block.auto_ones = True
    return data_block, covar_block
