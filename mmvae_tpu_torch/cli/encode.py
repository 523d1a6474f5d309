"""``encode`` — whole-dataset encoding with a trained checkpoint (serving).

Port of ``mmvae_tpu/cli/encode.py`` for ``--model nb``, ``--model vmf``
(the vMF-VAE, ``--latent`` / ``--encoding`` / ``--decoding`` as its
trainer's), ``--model vmfnb`` (the joint model's shared encoder) and
``--model mixture`` (the labeled mixture, with ``--annot`` and
``--row``): load a checkpoint written by either package
(``--checkpoint_dir`` of the trainers, or
:func:`mmvae_tpu_torch.train.checkpoint.save_checkpoint`), sweep the
full dataset once, and write the ``.mu_mean.gz`` / ``.mu_lnvar.gz``
posterior matrices (the vMF-VAE's ``.latent_mean.gz`` /
``.latent_lnvar.gz``, encoded with no covariate as the JAX CLI does),
and for the mixture the ``.clust.gz`` assignments: the frozen model's
hard Gumbel draw, with one (B, K) matrix of uniforms from ``--seed``
reused for every batch.

    python -m mmvae_tpu_torch.cli.encode --model nb|vmf|vmfnb|mixture \
        --mtx data.mtx.gz --checkpoint ckpt_dir --out encoded \
        [--annot annot.txt --row features.txt --seed 0] [--device cuda]

When N x D fits ``MMVAE_DENSE_BYTES`` (default 6 GiB, in the narrowest
lossless dtype) and N is a multiple of ``--batch_size``, the counts are
copied to the device once and the sweep runs there (``dense-resident``);
otherwise batches stream from the file.  Float32 matmuls run in full
float32: TF32 is switched off for cuBLAS and cuDNN.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..data.block import MtxDataBlock
from ..io.index import build_mmutil_index
from ..io.writers import write_data_file
from ..models.nb import NBVAE, params_from_numpy
from ..models.vmf import VMFVAE
from ..models.vmfnb import VMFNBVAE
from ..models.vmfnb_mixture import VMFNBMixtureVAE
from ..train.checkpoint import load_checkpoint
from ..train.config import _csv_ints
from ..train.loop import (as_memory_block, build_dense, encode_resident,
                          encode_streaming)
from ..train.recorder import latent_names
from ..utils.logging import ELOG, TLOG
from .common import warn_unknown_args
from .vmfnb_vae import load_label, resolve_kappa_defaults


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", choices=["nb", "vmf", "vmfnb", "mixture"],
                   default="nb")
    p.add_argument("--mtx", required=True)
    p.add_argument("--idx", default="")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="not ported yet: 1 = single-device serving")
    p.add_argument("--chunk_batches", type=int, default=16,
                   help="batches encoded per kernel launch (resident) or "
                        "per host->device copy (streaming)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the sweep; 'cuda' needs a GPU "
                        "(never falls back to the CPU)")
    # model shape flags must match the training run
    p.add_argument("--mean_encoding", type=_csv_ints, default=())
    p.add_argument("--mean_decoding", type=_csv_ints, default=())
    p.add_argument("--mean_latent", "--latent", dest="mean_latent", type=int,
                   default=2)
    p.add_argument("--encoding", type=_csv_ints, default=())
    p.add_argument("--decoding", type=_csv_ints, default=())
    p.add_argument("--overdisp_encoding", type=int, default=1)
    p.add_argument("--overdisp_latent", type=int, default=1)
    p.add_argument("--relu", dest="do_relu", action="store_true", default=False)
    p.add_argument("--annot", default="")
    p.add_argument("--row", default="")
    p.add_argument("--kappa_min", type=float, default=None)
    p.add_argument("--kappa_max", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    ns, unknown = p.parse_known_args(argv)
    warn_unknown_args(unknown)

    if ns.model == "mixture" and not (ns.annot and ns.row):
        raise ValueError("--model mixture needs --annot and --row")
    if ns.tensor_parallel > 1:
        raise NotImplementedError(
            "--tensor_parallel > 1: not ported yet (ROADMAP.md Queue 1 "
            "item 13, multi-GPU)")
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ELOG(f"--device {ns.device}: no CUDA device is available; pass "
             f"--device cpu to encode on the CPU")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    idx = ns.idx or ns.mtx + ".index"
    if not os.path.exists(idx):
        build_mmutil_index(ns.mtx, idx)
    db = MtxDataBlock(ns.mtx, idx, ns.batch_size)
    D, N = db.nfeature(), db.ntot()

    shape = dict(mean_encoding=ns.mean_encoding,
                 mean_decoding=ns.mean_decoding, mean_latent=ns.mean_latent,
                 overdisp_encoding=ns.overdisp_encoding,
                 overdisp_latent=ns.overdisp_latent, do_relu=ns.do_relu)
    if ns.model == "mixture":
        # kappa enters the mixture's E-step, hence its assignments
        kmin, kmax = resolve_kappa_defaults(ns.kappa_min, ns.kappa_max, True)
        model = VMFNBMixtureVAE(label=load_label(ns.annot, ns.row, D),
                                kappa_min=kmin, kappa_max=kmax, **shape)
    elif ns.model == "nb":
        model = NBVAE(data_dim=D, covar_dim=1, **shape)
    elif ns.model == "vmf":  # kappa does not enter the encoder
        model = VMFVAE(data_dim=D, covar_dim=1, latent=ns.mean_latent,
                       encoding=ns.encoding, decoding=ns.decoding,
                       do_relu=ns.do_relu)
    else:  # --kappa_min / --kappa_max do not enter the joint encoder
        model = VMFNBVAE(data_dim=D, **shape)
    params_np, epoch, _ = load_checkpoint(ns.checkpoint, model)
    params = params_from_numpy(params_np, device)
    TLOG(f"Loaded checkpoint at epoch {epoch - 1}")
    prep = (model.prepare_encoder(params, model.gumbel_uniforms(
        ns.batch_size, ns.seed)) if ns.model == "mixture"
        else model.prepare_encoder(params))

    # same gate as the JAX CLI: a cheap pre-check at 1 byte/count before
    # the whole-file CSC read, then the byte check in the narrow dtype
    dense_budget = int(os.environ.get("MMVAE_DENSE_BYTES", 6 << 30))
    dense_ok = N % ns.batch_size == 0 and 0 < N * D <= dense_budget
    if N % ns.batch_size != 0:
        TLOG(f"resident fast path skipped: N={N} not divisible by "
             f"--batch_size {ns.batch_size} (pick a divisor batch size "
             f"for the fast sweep)")
    elif not dense_ok:
        TLOG(f"resident fast path skipped: N*D={N * D / 1e6:,.0f} MB "
             f"at 1 byte/count exceeds MMVAE_DENSE_BYTES="
             f"{dense_budget / 1e6:,.0f} MB")
    if dense_ok:
        blk = as_memory_block(db)
        vd = np.dtype(getattr(blk, "val_dtype", np.float32))
        dense_ok = N * D * vd.itemsize <= dense_budget
        if not dense_ok:
            TLOG(f"resident fast path skipped: {vd.name} matrix is "
                 f"{N * D * vd.itemsize / 1e6:,.0f} MB > "
                 f"MMVAE_DENSE_BYTES={dense_budget / 1e6:,.0f} MB")

    with torch.inference_mode():
        if dense_ok:
            TLOG(f"Loading data on device (dense-resident, "
                 f"{N * D * vd.itemsize / 1e6:,.0f} MB {vd.name})")
            data = build_dense(blk, device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.time()
            outs = [t.cpu().numpy() for t in encode_resident(
                model, params, data, ns.batch_size, ns.chunk_batches, prep)]
            dt = time.time() - t0
            TLOG(f"Encoded {N} cells in {dt:.3f}s "
                 f"({N / dt:,.0f} cells/sec, dense-resident)")
        else:
            outs = encode_streaming(model, params, db, ns.batch_size,
                                    ns.chunk_batches, device, prep)

    for name, out in zip((*latent_names(model), "clust"), outs):
        write_data_file(f"{ns.out}.{name}.gz", out)
    TLOG("Done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
