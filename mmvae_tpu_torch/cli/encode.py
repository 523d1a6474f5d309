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

``--tensor_parallel N`` serves over the trainers' process start-up
(``--num_hosts W --host_id i --coordinator host:port``, one process a
device; JAX ``cli/encode.py:151-290``): the W ranks form a (W / N, N)
grid, each rank holds its block of the dense matrix's D / N features and
its shard of the parameters, and encodes with the model's TP encoder
(plain PyTorch, its first layer summed over the model row).  The data
axis is ``gcd(W / N, nbatch)`` over whole batch blocks, JAX's lines
naming the ranks left idle; rank 0 gathers the rows and writes the
artifacts.  As in JAX, D % N != 0 logs "TP serving skipped" and the
streaming sweep logs that it runs single-device: rank 0 then serves
alone.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data.block import MtxDataBlock
from ..io.index import build_mmutil_index
from ..io.writers import write_data_file
from ..models.nb import NBVAE, params_from_numpy
from ..models.vmf import VMFVAE
from ..models.vmfnb import VMFNBVAE
from ..models.vmfnb_mixture import VMFNBMixtureVAE
from ..parallel.collectives import gather_rows
from ..parallel.mesh import make_mesh, shard_params
from ..parallel.multihost import barrier, host_role, init_multihost
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
                   help="shard the feature dim D over this many ranks of "
                        "the --num_hosts start-up (1 = single device)")
    p.add_argument("--coordinator", type=str,
                   default=os.environ.get("MMVAE_COORDINATOR", ""))
    p.add_argument("--num_hosts", type=int,
                   default=int(os.environ.get("MMVAE_NUM_HOSTS", "1")))
    p.add_argument("--host_id", type=int,
                   default=int(os.environ.get("MMVAE_HOST_ID", "0")))
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
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ELOG(f"--device {ns.device}: no CUDA device is available; pass "
             f"--device cpu to encode on the CPU")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = init_multihost(ns.coordinator, ns.num_hosts, ns.host_id, device)

    idx = ns.idx or ns.mtx + ".index"
    if host_role() and not os.path.exists(idx):
        build_mmutil_index(ns.mtx, idx)
    barrier()
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

    tp = max(1, ns.tensor_parallel)
    if dense_ok:
        TLOG(f"Loading data on device (dense-resident, "
             f"{N * D * vd.itemsize / 1e6:,.0f} MB {vd.name})")
        if tp > 1 and D % tp:
            TLOG(f"TP serving skipped: D={D} not divisible by "
                 f"--tensor_parallel {tp}; running single-device")
            tp = 1
    elif tp > 1:
        TLOG("TP serving needs the dense-resident sweep; streaming path "
             "runs single-device")
        tp = 1
    if tp > 1:
        outs = _tp_sweep(model, params, blk, ns, tp, device)
    elif host_role():
        # one device: rank 0 of a multi-process start-up serves alone
        prep = (model.prepare_encoder(params, model.gumbel_uniforms(
            ns.batch_size, ns.seed)) if ns.model == "mixture"
            else model.prepare_encoder(params))
        with torch.inference_mode():
            if dense_ok:
                data = build_dense(blk, device)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t0 = time.time()
                outs = [t.cpu().numpy() for t in encode_resident(
                    model, params, data, ns.batch_size, ns.chunk_batches,
                    prep)]
                dt = time.time() - t0
                TLOG(f"Encoded {N} cells in {dt:.3f}s "
                     f"({N / dt:,.0f} cells/sec, dense-resident)")
            else:
                outs = encode_streaming(model, params, db, ns.batch_size,
                                        ns.chunk_batches, device, prep)
    if host_role():
        for name, out in zip((*latent_names(model), "clust"), outs):
            write_data_file(f"{ns.out}.{name}.gz", out)
    TLOG("Done")
    return 0


def _tp_sweep(model, params, blk, ns, tp: int, device) -> list | None:
    """The tensor-parallel resident sweep (JAX ``cli/encode.py:232-290``):
    the (W / tp, tp) grid, a data axis of ``gcd(W / tp, nbatch)`` over
    whole batch blocks (data index d encodes batches [d * nb_loc,
    (d + 1) * nb_loc)), each rank its block of the features; rank 0
    gathers the rows (in input order) from model index 0 of each active
    data index.  Returns the outputs as numpy on rank 0, None elsewhere."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % tp:
        raise ValueError(f"--tensor_parallel {tp} does not divide {world} "
                         f"devices (start a multiple of {tp} ranks with "
                         f"--num_hosts, --host_id and --coordinator)")
    mesh = make_mesh(device, "dp_shard", tp)
    N, D, B = blk.ntot(), blk.nfeature(), ns.batch_size
    nbatch = N // B
    dp = math.gcd(world // tp, nbatch)
    nb_loc = nbatch // dp
    TLOG(f"TP serving over (data={dp}, model={tp}); {nb_loc} batches/shard")
    if dp * tp < world:
        TLOG(f"note: {world - dp * tp} of {world} devices idle (data axis = "
             f"gcd(spare devices, nbatch={nbatch})); pick a batch count "
             f"divisible by {world // tp} to use all devices")
    # every rank makes the gather's group (new_group is collective)
    group = (dist.new_group([d * tp for d in range(dp)]) if dp > 1
             else None)
    d = mesh.data_index
    if d >= dp:
        return None
    specs = model.tp_pspecs(params)
    p = shard_params(params, specs, mesh)
    encode_fn, _ = model.tp_record_encoder(ns.seed, B, None,
                                           mesh.model_group)
    data = build_dense(blk, device, np.arange(d * nb_loc * B,
                                              (d + 1) * nb_loc * B),
                       mesh.local_cols(D))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    with torch.no_grad():
        outs = encode_resident(model, p, data, B, ns.chunk_batches,
                               encode_fn=encode_fn)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if mesh.model_index != 0:
        return None
    if group is not None:
        outs = gather_rows(list(outs), group)
    dt = time.time() - t0
    TLOG(f"Encoded {N} cells in {dt:.3f}s ({N / dt:,.0f} cells/sec, "
         f"dense-resident, TP model={tp})")
    return [t.cpu().numpy() for t in outs] if host_role() else None


if __name__ == "__main__":
    sys.exit(main())
