"""``nb_vae`` — negative binomial VAE trainer (PyTorch port).

Port of ``mmvae_tpu/cli/nb_vae.py`` (reference src/nb_vae_main.cc:39-133)
for the reference's default architecture: parse the option groups,
build indexes and the covariate, construct the model, train with KL
annealing on the dense-resident packed fast step, and write
``${out}.scores.gz`` plus the per-epoch latent and parameter artifacts.

    python -m mmvae_tpu_torch.cli.nb_vae --mtx data.mtx.gz --out run \\
        [--max_epoch 101 --recording 10 --checkpoint_dir ckpt] \\
        [--resume ckpt] [--device cuda]

Same flags as the JAX CLI, plus ``--device`` (default ``cuda``; without a
GPU it exits 2 and never falls back to the CPU).  Checkpoints (with the
Adam state) load in either package.  What the port does not do yet
raises ``NotImplementedError`` naming its ROADMAP.md item: hidden layers
and ``--no_fused_step`` / ``--no_fused`` (item 11), data beyond the dense
device budget (item 12), ``--data_parallel``, ``--dp_shard``,
``--tensor_parallel`` > 1 and multi-host runs (item 13).  Feature
clustering is not applied (item 8).  Float32 matmuls run in full float32
(TF32 off).
"""

from __future__ import annotations

import sys

import torch

from mmvae_tpu.io.writers import write_vector_file
from mmvae_tpu.utils.logging import ELOG, TLOG

from ..models.nb import NBVAE, adam_from_numpy, params_from_numpy
from ..ops.nb_fast import NBFastStep
from ..train.checkpoint import load_checkpoint, load_opt_state, save_checkpoint
from ..train.config import MMVaeOptions, TrainingOptions, _csv_ints
from ..train.loop import train_vae_model
from ..train.recorder import LatentRecorder
from .common import (add_relu_flags, compose_parsers, prepare_blocks,
                     warn_unknown_args)

_MODEL_DESC = r"""[Likelihood]

        Gamma(x + nu)      mu           nu
f(x) = -------------- ( ------- )^x ( ------- )^nu
       Gamma(x+1)Gamma(nu)  mu + nu      mu + nu

mu = exp(decoding(z_mu) + bias_mu)
nu = exp(decoding(z_nu) + bias_nu)
"""


def _model_args(g) -> None:
    """Reference flags: nb.hh:77-112 (with the same aliases)."""
    g.add_argument("--mean_encoding", "--mean-encoding", type=_csv_ints,
                   default=())
    g.add_argument("--mean_decoding", "--mean-decoding", type=_csv_ints,
                   default=())
    g.add_argument("--mean_latent", "--mean-latent", type=int, default=2)
    g.add_argument("--overdisp_encoding", "--overdisp-encoding",
                   "--overdispersion_encoding", "--overdispersion-encoding",
                   dest="overdisp_encoding", type=int, default=1)
    g.add_argument("--overdisp_latent", "--overdispersion_latent",
                   "--overdispersion-latent", dest="overdisp_latent",
                   type=int, default=1)
    add_relu_flags(g)
    g.add_argument("--device", default="cuda",
                   help="torch device of the run; 'cuda' needs a GPU "
                        "(never falls back to the CPU)")


def _refuse_unported(ns, topt: TrainingOptions) -> None:
    item = None
    if ns.mean_encoding or ns.mean_decoding:
        item = "hidden layers (--mean_encoding / --mean_decoding)", 11
    elif not (topt.fused and topt.fused_step):
        item = "--no_fused_step / --no_fused (the generic step path)", 11
    elif topt.data_parallel or topt.dp_shard:
        item = "--data_parallel / --dp_shard", 13
    elif topt.tensor_parallel > 1:
        item = "--tensor_parallel > 1", 13
    elif topt.num_hosts > 1:
        item = "multi-host training (--num_hosts > 1)", 13
    if item is not None:
        raise NotImplementedError(
            f"{item[0]}: not ported yet (ROADMAP.md Queue 1 item {item[1]})")


def main(argv=None) -> int:
    parser = compose_parsers(_MODEL_DESC, _model_args)
    ns, unknown = parser.parse_known_args(argv)
    warn_unknown_args(unknown)
    opts = MMVaeOptions.from_args(ns)
    topt = TrainingOptions.from_args(ns)
    _refuse_unported(ns, topt)
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ELOG(f"--device {ns.device}: no CUDA device is available; pass "
             f"--device cpu to train on the CPU")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    data_block, covar_block = prepare_blocks(opts)

    TLOG("Constructing a model")
    model = NBVAE(data_dim=data_block.nfeature(),
                  covar_dim=covar_block.nfeature(),
                  mean_latent=ns.mean_latent,
                  overdisp_encoding=ns.overdisp_encoding,
                  overdisp_latent=ns.overdisp_latent, do_relu=ns.do_relu)
    fast = NBFastStep(model, topt,
                      kl=(opts.kl_max, opts.kl_min, opts.kl_discount))
    params = model.init(torch.Generator().manual_seed(topt.seed),
                        device=device)
    recorder = LatentRecorder(opts.out, topt.max_epoch, data_block.ntot(),
                              encode_fn=model.encode_mu)

    start_epoch, init_opt_state, prev_losses = 0, None, []
    if topt.resume:
        params_np, start_epoch, prev_losses = load_checkpoint(topt.resume,
                                                              model)
        params = params_from_numpy(params_np, device)
        init_opt_state = adam_from_numpy(load_opt_state(topt.resume, model),
                                         device)
        TLOG(f"Resumed from {topt.resume} at epoch {start_epoch}")

    def on_epoch_end(epoch, p, o, losses):
        save_checkpoint(topt.checkpoint_dir, p, epoch, topt.seed,
                        prev_losses + losses, opt_state=o)

    TLOG("Training the model...")
    params, scores = train_vae_model(
        fast, recorder, data_block, covar_block, topt, params, device,
        start_epoch=start_epoch, init_opt_state=init_opt_state,
        on_epoch_end=on_epoch_end if topt.checkpoint_dir else None,
        metrics_path=opts.out + ".metrics.jsonl")
    write_vector_file(opts.out + ".scores.gz", prev_losses + scores)
    TLOG("Done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
