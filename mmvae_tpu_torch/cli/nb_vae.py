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

from ..models.nb import NBVAE
from ..ops.nb_fast import NBFastStep
from ..train.config import MMVaeOptions, TrainingOptions, _csv_ints
from ..utils.logging import TLOG
from .common import (add_device_flag, add_relu_flags, compose_parsers,
                     prepare_blocks, refuse_unported, resolve_device,
                     run_training, warn_unknown_args)

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
    add_device_flag(g)


def main(argv=None) -> int:
    parser = compose_parsers(_MODEL_DESC, _model_args)
    ns, unknown = parser.parse_known_args(argv)
    warn_unknown_args(unknown)
    opts = MMVaeOptions.from_args(ns)
    topt = TrainingOptions.from_args(ns)
    hidden = ("--mean_encoding / --mean_decoding"
              if ns.mean_encoding or ns.mean_decoding else None)
    refuse_unported(hidden, topt)
    device = resolve_device(ns.device)
    if device is None:
        return 2

    data_block, covar_block = prepare_blocks(opts)

    TLOG("Constructing a model")
    model = NBVAE(data_dim=data_block.nfeature(),
                  covar_dim=covar_block.nfeature(),
                  mean_latent=ns.mean_latent,
                  overdisp_encoding=ns.overdisp_encoding,
                  overdisp_latent=ns.overdisp_latent, do_relu=ns.do_relu)
    fast = NBFastStep(model, topt,
                      kl=(opts.kl_max, opts.kl_min, opts.kl_discount))
    return run_training(opts, topt, model, fast, data_block, covar_block,
                        device)


if __name__ == "__main__":
    sys.exit(main())
