"""``vmfnb_vae`` — joint vMF + NB VAE trainer (PyTorch port).

Port of ``mmvae_tpu/cli/vmfnb_vae.py``: without ``--annot`` the
shared-encoder joint model (reference include/models/vmfnb.hh), with
``--annot`` + ``--row`` the labeled mixture
(include/models/vmfnb_mixture.hh), each at its default architecture,
trained with KL annealing on the dense-resident packed fast step,
writing ``${out}.scores.gz`` and the per-epoch latent and parameter
artifacts (the mixture also ``${out}_<epoch>.clust.gz``).

    python -m mmvae_tpu_torch.cli.vmfnb_vae --mtx data.mtx.gz --out run \\
        [--annot annot.txt --row features.txt] \\
        [--max_epoch 101 --recording 10 --checkpoint_dir ckpt] \\
        [--resume ckpt] [--device cuda]

Same flags and defaults as the JAX CLI (kappa in [0.1, 10] for the joint
model, [0.1, 100] for the mixture, unless given), plus ``--device``
(default ``cuda``; without a GPU it exits 2 and never falls back to the
CPU).  Checkpoints (with the Adam state) load in either package.  What
the port does not do yet raises ``NotImplementedError`` naming its
ROADMAP.md item: hidden layers, ``--vmf_decoding`` and
``--no_fused_step`` / ``--no_fused`` (item 11), data beyond the dense
device budget (item 12), ``--data_parallel``, ``--dp_shard``,
``--tensor_parallel`` > 1 and multi-host runs (item 13).  Feature
clustering is not applied (item 8).  The covariate file is read and
ignored: neither model has a covariate pathway.
"""

from __future__ import annotations

import sys

from ..data.annotation import Annotation
from ..models.vmfnb import VMFNBVAE
from ..models.vmfnb_mixture import VMFNBMixtureVAE
from ..ops.vmfnb_fast import VMFNBFastStep, VMFNBMixtureFastStep
from ..train.config import MMVaeOptions, TrainingOptions, _csv_ints
from ..utils.logging import TLOG
from .common import (add_device_flag, add_relu_flags, compose_parsers,
                     prepare_blocks, refuse_unported, resolve_device,
                     run_training, warn_unknown_args)

_MODEL_DESC = "Joint von Mises-Fisher + Negative Binomial VAE"


def resolve_kappa_defaults(kmin, kmax, mixture: bool):
    """Reference ctor defaults differ by mode: joint = .1/10.
    (vmfnb.hh:76-77), mixture = .1/100. (vmfnb_mixture.hh:74-75)."""
    if kmin is None:
        kmin = 0.1
    if kmax is None:
        kmax = 100.0 if mixture else 10.0
    return kmin, kmax


def load_label(annot: str, row: str, D: int):
    """The (D, K) annotation matrix of ``--annot`` over the ``--row``
    feature list; raises when it does not cover the data's D features."""
    L = Annotation(annot, row).matrix()
    if L.shape[0] != D:
        raise ValueError(
            f"annotation covers {L.shape[0]} features but data has {D}")
    return L


def _model_args(g) -> None:
    """Reference flags: vmfnb.hh:93-235 (adds --vmf_decoding)."""
    g.add_argument("--mean_encoding", "--mean-encoding", type=_csv_ints,
                   default=())
    g.add_argument("--mean_decoding", "--mean-decoding", type=_csv_ints,
                   default=())
    g.add_argument("--vmf_decoding", "--vmf-decoding", type=_csv_ints,
                   default=())
    g.add_argument("--mean_latent", "--mean-latent", type=int, default=2)
    g.add_argument("--overdisp_encoding", "--overdisp-encoding",
                   "--overdispersion_encoding", "--overdispersion-encoding",
                   dest="overdisp_encoding", type=int, default=1)
    g.add_argument("--overdisp_latent", "--overdispersion_latent",
                   "--overdispersion-latent", dest="overdisp_latent",
                   type=int, default=1)
    # None = the mode's reference default (resolve_kappa_defaults)
    g.add_argument("--kappa_min", "--kappa-min", type=float, default=None)
    g.add_argument("--kappa_max", "--kappa-max", type=float, default=None)
    add_relu_flags(g)
    add_device_flag(g)


def main(argv=None) -> int:
    parser = compose_parsers(_MODEL_DESC, _model_args)
    ns, unknown = parser.parse_known_args(argv)
    warn_unknown_args(unknown)
    opts = MMVaeOptions.from_args(ns)
    topt = TrainingOptions.from_args(ns)
    mixture = bool(opts.annot)
    if mixture and not opts.row:
        raise ValueError("--annot requires --row (the feature list)")
    hidden = ", ".join(f for f, v in (
        ("--mean_encoding", ns.mean_encoding),
        ("--mean_decoding", ns.mean_decoding),
        ("--vmf_decoding", ns.vmf_decoding)) if v) or None
    refuse_unported(hidden, topt)
    device = resolve_device(ns.device)
    if device is None:
        return 2

    data_block, covar_block = prepare_blocks(opts)

    TLOG("Constructing a model" + (" (labeled mixture)" if mixture else ""))
    kmin, kmax = resolve_kappa_defaults(ns.kappa_min, ns.kappa_max, mixture)
    shape = dict(mean_latent=ns.mean_latent,
                 overdisp_encoding=ns.overdisp_encoding,
                 overdisp_latent=ns.overdisp_latent, kappa_min=kmin,
                 kappa_max=kmax, do_relu=ns.do_relu)
    if mixture:
        model = VMFNBMixtureVAE(
            label=load_label(opts.annot, opts.row, data_block.nfeature()),
            **shape)
        step_cls = VMFNBMixtureFastStep
    else:
        model = VMFNBVAE(data_dim=data_block.nfeature(), **shape)
        step_cls = VMFNBFastStep
    fast = step_cls(model, topt,
                    kl=(opts.kl_max, opts.kl_min, opts.kl_discount))
    return run_training(opts, topt, model, fast, data_block, covar_block,
                        device)


if __name__ == "__main__":
    sys.exit(main())
