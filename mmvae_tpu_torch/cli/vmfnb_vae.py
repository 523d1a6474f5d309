"""``vmfnb_vae`` — joint vMF + NB VAE trainer (PyTorch port).

Port of ``mmvae_tpu/cli/vmfnb_vae.py``: without ``--annot`` the
shared-encoder joint model (reference include/models/vmfnb.hh), with
``--annot`` + ``--row`` the labeled mixture
(include/models/vmfnb_mixture.hh), trained with KL annealing on the data
tier the JAX CLI picks (dense-resident, ELL-resident, rotating host
shards or host streaming; ``train.loop.load_batches``), writing ``${out}.scores.gz`` and the per-epoch
latent and parameter artifacts (the mixture also
``${out}_<epoch>.clust.gz``).

    python -m mmvae_tpu_torch.cli.vmfnb_vae --mtx data.mtx.gz --out run \\
        [--annot annot.txt --row features.txt] \\
        [--mean_encoding 16 --mean_decoding 16 --vmf_decoding 16] \\
        [--no_fused_step] [--no_fused] \\
        [--max_epoch 101 --recording 10 --checkpoint_dir ckpt] \\
        [--resume ckpt] [--device cuda]

Same flags and defaults as the JAX CLI (kappa in [0.1, 10] for the joint
model, [0.1, 100] for the mixture, unless given), plus ``--device``
(default ``cuda``; without a GPU it exits 2 and never falls back to the
CPU).  The step is chosen as the JAX CLI chooses it (:func:`make_step`,
logged in one line): the packed fast step for the direct architecture;
otherwise the generic ``Trainer`` with the step kernels' joint variant
for the NB half (a hidden encoder or ``--vmf_decoding``, direct mu
decoder), or ``forward`` + the composite loss (a hidden mu decoder,
``--no_fused_step``, ``--no_fused``).  The mixture has no vMF decoder:
``--vmf_decoding`` with ``--annot`` is ignored, as in the JAX CLI.
Checkpoints (with the Adam state) load in either package.  On the
dense-resident tier, when the step kernels run (a card, D >= 512), the
genes are reordered cold-first (``train.loop.cluster_features``, as in
JAX; the mixture's annotation follows through
``VMFNBMixtureVAE.permute_features``; artifacts and checkpoints stay in
input order; ``MMVAE_FEATURE_PERM=0`` turns it off, ``force`` turns it
on anywhere).  Data-parallel training:
``--data_parallel`` or ``--dp_shard``, one process a device, started
with ``--num_hosts H --host_id i --coordinator host:port``
(``parallel.multihost``; README, "Data-parallel training").
Tensor-parallel training: ``--tensor_parallel N`` over such a start-up
of a multiple of N ranks, on the generic ``Trainer`` with the model's
TP step (a direct mu decoder under ``--fused --fused_step``, as JAX
requires; README, "Tensor-parallel training").  The covariate file is
read and ignored: neither model has a covariate pathway.
"""

from __future__ import annotations

import sys

from ..data.annotation import Annotation
from ..models.vmfnb import VMFNBVAE, vmfnb_composite_loss
from ..models.vmfnb_mixture import VMFNBMixtureVAE, mixture_composite_loss
from ..ops.vmfnb_fast import VMFNBFastStep, VMFNBMixtureFastStep
from ..train.config import MMVaeOptions, TrainingOptions, _csv_ints
from ..train.loop import Trainer
from ..utils.logging import TLOG, WLOG
from .common import (add_device_flag, add_relu_flags, compose_parsers,
                     multihost_setup, prepare_blocks, resolve_device,
                     run_training, tp_trainer, warn_unknown_args)

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


def make_step(model, topt: TrainingOptions, kl=(1.0, 1e-2, 0.1),
              plain: bool = False, mesh=None):
    """(step, route): the step the JAX CLI runs for the joint or mixture
    ``model`` and the options (``mmvae_tpu/cli/vmfnb_vae.py:252-290``),
    ``plain`` selecting the plain versions of its kernels.

    - a tensor-parallel ``mesh``: the generic ``Trainer`` with
      ``fused_step_report_tp`` / ``fused_step_boot_tp(need_value=False)``
      on the model row (JAX ``cli/vmfnb_vae.py:211-230``);

    - ``--fused --fused_step`` and the direct architecture: the packed
      ``VMFNBFastStep`` / ``VMFNBMixtureFastStep``;
    - ``--fused --fused_step`` with a direct mu decoder (a hidden encoder,
      or ``--vmf_decoding``): the generic ``Trainer`` with
      ``fused_step_report`` / ``fused_step_boot(need_value=False)``;
    - otherwise: the generic ``Trainer`` with ``forward`` + the composite
      loss, the boot losses too (the JAX CLI passes no boot loss, so they
      keep ``lgamma(x + 1)``)."""
    mixture = isinstance(model, VMFNBMixtureVAE)
    R, Rn = model.mean_latent, model.overdisp_latent
    if mesh is not None and mesh.tp:
        return tp_trainer(
            model, topt, kl, (R, Rn) if mixture else (R, Rn, R),
            lambda p, x, c, e, b: model.fused_step_report_tp(
                p, x, c, e, b, mesh.model_group, include_data_const=True),
            lambda p, x, c, e, b: model.fused_step_boot_tp(
                p, x, c, e, b, mesh.model_group, need_value=False)), (
            "generic step, tensor parallel (fused_step_report_tp / "
            "fused_step_boot_tp, grad-only)")
    fused_step = topt.fused and topt.fused_step
    packed = VMFNBMixtureFastStep if mixture else VMFNBFastStep
    if fused_step and packed.supports(model):
        return (packed(model, topt, kl=kl, plain=plain),
                f"packed step ({packed.__name__})")
    kw = {}
    if fused_step and model._can_fuse_step():
        route = ("generic step, v2 step kernels (fused_step_report / "
                 "fused_step_boot, grad-only)")
        kw = dict(
            report_loss_override=lambda p, x, c, e, b: model.fused_step_report(
                p, x, c, e, b, include_data_const=True, plain=plain),
            boot_loss_override=lambda p, x, c, e, b: model.fused_step_boot(
                p, x, c, e, b, need_value=False, plain=plain))
    else:
        route = "generic step, forward + composite loss"
    if mixture:
        dd = model.dd
        loss, widths = (lambda x, out, b: mixture_composite_loss(
            x, out, b, dd)), (R, Rn)
    else:
        loss, widths = vmfnb_composite_loss, (R, Rn, R)
    step = Trainer(
        lambda p, x, c, e, t: model.forward(p, x, e, t, plain=plain), loss,
        topt, kl=kl, eps_widths=widths, **kw)
    return step, route


def main(argv=None) -> int:
    parser = compose_parsers(_MODEL_DESC, _model_args)
    ns, unknown = parser.parse_known_args(argv)
    warn_unknown_args(unknown)
    opts = MMVaeOptions.from_args(ns)
    topt = TrainingOptions.from_args(ns)
    mixture = bool(opts.annot)
    if mixture and not opts.row:
        raise ValueError("--annot requires --row (the feature list)")
    device = resolve_device(ns.device)
    if device is None:
        return 2
    device = topt.apply_runtime_config(device)
    local_b, mesh = multihost_setup(
        opts, topt, device,
        fusable=topt.fused and topt.fused_step and not ns.mean_decoding)
    data_block, covar_block = prepare_blocks(opts, local_batch=local_b)

    TLOG("Constructing a model" + (" (labeled mixture)" if mixture else ""))
    kmin, kmax = resolve_kappa_defaults(ns.kappa_min, ns.kappa_max, mixture)
    shape = dict(mean_encoding=ns.mean_encoding,
                 mean_decoding=ns.mean_decoding, mean_latent=ns.mean_latent,
                 overdisp_encoding=ns.overdisp_encoding,
                 overdisp_latent=ns.overdisp_latent, kappa_min=kmin,
                 kappa_max=kmax, do_relu=ns.do_relu)
    if mixture:
        if ns.vmf_decoding:
            WLOG("--vmf_decoding is ignored with --annot: the mixture has "
                 "no vMF decoder")
        model = VMFNBMixtureVAE(
            label=load_label(opts.annot, opts.row, data_block.nfeature()),
            **shape)
    else:
        model = VMFNBVAE(data_dim=data_block.nfeature(),
                         vmf_decoding=ns.vmf_decoding, **shape)
    fast, route = make_step(model, topt,
                            kl=(opts.kl_max, opts.kl_min, opts.kl_discount),
                            mesh=mesh)
    TLOG(f"Step: {route}")
    return run_training(opts, topt, model, fast, data_block, covar_block,
                        device, mesh, feature_perm=True,
                        feature_perm_apply=(model.permute_features
                                            if mixture else None))


if __name__ == "__main__":
    sys.exit(main())
