"""``nb_vae`` — negative binomial VAE trainer (PyTorch port).

Port of ``mmvae_tpu/cli/nb_vae.py`` (reference src/nb_vae_main.cc:39-133):
parse the option groups, build indexes and the covariate, construct the
model, train with KL annealing on the data tier the JAX CLI picks
(dense-resident, ELL-resident, rotating host shards or host streaming;
``train.loop.load_batches``), and write
``${out}.scores.gz`` plus the per-epoch latent and parameter artifacts.

    python -m mmvae_tpu_torch.cli.nb_vae --mtx data.mtx.gz --out run \\
        [--mean_encoding 16 --mean_decoding 16] [--no_fused_step] \\
        [--no_fused] [--max_epoch 101 --recording 10 --checkpoint_dir ckpt] \\
        [--resume ckpt] [--device cuda]

Same flags as the JAX CLI, plus ``--device`` (default ``cuda``; without a
GPU it exits 2 and never falls back to the CPU).  The step is chosen as
the JAX CLI chooses it (:func:`make_step`, logged in one line): the
packed fast step for the default architecture; otherwise the generic
``Trainer`` with the v2 step kernels (hidden encoder, direct decoder),
the v1 ELBO kernels K7 / K8 (a hidden decoder, or ``--no_fused_step``),
or plain ``forward`` + ``nb_loss`` (``--no_fused``).  Checkpoints (with
the Adam state) load in either package.  On the dense-resident tier,
when the step kernels run (a card, D >= 512), the genes are reordered
cold-first (``train.loop.cluster_features``, as in JAX; artifacts and
checkpoints stay in input order; ``MMVAE_FEATURE_PERM=0`` turns it off,
``force`` turns it on anywhere).  Float32 matmuls run in full float32
(TF32 off).  Data-parallel training: ``--data_parallel`` or ``--dp_shard``,
one process a device, started with ``--num_hosts H --host_id i
--coordinator host:port`` (``parallel.multihost``; README,
"Data-parallel training").  Tensor-parallel training:
``--tensor_parallel N`` over such a start-up of a multiple of N ranks,
on the generic ``Trainer`` with the model's TP step (a direct mu
decoder under ``--fused --fused_step``, as JAX requires; README,
"Tensor-parallel training").
"""

from __future__ import annotations

import sys

from ..models.nb import NBVAE
from ..ops.losses import nb_loss
from ..ops.nb_fast import NBFastStep
from ..train.loop import Trainer
from ..train.config import MMVaeOptions, TrainingOptions, _csv_ints
from ..utils.logging import TLOG
from .common import (add_device_flag, add_relu_flags, compose_parsers,
                     multihost_setup, prepare_blocks, resolve_device,
                     run_training, tp_trainer, warn_unknown_args)

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


def make_step(model: NBVAE, topt: TrainingOptions, kl=(1.0, 1e-2, 0.1),
              plain: bool = False, mesh=None):
    """(step, route): the step the JAX CLI runs for ``model`` and the
    options (``mmvae_tpu/cli/nb_vae.py:149-192``), ``plain`` selecting
    the plain versions of its kernels.

    - a tensor-parallel ``mesh``: the generic ``Trainer`` with
      ``fused_step_report_tp`` / ``fused_step_boot_tp(need_value=False)``
      on the model row (the packed step is off under TP, as in JAX);

    - ``--fused --fused_step`` and the default architecture: the packed
      ``NBFastStep``;
    - ``--fused --fused_step``, direct mu decoder (hidden encoder): the
      generic ``Trainer`` with ``fused_step_report`` /
      ``fused_step_boot(need_value=False)``;
    - ``--fused``: the generic ``Trainer`` with ``fused_loss`` (K7 / K8;
      the report with ``lgamma(x + 1)``, the boot losses without);
    - otherwise: the generic ``Trainer`` with ``forward`` + ``nb_loss``."""
    if mesh is not None and mesh.tp:
        return tp_trainer(
            model, topt, kl, (model.mean_latent, model.overdisp_latent),
            lambda p, x, c, e, b: model.fused_step_report_tp(
                p, x, c, e, b, mesh.model_group, include_data_const=True),
            lambda p, x, c, e, b: model.fused_step_boot_tp(
                p, x, c, e, b, mesh.model_group, need_value=False),
            mesh), (
            "generic step, tensor parallel (fused_step_report_tp / "
            "fused_step_boot_tp, grad-only)")
    fused_step = topt.fused and topt.fused_step
    if fused_step and NBFastStep.supports(model):
        return (NBFastStep(model, topt, kl=kl, plain=plain),
                "packed step (NBFastStep)")
    kw = {}
    if fused_step and model._can_fuse_step():
        route = ("generic step, v2 step kernels (fused_step_report / "
                 "fused_step_boot, grad-only)")
        kw = dict(
            report_loss_override=lambda p, x, c, e, b: model.fused_step_report(
                p, x, c, e, b, include_data_const=True, plain=plain),
            boot_loss_override=lambda p, x, c, e, b: model.fused_step_boot(
                p, x, c, e, b, need_value=False, plain=plain))
    elif topt.fused:
        route = "generic step, v1 ELBO kernels (fused_loss)"
        kw = dict(
            report_loss_override=lambda p, x, c, e, b: model.fused_loss(
                p, x, c, e, b, True, include_data_const=True, plain=plain),
            boot_loss_override=lambda p, x, c, e, b: model.fused_loss(
                p, x, c, e, b, True, include_data_const=False, plain=plain))
    else:
        route = "generic step, forward + nb_loss"
    step = Trainer(
        lambda p, x, c, e, t: model.forward(p, x, c, e, t, plain=plain),
        lambda x, out, b: nb_loss(x, *out, b), topt, kl=kl,
        eps_widths=(model.mean_latent, model.overdisp_latent),
        # gradient steps skip the lgamma(x+1) data constant (same grads)
        boot_loss_fn=lambda x, out, b: nb_loss(x, *out, b,
                                               include_data_const=False),
        **kw)
    return step, route


def main(argv=None) -> int:
    parser = compose_parsers(_MODEL_DESC, _model_args)
    ns, unknown = parser.parse_known_args(argv)
    warn_unknown_args(unknown)
    opts = MMVaeOptions.from_args(ns)
    topt = TrainingOptions.from_args(ns)
    device = resolve_device(ns.device)
    if device is None:
        return 2
    device = topt.apply_runtime_config(device)
    local_b, mesh = multihost_setup(
        opts, topt, device,
        fusable=topt.fused and topt.fused_step and not ns.mean_decoding)
    data_block, covar_block = prepare_blocks(opts, local_batch=local_b)

    TLOG("Constructing a model")
    model = NBVAE(data_dim=data_block.nfeature(),
                  covar_dim=covar_block.nfeature(),
                  mean_encoding=ns.mean_encoding,
                  mean_decoding=ns.mean_decoding,
                  mean_latent=ns.mean_latent,
                  overdisp_encoding=ns.overdisp_encoding,
                  overdisp_latent=ns.overdisp_latent, do_relu=ns.do_relu)
    fast, route = make_step(model, topt,
                            kl=(opts.kl_max, opts.kl_min, opts.kl_discount),
                            mesh=mesh)
    TLOG(f"Step: {route}")
    # no D-indexed constant lives outside the NB parameters
    return run_training(opts, topt, model, fast, data_block, covar_block,
                        device, mesh, feature_perm=True)


if __name__ == "__main__":
    sys.exit(main())
