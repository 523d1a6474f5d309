"""``vmf_vae`` — von Mises-Fisher VAE trainer (PyTorch port).

Port of ``mmvae_tpu/cli/vmf_vae.py`` (reference src/vmf_vae_main.cc:
38-127): parse the option groups, build indexes and the covariate,
construct the model, train with KL annealing on the data tier the JAX
CLI picks (dense-resident, ELL-resident, rotating host shards or host
streaming; ``train.loop.load_batches``), and write ``${out}.scores.gz`` plus the per-epoch ``latent_mean`` /
``latent_lnvar`` and parameter artifacts.

    python -m mmvae_tpu_torch.cli.vmf_vae --mtx data.mtx.gz --out run \\
        [--covar covar.mtx.gz] [--encoding 16 --decoding 16] [--latent 2] \\
        [--kappa_min 0.1 --kappa_max 10] [--relu] [--no_fused_step] \\
        [--max_epoch 101 --recording 10 --checkpoint_dir ckpt] \\
        [--resume ckpt] [--device cuda]

Same flags and defaults as the JAX CLI, plus ``--device`` (default
``cuda``; without a GPU it exits 2 and never falls back to the CPU).
The step is chosen as the JAX CLI chooses it (:func:`make_step`, logged
in one line): the packed ``VMFFastStep`` for the direct architecture
under ``--fused --fused_step``, otherwise the generic ``Trainer`` with
``forward`` + ``vmf_loss``.  Unlike the vMF+NB models the vMF-VAE has a
covariate pathway: the covariate's width is the model's ``covar_dim``.
The model is plain PyTorch (no kernel of the port lies on its path);
float32 matmuls run in full float32 (TF32 off).  Checkpoints (with the
Adam state) load in either package.  The genes are never reordered
(no feature clustering, as in JAX): the vMF-VAE's loss has no lgamma
regimes and its path runs none of the port's kernels, so there is no
tile for the order to speed up.  Data-parallel training: ``--data_parallel`` or
``--dp_shard``, one process a device, started with ``--num_hosts H
--host_id i --coordinator host:port`` (``parallel.multihost``; README,
"Data-parallel training").  Tensor-parallel training:
``--tensor_parallel N`` over such a start-up of a multiple of N ranks,
on the generic ``Trainer`` with ``tp_step_loss`` for the report and the
boot losses, at any architecture (as in JAX; README, "Tensor-parallel
training").
"""

from __future__ import annotations

import sys

from ..models.vmf import VMFVAE
from ..ops.losses import vmf_loss
from ..ops.vmf_fast import VMFFastStep
from ..train.config import MMVaeOptions, TrainingOptions, _csv_ints
from ..train.loop import Trainer
from ..utils.logging import TLOG
from .common import (add_device_flag, add_relu_flags, compose_parsers,
                     multihost_setup, prepare_blocks, resolve_device,
                     run_training, tp_trainer, warn_unknown_args)

_MODEL_DESC = r"""Likelihood:
f(x) = C_d(kappa) exp(kappa mu'x)
where
              kappa^{d/2 - 1}
C_d(kappa) = -----------------------
             (2 pi)^{d/2} I_{d/2-1}(kappa)
"""


def _model_args(g) -> None:
    """Reference flags: vmf.hh:77-104."""
    g.add_argument("--encoding", type=_csv_ints, default=())
    g.add_argument("--decoding", type=_csv_ints, default=())
    g.add_argument("--latent", type=int, default=2)
    g.add_argument("--kappa_min", "--kappa-min", type=float, default=0.1)
    g.add_argument("--kappa_max", "--kappa-max", type=float, default=10.0)
    add_relu_flags(g)
    add_device_flag(g)


def make_step(model: VMFVAE, topt: TrainingOptions, kl=(1.0, 1e-2, 0.1),
              mesh=None):
    """(step, route): the step the JAX CLI runs for ``model`` and the
    options (``mmvae_tpu/cli/vmf_vae.py:104-148``): under a
    tensor-parallel ``mesh`` the generic ``Trainer`` with ``tp_step_loss``
    for the report and the boot losses; the packed ``VMFFastStep`` under
    ``--fused --fused_step`` at the direct architecture; otherwise the
    generic ``Trainer`` with ``forward`` + ``vmf_loss`` for the report
    and the boot losses alike."""
    if mesh is not None and mesh.tp:
        def loss(p, x, c, e, b):
            return model.tp_step_loss(p, x, c, e, b, mesh.model_group)

        return (tp_trainer(model, topt, kl, (model.latent,), loss, loss),
                "generic step, tensor parallel (tp_step_loss)")
    if topt.fused and topt.fused_step and VMFFastStep.supports(model):
        return VMFFastStep(model, topt, kl=kl), "packed step (VMFFastStep)"
    step = Trainer(
        lambda p, x, c, e, t: model.forward(p, x, c, e, t), vmf_loss, topt,
        kl=kl, eps_widths=(model.latent,))
    return step, "generic step, forward + vmf_loss"


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
    local_b, mesh = multihost_setup(opts, topt, device)
    data_block, covar_block = prepare_blocks(opts, local_batch=local_b)

    TLOG("Constructing a model")
    model = VMFVAE(data_dim=data_block.nfeature(),
                   covar_dim=covar_block.nfeature(), latent=ns.latent,
                   encoding=ns.encoding, decoding=ns.decoding,
                   kappa_min=ns.kappa_min, kappa_max=ns.kappa_max,
                   do_relu=ns.do_relu)
    fast, route = make_step(model, topt,
                            kl=(opts.kl_max, opts.kl_min, opts.kl_discount),
                            mesh=mesh)
    TLOG(f"Step: {route}")
    return run_training(opts, topt, model, fast, data_block, covar_block,
                        device, mesh)


if __name__ == "__main__":
    sys.exit(main())
