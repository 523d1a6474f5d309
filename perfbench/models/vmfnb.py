"""The joint vMF + NB VAE as the program trains it: ``VMFNBFastStep``
at the configuration's widths, its layers' products and its kernels'
call shapes (see ``models/nb.py``)."""

from __future__ import annotations


def build(cfg: dict, traffic: dict, seed: int):
    """The program's training step for ``cfg``."""
    from mmvae_tpu_torch.models.vmfnb import VMFNBVAE
    from mmvae_tpu_torch.ops.vmfnb_fast import VMFNBFastStep
    from mmvae_tpu_torch.train.config import TrainingOptions

    model = VMFNBVAE(data_dim=cfg["data_dim"],
                     mean_latent=cfg["mean_latent"],
                     overdisp_encoding=cfg["overdisp_encoding"],
                     overdisp_latent=cfg["overdisp_latent"],
                     kappa_min=cfg["kappa_min"], kappa_max=cfg["kappa_max"],
                     do_relu=cfg["do_relu"])
    opt = TrainingOptions(lr=cfg["lr"], grad_clip=cfg["grad_clip"],
                          nboot=cfg["nboot"],
                          weight_decay=cfg["weight_decay"],
                          superbatch=traffic["superbatch"], seed=seed)
    return VMFNBFastStep(model, opt, kl=(cfg["kl_max"], cfg["kl_min"],
                                         cfg["kl_discount"]))


def covar_dim(cfg: dict) -> int:
    """The all-ones covariate's width: the joint model reads none."""
    return 1


def matmuls(cfg: dict) -> list:
    """(k, n) of every layer applied to a batch's rows (vmfnb.hh:335-447):
    the shared encoder and its heads, the overdispersion encoder and its
    heads, the depth and kappa heads, the NB mean and overdispersion
    decoders and the vMF decoder."""
    D, R = cfg["data_dim"], cfg["mean_latent"]
    H, Rn = cfg["overdisp_encoding"], cfg["overdisp_latent"]
    return [(D, R), (R, R), (R, R), (D, H), (H, Rn), (H, Rn), (D, 1),
            (D, 1), (R, D), (Rn, D), (R, D)]


def kernel_calls(cfg: dict, M: int, xb: int) -> dict:
    """{launch counter: (kernel, shape)} of the joint step's calls on
    batches of M rows: the encoder with row stats (K4s) against the
    standardized mu rows and the vMF decoder rows with its bias (2R + 1)
    and the overdispersion, depth and kappa rows (H + 2), its backward
    (K5), and the NB half's K1, K6p, K2p and K3 with the zero covariate
    column the program hands them (C = 1)."""
    D, R = cfg["data_dim"], cfg["mean_latent"]
    H, Rn = cfg["overdisp_encoding"], cfg["overdisp_latent"]
    s = dict(M=M, D=D, xb=xb, R=R, C=1, Rn=Rn)
    return {
        "count_encode.stats_launches": (
            "count_encode", dict(s, r1=2 * R + 1, r2=H + 2, stats=True)),
        "count_encode_bwd.launches": ("count_encode_bwd",
                                      dict(s, r1=2 * R + 1, r2=H + 2)),
        # K1 and K3 read only the logit rows: the joint flag is K6's and
        # K2's
        "lse.launches": ("nb_lse", dict(s, joint=False)),
        "value.joint_launches": ("nb_value", dict(s, joint=True,
                                                  const=True)),
        "valgrad.joint_launches": ("nb_valgrad", dict(s, joint=True)),
        "finish.launches": ("nb_finish", dict(s, joint=False)),
    }
