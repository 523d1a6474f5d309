"""The NB-VAE as the program trains it: ``NBFastStep`` (the packed step)
at the configuration's widths, and what the benchmark's yardsticks need
of it: the layers' products (``flops.py``) and the shape of each
hand-written kernel's calls (``roofline.py``), keyed by the program's
launch counters (``train.superbatch.launch_counters``)."""

from __future__ import annotations


def build(cfg: dict, traffic: dict, seed: int):
    """The program's training step for ``cfg``."""
    from mmvae_tpu_torch.models.nb import NBVAE
    from mmvae_tpu_torch.ops.nb_fast import NBFastStep
    from mmvae_tpu_torch.train.config import TrainingOptions

    model = NBVAE(data_dim=cfg["data_dim"], covar_dim=cfg["covar_dim"],
                  mean_latent=cfg["mean_latent"],
                  overdisp_encoding=cfg["overdisp_encoding"],
                  overdisp_latent=cfg["overdisp_latent"],
                  do_relu=cfg["do_relu"])
    opt = TrainingOptions(lr=cfg["lr"], grad_clip=cfg["grad_clip"],
                          nboot=cfg["nboot"],
                          weight_decay=cfg["weight_decay"],
                          superbatch=traffic["superbatch"], seed=seed)
    return NBFastStep(model, opt, kl=(cfg["kl_max"], cfg["kl_min"],
                                      cfg["kl_discount"]))


def covar_dim(cfg: dict) -> int:
    return cfg["covar_dim"]


def matmuls(cfg: dict) -> list:
    """(k, n) of every layer applied to a batch's rows (nb.hh:299-401):
    the encoder, its heads and the covariate's, the overdispersion
    encoder and heads, the depth head, the three decoders."""
    D, C, R = cfg["data_dim"], cfg["covar_dim"], cfg["mean_latent"]
    H, Rn = cfg["overdisp_encoding"], cfg["overdisp_latent"]
    return [(D, R), (R, R), (R, R), (C, R), (D, H), (H, Rn), (H, Rn),
            (D, 1), (R, D), (C, D), (Rn, D)]


def kernel_calls(cfg: dict, M: int, xb: int) -> dict:
    """{launch counter: (kernel, shape)} of the packed step's calls on
    batches of M rows: the encoder (K4) against the standardized mu rows
    (R) and the overdispersion and depth rows (H + 1), its backward (K5),
    K1 and K6 in the reporting pass, K1, K2 and K3 in each boot pass."""
    D, C, R = cfg["data_dim"], cfg["covar_dim"], cfg["mean_latent"]
    H, Rn = cfg["overdisp_encoding"], cfg["overdisp_latent"]
    s = dict(M=M, D=D, xb=xb, R=R, C=C, Rn=Rn, joint=False)
    return {
        "count_encode.launches": ("count_encode",
                                  dict(s, r1=R, r2=H + 1, stats=False)),
        "count_encode_bwd.launches": ("count_encode_bwd",
                                      dict(s, r1=R, r2=H + 1)),
        "lse.launches": ("nb_lse", s),
        "value.launches": ("nb_value", dict(s, const=True)),
        "valgrad.launches": ("nb_valgrad", s),
        "finish.launches": ("nb_finish", s),
    }
