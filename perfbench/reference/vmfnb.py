"""Plain reference of the joint vMF + NB VAE (YPARK/mm-vae
``include/models/vmfnb.hh``) at its direct architecture.

One shared encoder: ``log1p(x)`` normalized to unit rows, standardized
with ``softplus(ln_x_sd) + 1e-2`` (vmfnb.hh:601-611), a linear layer and
its mean and log-variance heads (vmfnb.hh:449-460).  The overdispersion
encoder on the raw counts, its hidden layer ReLU'd (vmfnb.hh:477-486);
the depth head ``softplus(x @ w + b)``; the concentration ``kappa =
exp(clamp(x @ w + b, fasterlog(kappa_min), fasterlog(kappa_max)))``
(vmfnb.hh:535-538).  Three draws from the posteriors (NB mean, NB
overdispersion, vMF direction; vmfnb.hh:519-533).  NB half:
``exp(log_softmax(z @ W + b) + mu_bias) * depth`` (vmfnb.hh:462-467),
``clamp(exp(z_nu @ W + b - nu_bias), 0, 1e4)`` (vmfnb.hh:488-493).
vMF half: the unit direction ``normalize(z @ W + b)`` against the
observation ``normalize(log1p(relu(x)) + 1e-2 / D)``, per row ``kappa
cos + df log kappa - log I_df(kappa) - D/2 fasterlog(2 pi)``, ``df = D/2
- 1`` (vmfnb.hh:554-574).  Loss: (NB NLL + vMF NLL + beta (KL_mu +
KL_nu)) / rows (vmfnb.hh:727-758).
"""

from __future__ import annotations

import math

import torch

from . import common

#: the encoder's first-layer weight, contracted against the counts
ENCODER_LEAF = "nb_mu_encoding.weight"


def eps_widths(cfg: dict) -> tuple:
    """The widths of a loss's three reparameterizations: (NB mean, NB
    overdispersion, vMF direction)."""
    R = cfg["mean_latent"]
    return (R, cfg["overdisp_latent"], R)


def init_params(cfg: dict, gen: torch.Generator, device) -> dict:
    """Parameters at the published initialization, one draw of ``gen``."""
    D, R = cfg["data_dim"], cfg["mean_latent"]
    H, Rn = cfg["overdisp_encoding"], cfg["overdisp_latent"]
    layers = [("nb_mu_encoding", D, R), ("nb_mu_representation_mean", R, R),
              ("nb_mu_representation_logvariance", R, R),
              ("nb_mu_decoding", R, D), ("nb_nu_encoding", D, H),
              ("nb_nu_representation_mean", H, Rn),
              ("nb_nu_representation_logvariance", H, Rn),
              ("nb_nu_decoding", Rn, D), ("depth", D, 1), ("ln_kappa", D, 1),
              ("vmf_mu_decoding", R, D)]
    spec = []
    for name, d_in, d_out in layers:
        spec += [(f"{name}.weight", (d_in, d_out), d_in),
                 (f"{name}.bias", (d_out,), d_in)]
    flat = common.uniform_leaves(gen, spec, device)
    tree = {name: {"weight": flat[f"{name}.weight"],
                   "bias": flat[f"{name}.bias"]} for name, _, _ in layers}
    tree["x_mean"] = torch.zeros((1, D), device=device)
    tree["ln_x_sd"] = torch.ones((1, D), device=device)
    tree["mu_bias"] = torch.zeros((1, D), device=device)
    tree["nu_bias"] = torch.zeros((1, D), device=device)
    return tree


def loss(cfg: dict, p: dict, x, c, eps, beta: float, include_const: bool):
    """The loss of one batch's rows, a mean over them (``c`` unused: the
    joint model has no covariate pathway)."""
    del c
    xf = x.float()
    D = float(xf.shape[1])
    L = torch.log1p(xf)
    xs = ((common.l2_normalize(L) - p["x_mean"])
          / (common.softplus(p["ln_x_sd"]) + 1e-2))
    h = common.linear(p["nb_mu_encoding"], xs)
    if cfg.get("do_relu"):
        h = torch.relu(h)
    mu_mean = common.linear(p["nb_mu_representation_mean"], h)
    mu_lnvar = torch.clamp(
        common.linear(p["nb_mu_representation_logvariance"], h), -4.0, 4.0)
    nu_h = torch.relu(common.linear(p["nb_nu_encoding"], xf))
    nu_mean = common.linear(p["nb_nu_representation_mean"], nu_h)
    nu_lnvar = torch.clamp(
        common.linear(p["nb_nu_representation_logvariance"], nu_h), -4.0, 4.0)
    depth = common.softplus(common.linear(p["depth"], xf))
    kappa = torch.exp(torch.clamp(common.linear(p["ln_kappa"], xf),
                                  common.fasterlog(cfg["kappa_min"]),
                                  common.fasterlog(cfg["kappa_max"])))[:, 0]
    z_nb = common.reparam(mu_mean, mu_lnvar, eps[0])
    z_nu = common.reparam(nu_mean, nu_lnvar, eps[1])
    z_vmf = common.reparam(mu_mean, mu_lnvar, eps[2])
    mu = torch.exp(torch.log_softmax(common.linear(p["nb_mu_decoding"], z_nb),
                                     dim=1) + p["mu_bias"]) * depth
    nu = torch.clamp(torch.exp(common.linear(p["nb_nu_decoding"], z_nu)
                               - p["nu_bias"]), 0.0, 1e4)
    nb = common.nb_nll(xf, mu, nu, include_const)
    recon = common.l2_normalize(common.linear(p["vmf_mu_decoding"], z_vmf))
    yobs = common.l2_normalize(torch.log1p(torch.relu(xf)) + 1e-2 / D)
    df = max(0.5 * D - 1.0, 0.0)
    llik = (torch.sum(yobs * recon, dim=1) * kappa
            + df * torch.log(kappa) - common.log_bessel(kappa, df)
            - 0.5 * D * common.fasterlog(2.0 * math.pi))
    kl = (common.gaussian_kl(mu_mean, mu_lnvar)
          + common.gaussian_kl(nu_mean, nu_lnvar))
    return (nb - torch.sum(llik) + beta * kl) / x.shape[0]
