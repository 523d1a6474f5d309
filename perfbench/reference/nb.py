"""Plain reference of the NB-VAE (YPARK/mm-vae ``include/models/nb.hh``)
at its direct architecture: no hidden encoder or decoder layers.

Encoder: the counts standardized by learned parameters,
``((log1p(x) - x_mean) / (softplus(ln_x_sd) + 1e-4)) @ W + b``
(nb.hh:403-431), its mean head plus the covariate's, its log-variance
head clamped to [-4, 4]; the overdispersion encoder on the raw counts
(nb.hh:444-451); the depth head ``softplus(x @ w + b)`` (nb.hh:498).
Decoder: the composition ``softmax(z @ W + b + c @ Wc + bc + mu_bias)``
(nb.hh:433-442) times the depth, the overdispersion
``clamp(softplus(z_nu @ W + b - nu_bias), 1e-4, 1e4)`` (nb.hh:453-460).
Loss: (NB NLL + beta (KL_mu + KL_nu)) / rows (nb.hh:539-548).
"""

from __future__ import annotations

import torch

from . import common

#: the encoder's first-layer weight, contracted against the counts
ENCODER_LEAF = "mu_encoding.weight"


def eps_widths(cfg: dict) -> tuple:
    """The widths of the two reparameterizations a loss draws: (mu,
    nu)."""
    return (cfg["mean_latent"], cfg["overdisp_latent"])


def init_params(cfg: dict, gen: torch.Generator, device) -> dict:
    """Parameters at the published initialization (LibTorch's
    ``nn.Linear`` default; the standardization at mean 0, ``ln_x_sd``
    1), weights stored (in, out), from one draw of ``gen``."""
    D, C, R = cfg["data_dim"], cfg["covar_dim"], cfg["mean_latent"]
    H, Rn = cfg["overdisp_encoding"], cfg["overdisp_latent"]
    layers = [("mu_encoding", D, R), ("covar_encoding", C, R),
              ("mu_representation_mean", R, R),
              ("mu_representation_logvariance", R, R),
              ("mu_decoding", R, D), ("covar_decoding", C, D),
              ("nu_encoding", D, H), ("nu_representation_mean", H, Rn),
              ("nu_representation_logvariance", H, Rn),
              ("nu_decoding", Rn, D), ("depth", D, 1)]
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
    """The loss of one batch's rows, a mean over them."""
    xf = x.float()
    sd = common.softplus(p["ln_x_sd"]) + 1e-4
    h = common.linear(p["mu_encoding"], (torch.log1p(xf) - p["x_mean"]) / sd)
    if cfg.get("do_relu"):
        h = torch.relu(h)
    mu_mean = (common.linear(p["mu_representation_mean"], h)
               + common.linear(p["covar_encoding"], c))
    mu_lnvar = torch.clamp(
        common.linear(p["mu_representation_logvariance"], h), -4.0, 4.0)
    nu_h = common.linear(p["nu_encoding"], xf)
    nu_mean = common.linear(p["nu_representation_mean"], nu_h)
    nu_lnvar = torch.clamp(
        common.linear(p["nu_representation_logvariance"], nu_h), -4.0, 4.0)
    depth = common.softplus(common.linear(p["depth"], xf))
    z_mu = common.reparam(mu_mean, mu_lnvar, eps[0])
    z_nu = common.reparam(nu_mean, nu_lnvar, eps[1])
    logits = (common.linear(p["mu_decoding"], z_mu)
              + common.linear(p["covar_decoding"], c) + p["mu_bias"])
    mu = torch.softmax(logits, dim=1) * depth
    nu = torch.clamp(common.softplus(
        common.linear(p["nu_decoding"], z_nu) - p["nu_bias"]), 1e-4, 1e4)
    kl = (common.gaussian_kl(mu_mean, mu_lnvar)
          + common.gaussian_kl(nu_mean, nu_lnvar))
    return (common.nb_nll(xf, mu, nu, include_const) + beta * kl) / x.shape[0]
