"""ELBO terms of the NB-VAE and the vMF+NB models.

Port of ``mmvae_tpu/ops/losses.py`` (``l2_normalize`` :23,
``gaussian_kl`` :29, ``uniform_kl`` :38, ``kl_weight_schedule`` :124,
``nb_nllik`` / ``nb_loss`` :49-95).  The training steps use
``gaussian_kl``, ``kl_weight_schedule`` and (the labeled mixture)
``uniform_kl``; ``l2_normalize`` serves the vMF+NB models' plain
encoders; ``nb_nllik`` and ``nb_loss`` are the unfused reference
formulas, kept for the tests.
"""

from __future__ import annotations

import torch

from .fastmath import fasterlog
from .nb_elbo import _lgamma_pos


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Row L2 normalization matching ``F::normalize`` (p=2, eps=1e-12):
    divide by ``max(norm, 1e-12)`` (``losses.py:23-26``)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp_min(norm, 1e-12)


def gaussian_kl(mean: torch.Tensor, lnvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mean, exp(lnvar)) || N(0, I)), summed over all elements
    (reference nb.hh:533-537)."""
    return -0.5 * torch.sum(1.0 + lnvar - mean * mean - torch.exp(lnvar))


def uniform_kl(ln_q: torch.Tensor) -> torch.Tensor:
    """KL(q || uniform over K) summed over the batch, from the (n, K) log
    responsibilities (reference vmfnb_mixture.hh:698-706); ``fasterlog(K)``
    as the reference has it, not ``log(K)``."""
    k = ln_q.shape[1]
    return torch.sum(torch.exp(ln_q) * (ln_q + fasterlog(float(k))))


def kl_weight_schedule(epoch: float, kl_max: float, kl_min: float,
                       kl_discount: float) -> torch.Tensor:
    """beta(t) = max(kl_min, kl_max * exp(-kl_discount * t)) as a float32
    scalar, evaluated in float32 as the JAX package does
    (src/nb_vae_main.cc:27-32)."""
    f32 = torch.float32
    t = torch.tensor(-kl_discount, dtype=f32) * torch.tensor(epoch, dtype=f32)
    return torch.clamp_min(torch.tensor(kl_max, dtype=f32) * torch.exp(t),
                           kl_min)


def nb_nllik(x: torch.Tensor, recon_mu: torch.Tensor, recon_nu: torch.Tensor,
             recon_depth: torch.Tensor, include_data_const: bool = True
             ) -> torch.Tensor:
    """NB negative log-likelihood summed over batch and features
    (reference ``nllik_loss``, nb.hh:511-531); ``include_data_const``
    adds the parameter-free ``lgamma(x + 1)``."""
    eps = 1e-4
    x = x.float()
    nu = recon_nu + eps
    mu = recon_mu * recon_depth + eps
    lg = _lgamma_pos(nu) - _lgamma_pos(nu + x)
    if include_data_const:
        lg = lg + _lgamma_pos(x + 1.0)
    denom = torch.log(mu + nu)
    pr = x * (denom - torch.log(mu)) + nu * (denom - torch.log(nu))
    return torch.sum(lg + pr)


def nb_loss(x: torch.Tensor, recon_mu, recon_nu, recon_depth, mu_mean,
            mu_lnvar, nu_mean, nu_lnvar, kl_weight,
            include_data_const: bool = True) -> torch.Tensor:
    """(NLL + beta * (KL_mu + KL_nu)) / batch (reference nb.hh:539-548)."""
    ret = nb_nllik(x, recon_mu, recon_nu, recon_depth, include_data_const)
    ret = ret + gaussian_kl(mu_mean, mu_lnvar) * kl_weight
    ret = ret + gaussian_kl(nu_mean, nu_lnvar) * kl_weight
    return ret / x.shape[0]
