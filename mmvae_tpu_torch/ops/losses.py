"""ELBO terms of the NB-VAE, the vMF-VAE and the vMF+NB models.

Port of ``mmvae_tpu/ops/losses.py`` (``l2_normalize`` :23,
``gaussian_kl`` :29, ``uniform_kl`` :38, ``kl_weight_schedule`` :124,
``nb_nllik`` / ``nb_loss`` :49-95, ``vmf_loss`` :98-122).  The training
steps use ``gaussian_kl``, ``kl_weight_schedule`` and (the labeled
mixture) ``uniform_kl``; ``l2_normalize`` serves the vMF models' plain
encoders; ``vmf_loss`` is the vMF-VAE's generic-step loss; ``nb_nllik``
and ``nb_loss`` are the unfused reference formulas, kept for the tests.
"""

from __future__ import annotations

import math

import torch

from .fastmath import fasterlog
from .lbessel import lbessel
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



def vmf_loss_parts(cos: torch.Tensor, kappa: torch.Tensor, kl, kl_weight,
                   dd: float, include_const: bool = True) -> torch.Tensor:
    """``kl / n * beta - sum(llik) / n`` with ``llik = kappa * cos + df log
    kappa - lbessel(kappa, df) - D / 2 fasterlog(2 pi)`` from the rows'
    cosines ``yobs . recon`` (vmf.hh:419-440), ``df = max(D / 2 - 1, 0)``;
    ``include_const=False`` drops the data constant (no gradient: the
    packed step's boot passes skip it)."""
    df = max(0.5 * dd - 1.0, 0.0)
    llik = cos * kappa
    llik = llik + (df * torch.log(kappa) - lbessel(kappa, df))
    if include_const:
        # the reference's fasterlog constant (vmf.hh:437), bit-exact
        llik = llik - 0.5 * dd * fasterlog(2.0 * math.pi)
    n = cos.shape[0]
    return kl / n * kl_weight - torch.sum(llik) / n


def vmf_loss(x: torch.Tensor, out, kl_weight) -> torch.Tensor:
    """Total vMF-VAE loss (reference vmf_vae_loss, vmf.hh:419-440):
    :func:`vmf_loss_parts` of ``yobs . recon``, ``yobs`` the unit row of
    ``log1p(relu(x)) + 1e-2 / D``.  ``out`` is a
    :class:`~mmvae_tpu_torch.models.vmf.VMFVAEOutput` (unit ``recon``
    rows, the posterior, the clamped scalar ``kappa``)."""
    dd = float(x.shape[1])
    yobs = l2_normalize(torch.log1p(torch.relu(x.float())) + 1e-2 / dd,
                        dim=1)
    return vmf_loss_parts(torch.sum(yobs * out.recon, dim=1), out.kappa,
                          gaussian_kl(out.mean, out.lnvar), kl_weight, dd)
