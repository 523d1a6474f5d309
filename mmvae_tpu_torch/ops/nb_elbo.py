"""Negative-binomial constants and positive-domain lgamma / digamma.

Port of the pieces of ``mmvae_tpu/ops/nb_elbo.py`` that the fused step
needs (``EPS``, ``NU_LO``, ``NU_HI`` and the shift-into-Stirling
``_lgamma_pos`` / ``_digamma_pos``, nb_elbo.py:36-38, 75-114).  The
arguments are always positive and bounded (nu in [2e-4, 1e4], nu plus
counts), so shifting below 8 and a three-term Stirling series are
accurate to ~1e-7 relative.  The CUDA step kernels
(``mmvae_tpu_torch/csrc/nb_step_common.cuh``) evaluate the same series.
The v1 ELBO kernels of that module (K7/K8) are not ported yet.
"""

from __future__ import annotations

import torch

EPS = 1e-4
NU_LO = 1e-4
NU_HI = 1e4

_HALF_LOG_2PI = 0.9189385332046727


def _stirling_lgamma(w: torch.Tensor) -> torch.Tensor:
    iw = 1.0 / w
    iw2 = iw * iw
    corr = iw * (1.0 / 12.0 - iw2 * (1.0 / 360.0 - iw2 * (1.0 / 1260.0)))
    return (w - 0.5) * torch.log(w) - w + _HALF_LOG_2PI + corr


def _lgamma_pos(z: torch.Tensor) -> torch.Tensor:
    """lgamma for z > 0: Stirling at z + 8 minus the log of the shift
    product below 8, Stirling directly above."""
    shifted = _stirling_lgamma(z + 8.0) - torch.log(
        z * (z + 1.0) * (z + 2.0) * (z + 3.0)
        * (z + 4.0) * (z + 5.0) * (z + 6.0) * (z + 7.0))
    direct = _stirling_lgamma(torch.clamp_min(z, 1.0))
    return torch.where(z < 8.0, shifted, direct)


def _stirling_digamma(w: torch.Tensor) -> torch.Tensor:
    iw = 1.0 / w
    iw2 = iw * iw
    return (torch.log(w) - 0.5 * iw
            - iw2 * (1.0 / 12.0 - iw2 * (1.0 / 120.0 - iw2 * (1.0 / 252.0))))


def _digamma_pos(z: torch.Tensor) -> torch.Tensor:
    """digamma for z > 0 by the same shift-by-8 scheme."""
    recips = (1.0 / z + 1.0 / (z + 1.0) + 1.0 / (z + 2.0) + 1.0 / (z + 3.0)
              + 1.0 / (z + 4.0) + 1.0 / (z + 5.0) + 1.0 / (z + 6.0)
              + 1.0 / (z + 7.0))
    shifted = _stirling_digamma(z + 8.0) - recips
    direct = _stirling_digamma(torch.clamp_min(z, 1.0))
    return torch.where(z < 8.0, shifted, direct)
