"""log modified Bessel function of the first kind, with the reference's
custom gradient.

Port of ``mmvae_tpu/ops/lbessel.py`` (reference include/operators.hh:
13-101) as a ``torch.autograd.Function``:

- forward: the Oh-Adamczewski-Park (2019) two-regime approximation
  (operators.hh:58-80), with ``lgamma(df + 1)`` from the bit-exact
  ``fasterlgamma`` scalar (:mod:`.fastmath`);
- backward: the midpoint of the Baricz (2011) ratio bounds, NOT the
  analytic derivative (operators.hh:28-39) — the reference's training
  trajectories depend on it.
"""

from __future__ import annotations

import math

import torch

from .fastmath import fasterlgamma


def lbessel_value(kappa: torch.Tensor, df: float) -> torch.Tensor:
    """The forward value of :func:`lbessel` (no gradient rule)."""
    nu = float(df)
    eta = (nu + 0.5) / (2.0 * (nu + 1.0))
    # regime kappa <= nu (operators.hh:59-63)
    stuff1 = (nu * torch.log(kappa) + eta * kappa
              - (eta + nu) * math.log(2.0) - fasterlgamma(nu + 1.0))
    # regime kappa > nu (operators.hh:64-67)
    stuff2 = kappa - 0.5 * torch.log(kappa) - 0.5 * math.log(2.0 * math.pi)
    return torch.where(kappa <= nu, stuff1, stuff2)


class _LBessel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kappa, df):
        ctx.save_for_backward(kappa)
        ctx.df = float(df)
        return lbessel_value(kappa, df)

    @staticmethod
    def backward(ctx, g):
        (kappa,) = ctx.saved_tensors
        nu = ctx.df
        lb = torch.sqrt(kappa * kappa * nu / (nu + 1.0) + nu * nu)
        ub = torch.sqrt(kappa * kappa + nu * nu)
        return g * 0.5 * (lb + ub) / kappa, None


def lbessel(kappa: torch.Tensor, df: float) -> torch.Tensor:
    """log I_df(kappa), elementwise over ``kappa``; ``df`` is a Python
    float.  Its gradient is the Baricz midpoint."""
    return _LBessel.apply(kappa, df)
