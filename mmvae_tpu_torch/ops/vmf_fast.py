"""Packed vMF-VAE training step: reporting pass + bootstrap Adam steps.

Port of ``mmvae_tpu/ops/vmf_fast.py`` (``_VRows``, ``VMFFastStep``) for
the direct architecture (Angular D -> Z encoder, Z -> D decoder, no
hidden layers) of :class:`~mmvae_tpu_torch.models.vmf.VMFVAE`, on the
:class:`~mmvae_tpu_torch.ops.nb_fast.PackedFastStep` skeleton:

- **Packed parameters.**  The D-sized rows (decoder, covariate decoder,
  their biases, ``x_mean``, ``ln_x_sd`` and the Angular encoder weight,
  transposed) live in one (K, D) matrix ``P``; the heads and ``ln_kappa``
  (a bare name) in the small vector ``sv``.
- **Hoisted data views.**  The encoder's unit log1p rows ``xn`` and the
  loss's observation direction ``yobs`` depend on the counts only: they
  are made once a batch (:meth:`VMFFastStep._views`), and a boot pass
  gathers their rows with ``ridx`` (row-wise transforms commute with row
  gathers).
- **Hoisted encoder algebra.**  ``((xn - x_mean) / sd) @ ww = xn @
  (ww / sd)^T - x_mean @ (ww / sd)^T``, ``ww`` the ReLU'd weight
  normalized along axis 1 of its packed (Z, D) rows.
- **No unit reconstruction.**  The loss keeps ``|v|`` and ``yobs . v`` of
  the decoder's ``v = exp(z W + b) + c Wc + bc``.

The JAX package computes this step in XLA and the port in plain PyTorch
float32 (TF32 off): no kernel of the port lies on this path.  JAX's
bfloat16 storage of ``xn`` (``_use_bf16_data`` / ``_data_mm``) emulates
the TPU's DEFAULT matmul precision and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .losses import gaussian_kl, l2_normalize, vmf_loss_parts
from .nb_elbo import _softplus
from .nb_fast import PackedFastStep


@dataclass(frozen=True)
class _VRows:
    """Row indices of the packed (K, D) vMF parameter matrix (the JAX
    package's layout, so packed states carry over unchanged)."""

    Z: int
    C: int

    @property
    def dec_w(self):  # (Z, D)
        return slice(0, self.Z)

    @property
    def cov_dec_w(self):  # (C, D)
        return slice(self.Z, self.Z + self.C)

    @property
    def dec_b(self):
        return self.Z + self.C

    @property
    def cov_dec_b(self):
        return self.Z + self.C + 1

    @property
    def x_mean(self):
        return self.Z + self.C + 2

    @property
    def ln_x_sd(self):
        return self.Z + self.C + 3

    @property
    def enc_w(self):  # (Z, D), transposed storage
        a = self.Z + self.C + 4
        return slice(a, a + self.Z)

    @property
    def K(self):
        return 2 * self.Z + self.C + 4

    #: the row blocks the loss reads as one operand each, in layout order
    blocks = ("dec_w", "cov_dec_w", "dec_b", "cov_dec_b", "x_mean",
              "ln_x_sd", "enc_w")


class VMFFastStep(PackedFastStep):
    """Packed step for :class:`~mmvae_tpu_torch.models.vmf.VMFVAE`: converts
    between the named parameter tree and ``{P: (K, D), sv: (n,)}`` and runs
    one reference batch step on the packed state."""

    UNSUPPORTED = ("the packed step takes only the direct (no hidden "
                   "layer) vMF architecture; hidden layers train on the "
                   "generic step, train.loop.Trainer")

    @staticmethod
    def supports(model) -> bool:
        from ..models.vmf import VMFVAE

        return (isinstance(model, VMFVAE) and not model.encoding
                and not model.decoding)

    @staticmethod
    def _make_rows(model):
        return _VRows(Z=model.latent, C=model.covar_dim)

    def _sv_entries(self):
        Z, C = self.rows.Z, self.rows.C
        return [("covar_encoding.weight", (C, Z)),
                ("covar_encoding.bias", (Z,)),
                ("representation_mean.weight", (Z, Z)),
                ("representation_mean.bias", (Z,)),
                ("representation_logvariance.weight", (Z, Z)),
                ("representation_logvariance.bias", (Z,)),
                ("ln_kappa", (1,))]

    def _eps_widths(self):
        return (self.rows.Z,)

    def pack(self, t: dict) -> dict:
        P = torch.cat([
            t["decoding"]["weight"],
            t["covar_decoding_"]["weight"],
            t["decoding"]["bias"][None, :],
            t["covar_decoding_"]["bias"][None, :],
            t["x_mean"],
            t["ln_x_sd"],
            t["encoding"]["weight"].T,
        ], dim=0).contiguous()
        assert P.shape[0] == self.rows.K
        return {"P": P, "sv": self._pack_sv(t)}

    def unpack(self, q: dict) -> dict:
        P = q["P"]
        r = self.rows
        out = {
            "x_mean": P[r.x_mean][None, :],
            "ln_x_sd": P[r.ln_x_sd][None, :],
            "decoding": {"weight": P[r.dec_w], "bias": P[r.dec_b]},
            "covar_decoding_": {"weight": P[r.cov_dec_w],
                                "bias": P[r.cov_dec_b]},
            "encoding": {"weight": P[r.enc_w].T},
        }
        return self._unpack_sv(q["sv"], out)

    # ------------------------------------------------------------------
    # compute
    # ------------------------------------------------------------------
    def _views(self, x):
        """(xn, yobs): the encoder's unit log1p rows (vmf.hh:253-258,
        before the learned standardization) and the loss's observation
        direction (vmf.hh:424-428), once a batch."""
        xf = x.float()
        xn = l2_normalize(torch.log1p(xf), dim=1)
        # counts are non-negative, so relu(x) == x: the reference's order
        yobs = l2_normalize(torch.log1p(torch.relu(xf))
                            + 1e-2 / float(self.model.data_dim), dim=1)
        return xn, yobs

    def _heads(self, q, xn, c):
        """Encoder heads (vmf.hh:250-281) through the hoisted-``xn``
        factorization; the covariate term always enters the mean, as in
        the generic step's forward."""
        p, sv = self._p, self._sv
        sd = _softplus(p(q, "ln_x_sd")) + 1e-2 / float(self.model.data_dim)
        # rows are encoding.weight^T: each output unit's weight vector
        # lies along the row
        ww = l2_normalize(torch.relu(p(q, "enc_w")) + 1e-4, dim=1)
        Wt = ww / sd                                       # (Z, D)
        h = xn @ Wt.T - p(q, "x_mean") @ Wt.T              # (B, Z)
        if self.model.do_relu:
            h = torch.relu(h)  # the encoder stack ReLUs its last layer
        mean = (h @ sv(q, "representation_mean.weight")
                + sv(q, "representation_mean.bias")
                + c @ sv(q, "covar_encoding.weight")
                + sv(q, "covar_encoding.bias"))
        lnvar = torch.clamp(
            h @ sv(q, "representation_logvariance.weight")
            + sv(q, "representation_logvariance.bias"), -4.0, 4.0)
        return mean, lnvar

    def _loss(self, q, views, c, ridx, eps, beta, include_const: bool,
              boot: bool):
        del boot  # one formula for the report and the boot passes
        xn, yobs = views
        if ridx is not None:
            xn = xn.index_select(0, ridx)
            yobs = yobs.index_select(0, ridx)
            c = c.index_select(0, ridx)
        mean, lnvar = self._heads(q, xn, c)
        z = self._reparam(eps[0], mean, lnvar)
        p = self._p
        # normalize(exp(z W + b) + c Wc + bc) against yobs (vmf.hh:283-290,
        # 419-440) without the unit reconstruction: |v| and yobs . v
        v = (torch.exp(z @ p(q, "dec_w") + p(q, "dec_b"))
             + c @ p(q, "cov_dec_w") + p(q, "cov_dec_b"))
        nrm = torch.clamp_min(torch.sqrt(torch.sum(v * v, dim=1)), 1e-12)
        dot = torch.sum(yobs * v, dim=1)
        kappa = self.model.kappa(self._sv(q, "ln_kappa"))
        return vmf_loss_parts(dot / nrm, kappa, gaussian_kl(mean, lnvar),
                              beta, float(self.model.data_dim),
                              include_const)

