"""Packed fast steps for the joint vMF+NB model and the labeled mixture.

Port of ``mmvae_tpu/ops/vmfnb_fast.py`` (``_JRows`` :64,
``VMFNBFastStep`` :139-423, ``_MRows`` :427, ``VMFNBMixtureFastStep``
:500-779) for the direct architectures (no hidden encoder or decoder
layers, no ``--vmf_decoding``, the default nu clamp).  The joint step:

- **One count-encoder pass per loss.**  Every (B, D) view the model
  reads — the L2-normalized log1p counts of the standardized encoder,
  the vMF observation direction ``yobs = l2_normalize(L + eps)`` and the
  raw counts of the nu / depth / kappa heads — is a row scaling of
  ``L = log1p(x)`` or of ``float(x)``.  So ``count_encode(x, [Wt; vmf
  decoder rows], [nu; depth; kappa rows], want_stats=True)`` (K4 with
  its row stats, K5 backward) gives every contraction, and the row norms
  come from the stats: ``|L + eps|^2 = |L|^2 + 2 eps sum(L) + D eps^2``.
- **Gram-collapsed vMF decoder.**  With ``v = z @ W + b``, ``<yobs, v>``
  is the slim ``yobs @ [W; b]^T`` above and ``|v|^2 = z G z^T + 2 z (W b)
  + b.b`` from the (R+1, R+1) Gram of the decoder rows, so no (B, D)
  reconstruction is ever formed.
- **The NB half** runs the joint variants of the fused step kernels
  (``pb`` after the softmax, exp-nu): :func:`nb_step_report` (K1, K6)
  for the reporting pass and :func:`nb_step_boot_joint_gradonly` (K1,
  K2, K3) for each boot step.  The joint model has no covariate pathway;
  the kernels are handed ``c = 0 (B, 1)`` and ``wc = 0 (1, D)``, as in
  the JAX package.

The mixture step (:class:`VMFNBMixtureFastStep`) is the same recipe
with the mixture's collapses (vmfnb_mixture.hh:482-560, 607-654): the
masked component directions ``vmu`` live as K packed rows, so ONE
count-encoder pass with the annotation filter (K4f:
``count_encode(x, [Wt; vmu], ndk_rows, want_stats=True, filt=)``) gives
the encoder contraction, the E-step contraction ``L @ vmu^T`` and the
plain and filtered row norms; the loss needs only ``<yobs, recon> =
sum(latent * (yobs @ vmu^T))``, so no (B, D) reconstruction is formed.

``plain=True`` is the plain route of either step (``count_encode_ref``
and ``step_nll_ref`` under autograd, the JAX package's XLA path).  Draws
come in through ``rand``: three reparameterizations per loss, ``(nb, nu,
vmf)``, in the joint step, two, ``(mu, nu)``, in the mixture's, as in
JAX's ``_draw_batch``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .enc_kernel import count_encode, count_encode_ref
from .fastmath import fasterlog
from .lbessel import lbessel
from .losses import gaussian_kl, l2_normalize, uniform_kl
from .nb_fast import PackedFastStep
from .nb_step import (_softplus, nb_step_boot_joint_gradonly, nb_step_report,
                      step_nll_ref)


@dataclass(frozen=True)
class _JRows:
    """Row indices of the packed (K, D) joint parameter matrix (the JAX
    package's layout, so packed states carry over unchanged)."""

    R: int
    H: int
    Rn: int

    @property
    def mu_dec_w(self):  # (R, D)
        return slice(0, self.R)

    @property
    def mu_dec_b(self):
        return self.R

    @property
    def mu_bias(self):
        return self.R + 1

    @property
    def nu_dec_w(self):  # (Rn, D)
        return slice(self.R + 2, self.R + 2 + self.Rn)

    @property
    def nu_dec_b(self):
        return self.R + 2 + self.Rn

    @property
    def nu_bias(self):
        return self.R + 3 + self.Rn

    @property
    def x_mean(self):
        return self.R + 4 + self.Rn

    @property
    def ln_x_sd(self):
        return self.R + 5 + self.Rn

    @property
    def mu_enc_w(self):  # (R, D), transposed storage
        a = self.R + 6 + self.Rn
        return slice(a, a + self.R)

    @property
    def nu_enc_w(self):  # (H, D), transposed storage
        a = 2 * self.R + 6 + self.Rn
        return slice(a, a + self.H)

    @property
    def depth_w(self):  # (1, D), transposed storage
        return 2 * self.R + 6 + self.Rn + self.H

    @property
    def kappa_w(self):  # (1, D), transposed storage
        return 2 * self.R + 7 + self.Rn + self.H

    @property
    def ndk_rows(self):  # (H + 2, D): nu encoder, depth, ln_kappa rows
        a = 2 * self.R + 6 + self.Rn
        return slice(a, a + self.H + 2)

    @property
    def vmf_rows(self):  # (R + 1, D): vMF decoder weight rows + bias row
        a = 2 * self.R + 8 + self.Rn + self.H
        return slice(a, a + self.R + 1)

    @property
    def K(self):
        return 3 * self.R + 9 + self.Rn + self.H

    #: the row blocks the loss reads as one operand each, in layout order
    blocks = ("mu_dec_w", "mu_dec_b", "mu_bias", "nu_dec_w", "nu_dec_b",
              "nu_bias", "x_mean", "ln_x_sd", "mu_enc_w", "ndk_rows",
              "vmf_rows")


class VMFNBFastStep(PackedFastStep):
    """Packed fast step for
    :class:`~mmvae_tpu_torch.models.vmfnb.VMFNBVAE`."""

    UNSUPPORTED = ("the packed joint step needs the direct architecture "
                   "(no --mean_encoding / --mean_decoding / --vmf_decoding) "
                   "with the default nu clamp; other architectures train on "
                   "the generic step (train.loop.Trainer with the model's "
                   "losses, cli.vmfnb_vae.make_step)")

    @staticmethod
    def supports(model) -> bool:
        from ..models.vmfnb import VMFNBVAE

        return (isinstance(model, VMFNBVAE) and not model.mean_encoding
                and not model.mean_decoding and not model.vmf_decoding
                and model._can_fuse_step())

    @staticmethod
    def _make_rows(model):
        return _JRows(R=model.mean_latent, H=model.overdisp_encoding,
                      Rn=model.overdisp_latent)

    def _sv_entries(self):
        R, H, Rn = self.rows.R, self.rows.H, self.rows.Rn
        return [("nb_mu_encoding.bias", (R,)),
                ("nb_mu_representation_mean.weight", (R, R)),
                ("nb_mu_representation_mean.bias", (R,)),
                ("nb_mu_representation_logvariance.weight", (R, R)),
                ("nb_mu_representation_logvariance.bias", (R,)),
                ("nb_nu_encoding.bias", (H,)),
                ("nb_nu_representation_mean.weight", (H, Rn)),
                ("nb_nu_representation_mean.bias", (Rn,)),
                ("nb_nu_representation_logvariance.weight", (H, Rn)),
                ("nb_nu_representation_logvariance.bias", (Rn,)),
                ("depth.bias", (1,)),
                ("ln_kappa.bias", (1,))]

    def _eps_widths(self):
        # (nb, nu, vmf) reparameterizations, vmfnb.hh:519,527,533
        return (self.rows.R, self.rows.Rn, self.rows.R)

    # ------------------------------------------------------------------
    # layout
    # ------------------------------------------------------------------
    def pack(self, t: dict) -> dict:
        P = torch.cat([
            t["nb_mu_decoding"]["weight"],              # (R, D)
            t["nb_mu_decoding"]["bias"][None, :],
            t["mu_bias"],                               # (1, D)
            t["nb_nu_decoding"]["weight"],              # (Rn, D)
            t["nb_nu_decoding"]["bias"][None, :],
            t["nu_bias"],
            t["x_mean"],
            t["ln_x_sd"],
            t["nb_mu_encoding"]["weight"].T,            # (R, D)
            t["nb_nu_encoding"]["weight"].T,            # (H, D)
            t["depth"]["weight"].T,                     # (1, D)
            t["ln_kappa"]["weight"].T,                  # (1, D)
            t["vmf_mu_decoding"]["weight"],             # (R, D)
            t["vmf_mu_decoding"]["bias"][None, :],
        ], dim=0).contiguous()
        assert P.shape[0] == self.rows.K
        return {"P": P, "sv": self._pack_sv(t)}

    def unpack(self, q: dict) -> dict:
        P = q["P"]
        r = self.rows
        vrows = P[r.vmf_rows]
        out = {
            "x_mean": P[r.x_mean][None, :],
            "ln_x_sd": P[r.ln_x_sd][None, :],
            "mu_bias": P[r.mu_bias][None, :],
            "nu_bias": P[r.nu_bias][None, :],
            "nb_mu_decoding": {"weight": P[r.mu_dec_w],
                               "bias": P[r.mu_dec_b]},
            "nb_nu_decoding": {"weight": P[r.nu_dec_w],
                               "bias": P[r.nu_dec_b]},
            "vmf_mu_decoding": {"weight": vrows[:-1], "bias": vrows[-1]},
            "nb_mu_encoding": {"weight": P[r.mu_enc_w].T},
            "nb_nu_encoding": {"weight": P[r.nu_enc_w].T},
            "depth": {"weight": P[r.depth_w][:, None]},
            "ln_kappa": {"weight": P[r.kappa_w][:, None]},
        }
        return self._unpack_sv(q["sv"], out)

    # ------------------------------------------------------------------
    # compute
    # ------------------------------------------------------------------
    def _mu_hidden(self, q, h_core):
        """The shared mu encoder's hidden layer and its log-variance head
        (vmfnb.hh:449-460) from the standardized encoder contraction."""
        sv = self._sv
        h = h_core + sv(q, "nb_mu_encoding.bias")
        if self.model.do_relu:
            h = torch.relu(h)  # the encoder stack ReLUs its last layer
        mu_lnvar = torch.clamp(
            h @ sv(q, "nb_mu_representation_logvariance.weight")
            + sv(q, "nb_mu_representation_logvariance.bias"),
            -4.0, 4.0)
        return h, mu_lnvar

    def _heads(self, q, h_core, ndk):
        """The shared mu encoder and the three raw-count heads
        (vmfnb.hh:449-460, 477-486, 498, 535-538) from the standardized
        encoder contraction ``h_core`` and the raw-count contraction
        ``ndk`` of one count-encoder pass."""
        h, mu_lnvar = self._mu_hidden(q, h_core)
        mu_mean = (h @ self._sv(q, "nb_mu_representation_mean.weight")
                   + self._sv(q, "nb_mu_representation_mean.bias"))
        return (mu_mean, mu_lnvar, *self._ndk_heads(q, ndk))

    def _ndk_heads(self, q, ndk):
        """The nu encoder, depth and kappa heads from the raw-count
        contraction ``ndk`` (vmfnb.hh:477-486, 498, 535-538)."""
        sv = self._sv
        H = self.rows.H
        # the joint model ALWAYS ReLUs the nu hidden layer (vmfnb.hh:481)
        nu_h = torch.relu(ndk[:, :H] + sv(q, "nb_nu_encoding.bias"))
        nu_mean = (nu_h @ sv(q, "nb_nu_representation_mean.weight")
                   + sv(q, "nb_nu_representation_mean.bias"))
        nu_lnvar = torch.clamp(
            nu_h @ sv(q, "nb_nu_representation_logvariance.weight")
            + sv(q, "nb_nu_representation_logvariance.bias"),
            -4.0, 4.0)
        depth = _softplus(ndk[:, H:H + 1] + sv(q, "depth.bias"))
        ln_kappa = ndk[:, H + 1:H + 2] + sv(q, "ln_kappa.bias")
        kappa = torch.exp(torch.clamp(ln_kappa,
                                      fasterlog(self.model.kappa_min),
                                      fasterlog(self.model.kappa_max)))
        return nu_mean, nu_lnvar, depth, kappa

    def _nb_nll(self, q, x, z_nb, z_nu, depth, include_const: bool,
                boot: bool):
        """The NB half: the kernels' ``pb`` / exp-nu variant (or the plain
        ``step_nll_ref``).  The vMF+NB models have no covariate pathway;
        the kernels are handed ``c = 0 (B, 1)`` and ``wc = 0 (1, D)``."""
        p = self._p
        B = x.shape[0]
        cz = torch.zeros((B, 1), dtype=torch.float32, device=x.device)
        wcz = torch.zeros((1, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        args = (x, z_nb, cz, z_nu, depth, p(q, "mu_dec_w"), wcz,
                p(q, "mu_dec_b"), p(q, "nu_dec_w"),
                p(q, "nu_dec_b") - p(q, "nu_bias"))
        pb = p(q, "mu_bias")
        if self.plain:
            return step_nll_ref(*args, pb=pb, include_const=include_const,
                                nu_exp=True)
        if boot:
            return nb_step_boot_joint_gradonly(*args, pb)
        return nb_step_report(*args, include_const=include_const, pb=pb)

    @staticmethod
    def _vmf_llik(cos_k, kappa, dd: float):
        """Per-row vMF log-likelihood over ``dd`` features from the
        kappa-weighted cosine ``cos_k`` (vmfnb.hh:554-574)."""
        df = max(0.5 * dd - 1.0, 0.0)
        k = kappa[:, 0]
        llik = cos_k + (df * torch.log(k) - lbessel(k, df))
        return llik - 0.5 * dd * fasterlog(2.0 * math.pi)

    def _vmf_nll(self, q, t, z_vmf, kappa):
        """vMF negative log-likelihood without the (B, D) reconstruction:
        ``t = yobs @ [W; b]^T`` comes from the count-encoder pass and
        ``|v|`` from the (R+1, R+1) Gram of the decoder rows
        (vmfnb.hh:554-574)."""
        vrows = self._p(q, "vmf_rows")                       # (R+1, D)
        dot = torch.sum(t[:, :-1] * z_vmf, dim=1) + t[:, -1]
        gram = vrows @ vrows.T  # full float32 (TF32 is off): |v| normalises
        G, gb, bb = gram[:-1, :-1], gram[:-1, -1], gram[-1, -1]
        sq = (torch.sum((z_vmf @ G) * z_vmf, dim=1) + 2.0 * (z_vmf @ gb)
              + bb)
        # |v| >= |b_v| > 0 in practice; the clamp mirrors l2_normalize's
        # eps guard and keeps the sqrt's gradient finite at 0
        norm = torch.clamp_min(torch.sqrt(torch.clamp_min(sq, 0.0)), 1e-12)
        llik = self._vmf_llik((dot / norm) * kappa[:, 0], kappa,
                              float(self.model.data_dim))
        return -torch.sum(llik)

    def _loss(self, q, x, c, ridx, eps, beta, include_const: bool,
              boot: bool):
        del c  # the joint model has no covariate pathway
        if ridx is not None:
            # resample the INPUT rows and re-encode them: the row
            # transforms and stats commute with the gather
            x = x.index_select(0, ridx)
        p = self._p
        R = self.rows.R
        # ONE count-encoder pass: log1p(x) against [mu_enc / sd; vMF
        # decoder rows], float(x) against the nu / depth / kappa rows,
        # and the row stats of log1p(x)
        sd = _softplus(p(q, "ln_x_sd")) + 1e-2               # (D,)
        Wt = p(q, "mu_enc_w") / sd                           # (R, D)
        vrows = p(q, "vmf_rows")                             # (R+1, D)
        enc = count_encode_ref if self.plain else count_encode
        out, ndk, stats = enc(x, torch.cat([Wt, vrows]), p(q, "ndk_rows"),
                              want_stats=True)
        s, ssq = stats[:, 0], stats[:, 1]
        D = float(self.model.data_dim)
        eps_y = 1e-2 / D
        inv_nL = 1.0 / torch.clamp_min(torch.sqrt(ssq), 1e-12)
        ny = torch.sqrt(ssq + 2.0 * eps_y * s + D * eps_y * eps_y)
        inv_nY = 1.0 / torch.clamp_min(ny, 1e-12)
        h_core = out[:, :R] * inv_nL[:, None] - p(q, "x_mean") @ Wt.T
        # d<yobs, v>/dv_d = (L_d + eps) / |L + eps|: the eps * rowsum term
        t = (out[:, R:] + eps_y * torch.sum(vrows, dim=1)) * inv_nY[:, None]
        mu_mean, mu_lnvar, nu_mean, nu_lnvar, depth, kappa = self._heads(
            q, h_core, ndk)
        z_nb = self._reparam(eps[0], mu_mean, mu_lnvar)
        z_nu = self._reparam(eps[1], nu_mean, nu_lnvar)
        z_vmf = self._reparam(eps[2], mu_mean, mu_lnvar)
        kl = gaussian_kl(mu_mean, mu_lnvar) + gaussian_kl(nu_mean, nu_lnvar)
        nll = self._nb_nll(q, x, z_nb, z_nu, depth, include_const, boot)
        vmf = self._vmf_nll(q, t, z_vmf, kappa)
        return (nll + vmf + beta * kl) / x.shape[0]


@dataclass(frozen=True)
class _MRows:
    """Row indices of the packed (Krows, D) mixture parameter matrix (the
    JAX package's layout; rows up to the kappa row sit where
    :class:`_JRows` has them)."""

    R: int
    H: int
    Rn: int
    K: int  # mixture components

    @property
    def mu_dec_w(self):  # (R, D)
        return slice(0, self.R)

    @property
    def mu_dec_b(self):
        return self.R

    @property
    def mu_bias(self):
        return self.R + 1

    @property
    def nu_dec_w(self):  # (Rn, D)
        return slice(self.R + 2, self.R + 2 + self.Rn)

    @property
    def nu_dec_b(self):
        return self.R + 2 + self.Rn

    @property
    def nu_bias(self):
        return self.R + 3 + self.Rn

    @property
    def x_mean(self):
        return self.R + 4 + self.Rn

    @property
    def ln_x_sd(self):
        return self.R + 5 + self.Rn

    @property
    def mu_enc_w(self):  # (R, D), transposed storage
        a = self.R + 6 + self.Rn
        return slice(a, a + self.R)

    @property
    def ndk_rows(self):  # (H + 2, D): nu encoder, depth, ln_kappa rows
        a = 2 * self.R + 6 + self.Rn
        return slice(a, a + self.H + 2)

    @property
    def nu_enc_w(self):  # (H, D), transposed storage
        a = 2 * self.R + 6 + self.Rn
        return slice(a, a + self.H)

    @property
    def depth_w(self):
        return 2 * self.R + 6 + self.Rn + self.H

    @property
    def kappa_w(self):
        return 2 * self.R + 7 + self.Rn + self.H

    @property
    def vmf_mu_rows(self):  # (K, D): ln_vmf_mu, transposed storage
        a = 2 * self.R + 8 + self.Rn + self.H
        return slice(a, a + self.K)

    @property
    def Krows(self):
        return 2 * self.R + 8 + self.Rn + self.H + self.K

    #: the row blocks the loss reads as one operand each, in layout order
    blocks = ("mu_dec_w", "mu_dec_b", "mu_bias", "nu_dec_w", "nu_dec_b",
              "nu_bias", "x_mean", "ln_x_sd", "mu_enc_w", "ndk_rows",
              "vmf_mu_rows")


class VMFNBMixtureFastStep(VMFNBFastStep):
    """Packed fast step for
    :class:`~mmvae_tpu_torch.models.vmfnb_mixture.VMFNBMixtureVAE`: the
    joint step's NB half, nu / depth / kappa heads and vMF likelihood,
    with the mixture's E-step, responsibility-weighted mean heads and
    uniform KL."""

    UNSUPPORTED = ("the packed mixture step needs the direct architecture "
                   "(no --mean_encoding / --mean_decoding) with the default "
                   "nu clamp; other architectures train on the generic step "
                   "(train.loop.Trainer with the model's losses, "
                   "cli.vmfnb_vae.make_step)")

    @staticmethod
    def supports(model) -> bool:
        from ..models.vmfnb_mixture import VMFNBMixtureVAE

        return (isinstance(model, VMFNBMixtureVAE) and not model.mean_encoding
                and not model.mean_decoding and model._can_fuse_step())

    @staticmethod
    def _make_rows(model):
        return _MRows(R=model.mean_latent, H=model.overdisp_encoding,
                      Rn=model.overdisp_latent, K=model.n_components)

    def _sv_entries(self):
        R, H, Rn, K = self.rows.R, self.rows.H, self.rows.Rn, self.rows.K
        return [("nb_mu_encoding.bias", (R,)),
                ("nb_mu_representation_mean_k.weight", (K, R, R)),
                ("nb_mu_representation_mean_k.bias", (K, R)),
                ("nb_mu_representation_logvariance.weight", (R, R)),
                ("nb_mu_representation_logvariance.bias", (R,)),
                ("nb_nu_encoding.bias", (H,)),
                ("nb_nu_representation_mean.weight", (H, Rn)),
                ("nb_nu_representation_mean.bias", (Rn,)),
                ("nb_nu_representation_logvariance.weight", (H, Rn)),
                ("nb_nu_representation_logvariance.bias", (Rn,)),
                ("depth.bias", (1,)),
                ("ln_kappa.bias", (1,))]

    def _eps_widths(self):
        # (mu, nu): training uses the soft E-step, so the Gumbel key that
        # JAX splits off draws nothing here (vmfnb_mixture.hh:688-691)
        return (self.rows.R, self.rows.Rn)

    # ------------------------------------------------------------------
    # layout
    # ------------------------------------------------------------------
    def pack(self, t: dict) -> dict:
        P = torch.cat([
            t["nb_mu_decoding"]["weight"],              # (R, D)
            t["nb_mu_decoding"]["bias"][None, :],
            t["mu_bias"],                               # (1, D)
            t["nb_nu_decoding"]["weight"],              # (Rn, D)
            t["nb_nu_decoding"]["bias"][None, :],
            t["nu_bias"],
            t["x_mean"],
            t["ln_x_sd"],
            t["nb_mu_encoding"]["weight"].T,            # (R, D)
            t["nb_nu_encoding"]["weight"].T,            # (H, D)
            t["depth"]["weight"].T,                     # (1, D)
            t["ln_kappa"]["weight"].T,                  # (1, D)
            t["ln_vmf_mu"].T,                           # (K, D)
        ], dim=0).contiguous()
        assert P.shape[0] == self.rows.Krows
        return {"P": P, "sv": self._pack_sv(t)}

    def unpack(self, q: dict) -> dict:
        P = q["P"]
        r = self.rows
        out = {
            "x_mean": P[r.x_mean][None, :],
            "ln_x_sd": P[r.ln_x_sd][None, :],
            "mu_bias": P[r.mu_bias][None, :],
            "nu_bias": P[r.nu_bias][None, :],
            "ln_vmf_mu": P[r.vmf_mu_rows].T,
            "nb_mu_decoding": {"weight": P[r.mu_dec_w],
                               "bias": P[r.mu_dec_b]},
            "nb_nu_decoding": {"weight": P[r.nu_dec_w],
                               "bias": P[r.nu_dec_b]},
            "nb_mu_encoding": {"weight": P[r.mu_enc_w].T},
            "nb_nu_encoding": {"weight": P[r.nu_enc_w].T},
            "depth": {"weight": P[r.depth_w][:, None]},
            "ln_kappa": {"weight": P[r.kappa_w][:, None]},
        }
        return self._unpack_sv(q["sv"], out)

    # ------------------------------------------------------------------
    # compute
    # ------------------------------------------------------------------
    def _loss(self, q, x, c, ridx, eps, beta, include_const: bool,
              boot: bool):
        del c  # no covariate pathway
        if ridx is not None:
            # resample the INPUT rows and re-encode them: the row
            # transforms and stats commute with the gather
            x = x.index_select(0, ridx)
        p = self._p
        R = self.rows.R
        label, filt = self.model.masks(x.device)
        D = float(self.model.data_dim)
        dd = float(self.model.dd)
        # normalized masked component directions (vmfnb_mixture.hh:538-560):
        # zero outside each component's label, hence outside the filter
        eps_f = 1e-2 / D
        vmu = l2_normalize((torch.exp(p(q, "vmf_mu_rows")) + eps_f) * label,
                           dim=1)                           # (K, D)
        fsum = torch.sum(vmu, dim=1)
        sd = _softplus(p(q, "ln_x_sd")) + 1e-2
        Wt = p(q, "mu_enc_w") / sd
        # ONE filtered count-encoder pass (K4f): the standardized mu
        # encoder, the shared core product L @ vmu^T of both vMF dots, the
        # nu / depth / kappa rows and the plain + filtered row stats:
        #   |(L + eps) f|^2 = sum(f L^2) + 2 eps sum(f L) + eps^2 dd
        #   |L + eps'|^2    = |L|^2 + 2 eps' sum(L) + D eps'^2
        enc = count_encode_ref if self.plain else count_encode
        out, ndk, stats = enc(x, torch.cat([Wt, vmu]), p(q, "ndk_rows"),
                              want_stats=True, filt=filt)
        s, ssq, s_f, ssq_f = stats.unbind(1)
        eps_y = 1e-2 / dd
        inv_nL = 1.0 / torch.clamp_min(torch.sqrt(ssq), 1e-12)
        nv = torch.sqrt(ssq_f + 2.0 * eps_f * s_f + eps_f * eps_f * dd)
        inv_nV = 1.0 / torch.clamp_min(nv, 1e-12)
        ny = torch.sqrt(ssq + 2.0 * eps_y * s + D * eps_y * eps_y)
        inv_nY = 1.0 / torch.clamp_min(ny, 1e-12)
        nu_mean, nu_lnvar, depth, kappa = self._ndk_heads(q, ndk)
        # the E-step (vmfnb_mixture.hh:680-691)
        core = out[:, R:]                                   # (B, K)
        t_estep = (core + eps_f * fsum) * inv_nV[:, None]
        logits = torch.log_softmax(t_estep * kappa, dim=1)
        latent = torch.exp(logits)
        # the responsibility-weighted mean heads (vmfnb_mixture.hh:482-500)
        h, mu_lnvar = self._mu_hidden(
            q, out[:, :R] * inv_nL[:, None] - p(q, "x_mean") @ Wt.T)
        mu_k = (torch.einsum("nh,khr->nkr", h, self._sv(
                    q, "nb_mu_representation_mean_k.weight"))
                + self._sv(q, "nb_mu_representation_mean_k.bias")[None])
        mu_mean = torch.sum(mu_k * latent[:, :, None], dim=1)
        z_mu = self._reparam(eps[0], mu_mean, mu_lnvar)
        z_nu = self._reparam(eps[1], nu_mean, nu_lnvar)
        kl = (gaussian_kl(mu_mean, mu_lnvar) + gaussian_kl(nu_mean, nu_lnvar)
              + uniform_kl(logits))
        nll = self._nb_nll(q, x, z_mu, z_nu, depth, include_const, boot)
        # the vMF loss without the (B, D) recon: recon = (latent @ vmu) *
        # filt, and <yobs, recon> = sum(latent * (yobs @ vmu^T), 1)
        # (vmfnb_mixture.hh:610-629), a row scaling of the same core
        t = (core + eps_y * fsum) * inv_nY[:, None]
        dot = torch.sum(latent * t, dim=1)
        vmf_nll = -torch.sum(self._vmf_llik(dot * kappa[:, 0], kappa, dd))
        return (nll + vmf_nll + beta * kl) / x.shape[0]
