"""Joint vMF + NB VAE: two likelihoods on the same data, one shared
encoder.

Port of ``mmvae_tpu/models/vmfnb.py`` (reference include/models/
vmfnb.hh:241-758): the parameter tree (``init``), the plain shared
encoder (``shared_encode_mu``, with ``normalize_nb_x``), the decoders
and heads, ``forward``, the generic step's losses (``fused_step_report``
/ ``fused_step_boot`` and the module-level composite loss), and a
folded encoder for serving.  The tree converters of
:mod:`mmvae_tpu_torch.models.nb` (``params_from_numpy``,
``adam_from_numpy`` and their inverses) work on this tree unchanged.

The reference's quirks the port keeps (they differ from the NB model):
the encoder input is ``log1p(x)`` L2-normalized per row, then
standardized with ``eps = 1e-2`` (vmfnb.hh:601-611); ``mu_bias`` sits
outside the log-softmax; nu decodes as ``clamp(exp(.), 0, 1e4)``; the nu
encoder's hidden layer is ReLU'd; the two decoders draw independent
noise from the shared posterior.

The encoder folds the standardization and the row norm into the first
layer, as ``mmvae_tpu/ops/vmfnb_fast.py:384-396`` does::

    ((L / |L| - x_mean) / sd) @ W = (L @ Wt^T) / |L| - x_mean @ Wt^T,
    Wt = (W / sd^T)^T,  sd = softplus(ln_x_sd) + 1e-2

with ``|L|`` from the row stats of the same count-encoder call (K4 with
``want_stats``), so nothing (B, D) is materialised for it.  In training
(:meth:`VMFNBVAE.forward` and the fused losses) that one call also
contracts the raw counts against the ``nb_nu_encoding``, ``depth`` and
``ln_kappa`` rows, and its backward is K5.  Noise is passed in: ``eps =
(eps_nb, eps_nu, eps_vmf)`` where JAX takes a key (split three ways in
that order).  ``plain=True`` takes the JAX package's unfolded
specification and plain step NLL on any device.

Tensor parallelism (vmfnb.py:310-529): the ``tp_*`` methods take ``x``'s
and every D-sized parameter axis's shard of this rank (``tp_pspecs``)
and the model row's process group as ``model_axis``.  The encoder is
plain PyTorch, as in JAX: the first layers of the shared encoder, the nu
encoder and the depth and kappa heads are partial products summed over
the row (one collective), the row norm of ``log1p(x)`` a summed square
sum; the NB half runs K1, K2p (K2pv) and K3 or K6p at D / N columns with
their merges; the vMF decoder's last layer is split by columns with a
summed row norm (:func:`tp_vmf_nllik_parts`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.enc_kernel import count_encode
from ..ops.fastmath import fasterlog
from ..ops.initializers import linear_apply, torch_linear_init
from ..ops.lbessel import lbessel
from ..ops.losses import gaussian_kl, l2_normalize, nb_nllik
from ..ops.nb_elbo import NU_HI, _softplus
from ..parallel.collectives import psum_grad, psum_id_grad, tp_l2_normalize
from ..parallel.mesh import feature_sharded_pspecs
from ..ops.nb_step import (nb_step_boot_joint, nb_step_boot_joint_gradonly,
                           nb_step_report, step_nll_ref)
from .modules import apply_stack, init_linear_stack, reparameterize


class VMFNBVAEOutput(NamedTuple):
    """Forward output (reference vmfnb_vae_out_t, vmfnb.hh:241-255)."""

    nb_recon_mu: torch.Tensor
    nb_recon_nu: torch.Tensor
    nb_recon_depth: torch.Tensor
    nb_mu_mean: torch.Tensor
    nb_mu_lnvar: torch.Tensor
    nb_nu_mean: torch.Tensor
    nb_nu_lnvar: torch.Tensor
    vmf_recon: torch.Tensor
    vmf_kappa: torch.Tensor


class VMFNBVAE(nn.Module):
    """Static configuration (reference ctor: vmfnb.hh:335-447); the
    parameters are passed to each call, as in the JAX package."""

    def __init__(self, data_dim: int, mean_encoding: tuple[int, ...] = (),
                 mean_decoding: tuple[int, ...] = (),
                 vmf_decoding: tuple[int, ...] = (), mean_latent: int = 2,
                 overdisp_encoding: int = 1, overdisp_latent: int = 1,
                 kappa_min: float = 0.1, kappa_max: float = 10.0,
                 do_relu: bool = False, nu_max: float = 1e4):
        super().__init__()
        self.data_dim = data_dim
        self.mean_encoding = tuple(mean_encoding)
        self.mean_decoding = tuple(mean_decoding)
        self.vmf_decoding = tuple(vmf_decoding)
        self.mean_latent = mean_latent
        self.overdisp_encoding = overdisp_encoding
        self.overdisp_latent = overdisp_latent
        self.kappa_min = kappa_min
        self.kappa_max = kappa_max
        self.do_relu = do_relu
        self.nu_max = nu_max

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator,
             device: torch.device | str = "cpu") -> dict:
        """LibTorch-initialized parameters, in the JAX package's names,
        order and shapes (``mmvae_tpu.models.vmfnb.VMFNBVAE.init``)."""
        D, R = self.data_dim, self.mean_latent

        def lin(d_in, d_out):
            return torch_linear_init(generator, d_in, d_out, device=device)

        params: dict = {
            "x_mean": torch.zeros((1, D), device=device),
            "ln_x_sd": torch.ones((1, D), device=device),
            "mu_bias": torch.zeros((1, D), device=device),
            "nu_bias": torch.zeros((1, D), device=device),
        }
        hidden = list(self.mean_encoding)
        enc, _, d_prev = init_linear_stack(
            generator, "nb_mu_encoding", D, hidden, None if hidden else R,
            device=device)
        params.update(enc)
        params["nb_mu_representation_mean"] = lin(d_prev, R)
        params["nb_mu_representation_logvariance"] = lin(d_prev, R)
        dec, _, _ = init_linear_stack(
            generator, "nb_mu_decoding", R, list(self.mean_decoding), D,
            device=device)
        params.update(dec)
        H, Rn = self.overdisp_encoding, self.overdisp_latent
        params["nb_nu_encoding"] = lin(D, H)
        params["nb_nu_representation_mean"] = lin(H, Rn)
        params["nb_nu_representation_logvariance"] = lin(H, Rn)
        params["nb_nu_decoding"] = lin(Rn, D)
        params["depth"] = lin(D, 1)
        params["ln_kappa"] = lin(D, 1)
        vdec, _, _ = init_linear_stack(
            generator, "vmf_mu_decoding", R, list(self.vmf_decoding), D,
            device=device)
        params.update(vdec)
        return params

    def _enc_names(self) -> list[str]:
        hidden = list(self.mean_encoding)
        if hidden:
            return [f"nb_mu_encoding_{i + 1}" for i in range(len(hidden))]
        return ["nb_mu_encoding"]

    def _dec_names(self) -> list[str]:
        return [f"nb_mu_decoding_{i + 1}"
                for i in range(len(self.mean_decoding))] + ["nb_mu_decoding"]

    def _vdec_names(self) -> list[str]:
        return [f"vmf_mu_decoding_{i + 1}"
                for i in range(len(self.vmf_decoding))] + ["vmf_mu_decoding"]

    def _can_fuse_step(self) -> bool:
        """The fused step kernels bake NU_HI as the nu clamp and need a
        direct mu decoder (JAX ``VMFNBVAE._can_fuse_step``)."""
        return not self.mean_decoding and self.nu_max == NU_HI

    # ------------------------------------------------------------------
    # the plain specification
    # ------------------------------------------------------------------
    def normalize_nb_x(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Reference vmfnb.hh:601-611 (eps = 1e-2, not scaled by D)."""
        xn = l2_normalize(torch.log1p(x.float()), dim=1)
        return (xn - params["x_mean"]) / (F.softplus(params["ln_x_sd"])
                                          + 1e-2)

    def shared_encode_mu(self, params: dict, x: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, lnvar) of the shared posterior, unfolded (reference
        vmfnb.hh:449-460)."""
        h = apply_stack(params, self._enc_names(),
                        self.normalize_nb_x(params, x), self.do_relu,
                        relu_last=True)
        return self._mu_heads(params, h)

    def _mu_heads(self, params: dict, h: torch.Tensor):
        lnvar = torch.clamp(
            linear_apply(params["nb_mu_representation_logvariance"], h),
            -4.0, 4.0)
        return linear_apply(params["nb_mu_representation_mean"], h), lnvar

    def nb_decode_mu(self, params: dict, z: torch.Tensor) -> torch.Tensor:
        """``mu_bias`` OUTSIDE the log-softmax (vmfnb.hh:462-467)."""
        h = apply_stack(params, self._dec_names(), z, self.do_relu,
                        relu_last=False)
        return torch.exp(torch.log_softmax(h, dim=1) + params["mu_bias"])

    def vmf_decode_mu(self, params: dict, z: torch.Tensor) -> torch.Tensor:
        """Unit-norm vMF mean direction (vmfnb.hh:469-475)."""
        h = apply_stack(params, self._vdec_names(), z, self.do_relu,
                        relu_last=False)
        return l2_normalize(h, dim=1)

    def nb_encode_nu(self, params: dict, x: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, lnvar) of q(z_nu | x), unfolded: the hidden layer IS
        ReLU'd (vmfnb.hh:477-486)."""
        return self._nu_heads(params, torch.relu(
            linear_apply(params["nb_nu_encoding"], x.float())))

    def _nu_heads(self, params: dict, h: torch.Tensor):
        lnvar = torch.clamp(
            linear_apply(params["nb_nu_representation_logvariance"], h),
            -4.0, 4.0)
        return linear_apply(params["nb_nu_representation_mean"], h), lnvar

    def nb_decode_nu(self, params: dict, z: torch.Tensor) -> torch.Tensor:
        """exp (not softplus), lower clamp 0 (vmfnb.hh:488-493)."""
        ret = torch.exp(linear_apply(params["nb_nu_decoding"], z)
                        - params["nu_bias"])
        return torch.clamp(ret, 0.0, self.nu_max)

    def _kappa(self, ln_kappa: torch.Tensor) -> torch.Tensor:
        return torch.exp(torch.clamp(ln_kappa, fasterlog(self.kappa_min),
                                     fasterlog(self.kappa_max)))

    def kappa_head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Per-sample kappa, clamped with fasterlog bounds
        (vmfnb.hh:535-538)."""
        return self._kappa(linear_apply(params["ln_kappa"], x.float()))

    # ------------------------------------------------------------------
    # training: forward and the generic step's losses
    # ------------------------------------------------------------------
    def _encode(self, params: dict, x: torch.Tensor, plain: bool = False):
        """(mu_mean, mu_lnvar, nu_mean, nu_lnvar, depth, kappa): the shared
        encoder, the nu encoder and the depth and kappa heads.  The kernel
        route is ONE count-encoder call (K4 with row stats, backward K5):
        ``log1p(x)`` against the folded first layer ``Wt`` and ``x``
        against the ``nb_nu_encoding``, ``depth`` and ``ln_kappa`` rows;
        ``plain`` is the JAX package's unfolded specification."""
        if plain:
            xf = x.float()
            return (*self.shared_encode_mu(params, x),
                    *self.nb_encode_nu(params, x),
                    _softplus(linear_apply(params["depth"], xf)),
                    self.kappa_head(params, x))
        first = params[self._enc_names()[0]]
        sd = _softplus(params["ln_x_sd"]) + 1e-2                  # (1, D)
        Wt = (first["weight"] / sd.T).T.contiguous()              # (H1, D)
        ndk = torch.cat([params["nb_nu_encoding"]["weight"],
                         params["depth"]["weight"],
                         params["ln_kappa"]["weight"]], dim=1).T.contiguous()
        hL, hX, stats = count_encode(x, Wt, ndk, want_stats=True)
        inv_nL = 1.0 / torch.clamp_min(torch.sqrt(stats[:, 1:2]), 1e-12)
        h = hL * inv_nL - params["x_mean"] @ Wt.T + first["bias"]
        if self.do_relu:
            h = torch.relu(h)
        h = apply_stack(params, self._enc_names()[1:], h, self.do_relu,
                        relu_last=True)
        H = self.overdisp_encoding
        nu_h = torch.relu(hX[:, :H] + params["nb_nu_encoding"]["bias"])
        depth = _softplus(hX[:, H:H + 1] + params["depth"]["bias"])
        kappa = self._kappa(hX[:, H + 1:H + 2] + params["ln_kappa"]["bias"])
        return (*self._mu_heads(params, h), *self._nu_heads(params, nu_h),
                depth, kappa)

    def forward(self, params: dict, x: torch.Tensor, eps,
                training: bool = True, plain: bool = False
                ) -> VMFNBVAEOutput:
        """Full forward pass (reference vmfnb.hh:506-549); ``eps =
        (eps_nb, eps_nu, eps_vmf)``, unused in eval mode."""
        mu_mean, mu_lnvar, nu_mean, nu_lnvar, depth, kappa = self._encode(
            params, x, plain)
        e_nb, e_nu, e_vmf = eps if training else (None, None, None)
        nb_mu = self.nb_decode_mu(params,
                                  reparameterize(mu_mean, mu_lnvar, e_nb))
        nb_nu = self.nb_decode_nu(params,
                                  reparameterize(nu_mean, nu_lnvar, e_nu))
        vmf_recon = self.vmf_decode_mu(
            params, reparameterize(mu_mean, mu_lnvar, e_vmf))
        return VMFNBVAEOutput(nb_mu, nb_nu, depth, mu_mean, mu_lnvar,
                              nu_mean, nu_lnvar, vmf_recon, kappa)

    def _step_prelude(self, params: dict, x, eps, plain: bool = False):
        """Latents, the stacked decoder rows of the step kernels and the
        vMF half (vmfnb.py:227-257); the encoder math is
        :meth:`forward`'s."""
        mu_mean, mu_lnvar, nu_mean, nu_lnvar, depth, kappa = self._encode(
            params, x, plain)
        dec, nud = params["nb_mu_decoding"], params["nb_nu_decoding"]
        return dict(
            z_nb=reparameterize(mu_mean, mu_lnvar, eps[0]),
            z_nu=reparameterize(nu_mean, nu_lnvar, eps[1]),
            depth=depth, wd=dec["weight"], bias2=dec["bias"],
            wn=nud["weight"], bias_n=nud["bias"] - params["nu_bias"][0],
            pb=params["mu_bias"][0],
            vmf_recon=self.vmf_decode_mu(
                params, reparameterize(mu_mean, mu_lnvar, eps[2])),
            kappa=kappa,
            kl=gaussian_kl(mu_mean, mu_lnvar) + gaussian_kl(nu_mean,
                                                            nu_lnvar))

    @staticmethod
    def _zero_covar(x):
        """The joint model has no covariate pathway; the step kernels take
        a zero (B, 1) covariate and a zero (1, D) covariate row."""
        return (torch.zeros((x.shape[0], 1), device=x.device),
                torch.zeros((1, x.shape[1]), device=x.device))

    def _step_args(self, pre: dict, x) -> tuple:
        cz, wcz = self._zero_covar(x)
        return (x, pre["z_nb"], cz, pre["z_nu"], pre["depth"], pre["wd"],
                wcz, pre["bias2"], pre["wn"], pre["bias_n"])

    def fused_step_report(self, params: dict, x, c, eps, beta,
                          include_data_const: bool = True,
                          plain: bool = False):
        """Reporting loss with the NB half through the step kernels' joint
        variant (K1, K6; vmfnb.py:267-284); without a fusable decoder,
        :meth:`forward` and the composite loss, as in JAX.  ``c`` is
        unused (no covariate pathway)."""
        del c
        if not self._can_fuse_step():
            return vmfnb_composite_loss(
                x, self.forward(params, x, eps, True, plain), beta)
        pre = self._step_prelude(params, x, eps, plain)
        args = self._step_args(pre, x)
        if plain:
            nll = step_nll_ref(*args, pb=pre["pb"],
                               include_const=include_data_const, nu_exp=True)
        else:
            nll = nb_step_report(*args, include_const=include_data_const,
                                 pb=pre["pb"])
        vmf = vmf_nllik_parts(x, pre["vmf_recon"], pre["kappa"])
        return (nll + vmf + beta * pre["kl"]) / x.shape[0]

    def fused_step_boot(self, params: dict, x, c, eps, beta,
                        need_value: bool = True, plain: bool = False):
        """Boot-step loss with the NB half through the step kernels' joint
        variant (vmfnb.py:286-308): ``need_value`` runs K2pv
        (:func:`nb_step_boot_joint`) and returns the loss, otherwise the
        grad-only K2p whose NB NLL reads 0.0 (same gradient); without a
        fusable decoder, :meth:`forward` and the composite loss."""
        del c
        if not self._can_fuse_step():
            return vmfnb_composite_loss(
                x, self.forward(params, x, eps, True, plain), beta)
        pre = self._step_prelude(params, x, eps, plain)
        args = (*self._step_args(pre, x), pre["pb"])
        if plain:
            nll = step_nll_ref(*args[:10], pb=pre["pb"], include_const=False,
                               nu_exp=True)
        else:
            nll = (nb_step_boot_joint if need_value
                   else nb_step_boot_joint_gradonly)(*args)
        vmf = vmf_nllik_parts(x, pre["vmf_recon"], pre["kappa"])
        return (nll + vmf + beta * pre["kl"]) / x.shape[0]

    # ------------------------------------------------------------------
    # serving: the folded encoder
    # ------------------------------------------------------------------
    def prepare_encoder(self, params: dict) -> dict:
        """Parameter-only part of the folded first layer: ``Wt`` (H1, D)
        contiguous, the ``x_mean`` term and the bias."""
        first = params[self._enc_names()[0]]
        sd = F.softplus(params["ln_x_sd"]) + 1e-2            # (1, D)
        Wt = (first["weight"] / sd.T).T.contiguous()          # (H1, D)
        return {"Wt": Wt, "xm": (params["x_mean"] @ Wt.T)[0],
                "bias": first["bias"]}

    def encode_prepared(self, params: dict, prep: dict, x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`shared_encode_mu` with :meth:`prepare_encoder` done:
        one count-encoder call gives ``L @ Wt^T`` and the row stats."""
        hL, _, stats = count_encode(x, prep["Wt"], want_stats=True)
        inv_nL = 1.0 / torch.clamp_min(torch.sqrt(stats[:, 1:2]), 1e-12)
        h = hL * inv_nL - prep["xm"] + prep["bias"]
        if self.do_relu:
            h = torch.relu(h)
        h = apply_stack(params, self._enc_names()[1:], h, self.do_relu,
                        relu_last=True)
        return self._mu_heads(params, h)

    def encode_mu(self, params: dict, x: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, lnvar) of q(z | x), the recorder's and the serving
        CLI's encode (reference vmfnb.hh:449-460)."""
        return self.encode_prepared(params, self.prepare_encoder(params), x)

    def record_encoder(self, seed: int, B: int, rows: slice | None = None):
        """The recorder's encode ``(params, x) -> (mean, lnvar)`` and its
        extra artifact's name (none); seed, B and rows do not enter it."""
        del seed, B, rows
        return self.encode_mu, None

    # ------------------------------------------------------------------
    # tensor parallel: x and the D-sized parameter axes are shards
    # ------------------------------------------------------------------
    def tp_pspecs(self, params: dict) -> dict:
        """The split axis of each leaf (vmfnb.py:320-333)."""
        return feature_sharded_pspecs(
            params, row={self._enc_names()[0], "nb_nu_encoding", "depth",
                         "ln_kappa"},
            col={"nb_mu_decoding", "nb_nu_decoding", self._vdec_names()[-1]},
            flat={"x_mean", "ln_x_sd", "mu_bias", "nu_bias"})

    def tp_normalize_nb_x(self, params: dict, x, model_axis):
        """:meth:`normalize_nb_x` with the row norm summed over the row
        (vmfnb.py:340-350)."""
        xn = tp_l2_normalize(torch.log1p(x.float()), model_axis, dim=1)
        return (xn - params["x_mean"]) / (F.softplus(params["ln_x_sd"])
                                          + 1e-2)

    def _tp_mu_tail(self, params: dict, h):
        if self.do_relu:
            h = torch.relu(h)
        h = apply_stack(params, self._enc_names()[1:], h, self.do_relu,
                        relu_last=True)
        return self._mu_heads(params, h)

    def tp_shared_encode_mu(self, params: dict, x, model_axis):
        """:meth:`shared_encode_mu` on the shard (vmfnb.py:352-366)."""
        first = params[self._enc_names()[0]]
        h = psum_id_grad(self.tp_normalize_nb_x(params, x, model_axis)
                         @ first["weight"], model_axis) + first["bias"]
        return self._tp_mu_tail(params, h)

    def tp_vmf_decode_mu(self, params: dict, z, model_axis):
        """The vMF decoder with its last layer split by columns and the row
        norm summed over the row (vmfnb.py:377-396)."""
        names = self._vdec_names()
        h = apply_stack(params, names[:-1], z, self.do_relu, relu_last=True)
        h = linear_apply(params[names[-1]], psum_grad(h, model_axis))
        return tp_l2_normalize(h, model_axis, dim=1)

    def _tp_step_prelude(self, params: dict, x, eps, model_axis):
        """:meth:`_step_prelude` on the shard (vmfnb.py:407-441): the first
        layers of the shared encoder, the nu encoder, the depth and the
        kappa heads summed in one collective."""
        xf = x.float()
        first = params[self._enc_names()[0]]
        hm, hn, hd, hk = psum_id_grad(
            [self.tp_normalize_nb_x(params, x, model_axis) @ first["weight"],
             xf @ params["nb_nu_encoding"]["weight"],
             xf @ params["depth"]["weight"],
             xf @ params["ln_kappa"]["weight"]], model_axis)
        mu_mean, mu_lnvar = self._tp_mu_tail(params, hm + first["bias"])
        nu_mean, nu_lnvar = self._nu_heads(
            params, torch.relu(hn + params["nb_nu_encoding"]["bias"]))
        dec, nud = params["nb_mu_decoding"], params["nb_nu_decoding"]
        return dict(
            z_nb=reparameterize(mu_mean, mu_lnvar, eps[0]),
            z_nu=reparameterize(nu_mean, nu_lnvar, eps[1]),
            depth=_softplus(hd + params["depth"]["bias"]),
            wd=dec["weight"], bias2=dec["bias"], wn=nud["weight"],
            bias_n=nud["bias"] - params["nu_bias"][0],
            pb=params["mu_bias"][0],
            vmf_recon=self.tp_vmf_decode_mu(
                params, reparameterize(mu_mean, mu_lnvar, eps[2]),
                model_axis),
            kappa=self._kappa(hk + params["ln_kappa"]["bias"]),
            kl=gaussian_kl(mu_mean, mu_lnvar) + gaussian_kl(nu_mean,
                                                            nu_lnvar))

    def _need_fused(self):
        if not self._can_fuse_step():
            raise ValueError("TP fused step needs a direct decoder")

    def fused_step_report_tp(self, params: dict, x, c, eps, beta,
                             model_axis, include_data_const: bool = True):
        """Reporting loss on the shard (vmfnb.py:443-462): K1 and K6p at
        D / N with their merges, the vMF half summed over the row."""
        del c
        self._need_fused()
        pre = self._tp_step_prelude(params, x, eps, model_axis)
        nll = nb_step_report(*self._step_args(pre, x),
                             include_const=include_data_const, pb=pre["pb"],
                             model_axis=model_axis)
        vmf = tp_vmf_nllik_parts(x, pre["vmf_recon"], pre["kappa"],
                                 float(self.data_dim), model_axis)
        return (nll + vmf + beta * pre["kl"]) / x.shape[0]

    def fused_step_boot_tp(self, params: dict, x, c, eps, beta, model_axis,
                           need_value: bool = True):
        """Boot-step loss on the shard (vmfnb.py:464-484): K1, K2p (K2pv
        with ``need_value``) and K3 at D / N with their merges."""
        del c
        self._need_fused()
        pre = self._tp_step_prelude(params, x, eps, model_axis)
        nll = (nb_step_boot_joint if need_value
               else nb_step_boot_joint_gradonly)(
            *self._step_args(pre, x), pre["pb"], model_axis=model_axis)
        vmf = tp_vmf_nllik_parts(x, pre["vmf_recon"], pre["kappa"],
                                 float(self.data_dim), model_axis)
        return (nll + vmf + beta * pre["kl"]) / x.shape[0]

    def tp_record_encoder(self, seed: int, B: int, rows, model_axis):
        """The recorder's encode on the shard (``tp_shared_encode_mu``,
        cli/vmfnb_vae.py:183-187) and its extra name (none)."""
        del seed, B, rows
        return (lambda p, x: self.tp_shared_encode_mu(p, x, model_axis),
                None)


# ----------------------------------------------------------------------
# losses (reference vmfnb.hh:551-599, 727-758)
# ----------------------------------------------------------------------

def vmf_nllik_parts(x: torch.Tensor, vmf_recon: torch.Tensor,
                    vmf_kappa: torch.Tensor, dd: float | None = None
                    ) -> torch.Tensor:
    """Per-sample vMF negative log-likelihood from raw pieces, summed
    (vmfnb.hh:554-574); ``dd`` overrides the effective dimensionality
    (the mixture restricts it to annotated features)."""
    if dd is None:
        dd = float(x.shape[1])
    eps = 1e-2 / dd
    yobs = l2_normalize(torch.log1p(torch.relu(x.float())) + eps, dim=1)
    df = max(0.5 * dd - 1.0, 0.0)
    kappa = vmf_kappa[:, 0]
    llik = torch.sum(yobs * vmf_recon, dim=1) * kappa
    llik = llik + (df * torch.log(kappa) - lbessel(kappa, df))
    llik = llik - 0.5 * dd * fasterlog(2.0 * math.pi)
    return -torch.sum(llik)


def tp_vmf_nllik_parts(x: torch.Tensor, vmf_recon: torch.Tensor,
                       vmf_kappa: torch.Tensor, dd: float, model_axis
                       ) -> torch.Tensor:
    """:func:`vmf_nllik_parts` with D split over ``model_axis``
    (vmfnb.py:510-529): ``dd`` is the whole effective dimensionality, the
    ``yobs`` row norm and the ``<yobs, recon>`` contraction are summed
    over the row, and the per-sample kappa terms (replicated) are added
    once."""
    eps = 1e-2 / dd
    yobs = tp_l2_normalize(torch.log1p(torch.relu(x.float())) + eps,
                           model_axis, dim=1)
    df = max(0.5 * dd - 1.0, 0.0)
    kappa = vmf_kappa[:, 0]
    llik = psum_id_grad(torch.sum(yobs * vmf_recon, dim=1), model_axis) \
        * kappa
    llik = llik + (df * torch.log(kappa) - lbessel(kappa, df))
    llik = llik - 0.5 * dd * fasterlog(2.0 * math.pi)
    return -torch.sum(llik)


def vmfnb_vmf_nllik(x: torch.Tensor, out: VMFNBVAEOutput) -> torch.Tensor:
    return vmf_nllik_parts(x, out.vmf_recon, out.vmf_kappa)


def vmfnb_nb_nllik(x: torch.Tensor, out: VMFNBVAEOutput) -> torch.Tensor:
    """NB negative log-likelihood (vmfnb.hh:576-599)."""
    return nb_nllik(x, out.nb_recon_mu, out.nb_recon_nu, out.nb_recon_depth)


def vmfnb_composite_loss(x: torch.Tensor, out: VMFNBVAEOutput, rate
                         ) -> torch.Tensor:
    """(NB NLL + vMF NLL + rate * (KL_mu + KL_nu)) / n (reference
    composite_loss_t, vmfnb.hh:727-758)."""
    kl = (gaussian_kl(out.nb_mu_mean, out.nb_mu_lnvar)
          + gaussian_kl(out.nb_nu_mean, out.nb_nu_lnvar))
    return (vmfnb_nb_nllik(x, out) + vmfnb_vmf_nllik(x, out)
            + rate * kl) / x.shape[0]
