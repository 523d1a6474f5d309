"""Labeled-mixture vMF + NB VAE.

Port of ``mmvae_tpu/models/vmfnb_mixture.py`` (reference
include/models/vmfnb_mixture.hh:268-848): the parameter tree (``init``),
``_filter`` / ``dd`` / ``masks``, ``_can_fuse_step``, the plain unfolded
specification (``normalize_nb_x``, ``normalize_vmf_x``, ``vmf_forward``,
``nb_encode_mu``), the NB decoders, ``forward`` and the generic step's
losses (``fused_step_report`` / ``fused_step_boot`` and the module-level
``mixture_composite_loss``), and a folded encoder for recording and
serving.

The vMF half is a K-component mixture: the (D, K) parameter
``ln_vmf_mu`` masked by the fixed (D, K) 0/1 annotation ``label``; the
responsibilities come from the E-step ``log_softmax(<xn, mu> * kappa)``
(soft in training, a hard Gumbel-softmax draw at eval); the NB mean
encoder mixes K stacked heads ``nb_mu_representation_mean_k`` (weight
(K, H, R), bias (K, R)) by those responsibilities.

The hard draw's noise: JAX draws ``uniform(key, (B, K), 1e-20, 1)`` from
one fixed key for every batch, so every batch sees the same (B, K)
matrix.  The port takes that matrix as ``gumbel_u`` (the tests hand it
JAX's uniforms); :meth:`VMFNBMixtureVAE.gumbel_uniforms` draws one from
a ``torch.Generator`` seeded with the run's seed, and a call over a
multiple of B rows tiles it (a resident chunk of 16 batches sees it 16
times, as 16 separate batches would).

The folded encoder (:meth:`prepare_encoder` / :meth:`encode_prepared`)
is ONE filtered count-encoder call (K4f): ``log1p(x)`` against ``[Wt;
vmu]``, ``x`` against the ``ln_kappa`` row, and the plain and filtered
row stats, with the identities of the packed step
(``mmvae_tpu/ops/vmfnb_fast.py:685-713``)::

    |(L + eps) f|^2      = sum(f L^2) + 2 eps sum(f L) + eps^2 dd
    (L + eps) f . vmu    = L . vmu + eps sum(vmu)      (vmu f = vmu)

for a 0/1 filter f (which ``Annotation.matrix`` gives).  In training
(:meth:`VMFNBMixtureVAE.forward` and the fused losses) the same K4f call
also contracts the raw counts against the ``nb_nu_encoding`` and
``depth`` rows, and its backward is K5.  Noise is passed in: ``eps =
(eps_mu, eps_nu)`` where JAX takes a key (its Gumbel third draws nothing
in training, whose E-step is soft); eval mode takes the (B, K) Gumbel
uniforms.  ``plain=True`` takes the JAX package's unfolded specification
and plain step NLL on any device.

Tensor parallelism (vmfnb_mixture.py:356-549): the ``tp_*`` methods take
``x``'s and every D-sized parameter axis's shard of this rank
(``tp_pspecs``; ``ln_vmf_mu`` splits by rows) and the model row's
process group as ``model_axis``; the annotation's D-indexed constants
(label and filter) are cut to the rank's block by its model index
(``_tp_local_rows``).  The E-step's contraction, the components' column
norms and the rows' norms are summed over the row; the NB half runs the
joint model's kernels at D / N columns.  The encoder is plain PyTorch,
as in JAX (K4f and K5 do not run).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.enc_kernel import count_encode
from ..ops.initializers import linear_apply, torch_linear_init
from ..ops.losses import gaussian_kl, l2_normalize, nb_nllik, uniform_kl
from ..ops.nb_elbo import NU_HI, _softplus
import torch.distributed as dist

from ..parallel.collectives import psum_grad, psum_id_grad, tp_l2_normalize
from ..parallel.mesh import feature_sharded_pspecs
from ..ops.nb_step import (nb_step_boot_joint, nb_step_boot_joint_gradonly,
                           nb_step_report, step_nll_ref)
from .modules import apply_stack, init_linear_stack, reparameterize
from .vmfnb import VMFNBVAE, tp_vmf_nllik_parts, vmf_nllik_parts


class VMFNBMixtureOutput(NamedTuple):
    """Forward output (reference vmfnb_vae_out_t of the mixture header,
    vmfnb_mixture.hh:594-605)."""

    nb_recon_mu: torch.Tensor
    nb_recon_nu: torch.Tensor
    nb_recon_depth: torch.Tensor
    nb_mu_mean: torch.Tensor
    nb_mu_lnvar: torch.Tensor
    nb_nu_mean: torch.Tensor
    nb_nu_lnvar: torch.Tensor
    vmf_recon: torch.Tensor
    vmf_logits: torch.Tensor
    vmf_kappa: torch.Tensor
    vmf_latent: torch.Tensor  # responsibilities, or the hard assignment


class VMFOut(NamedTuple):
    """Reference vmf_out_t (``vmf_forward``'s result)."""

    mu: torch.Tensor      # (D, K) unit columns
    logits: torch.Tensor  # (n, K) log responsibilities
    latent: torch.Tensor  # (n, K) responsibilities (soft) or one-hot (eval)
    recon: torch.Tensor   # (n, D)
    kappa: torch.Tensor   # (n, 1)


def hard_assignment(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Hard Gumbel-softmax with the straight-through form
    (vmfnb_mixture.hh:692-695): ``(hard - y_soft) + y_soft`` in that
    order, whose float32 value is not always exactly one-hot."""
    g = -torch.log(-torch.log(u))
    y_soft = torch.softmax(logits + g, dim=1)
    hard = F.one_hot(torch.argmax(y_soft, dim=1),
                     logits.shape[1]).to(y_soft.dtype)
    return (hard - y_soft).detach() + y_soft


def _tile_rows(u: torch.Tensor, M: int) -> torch.Tensor:
    """The (B, K) noise for M rows: M must be a multiple of B."""
    B = u.shape[0]
    if M % B:
        raise ValueError(f"Gumbel noise of {B} rows cannot serve {M} rows")
    return u if M == B else u.repeat(M // B, 1)


class VMFNBMixtureVAE(nn.Module):
    """Static configuration (reference ctor: vmfnb_mixture.hh:355-467);
    ``label`` is the fixed (D, K) membership matrix from
    :class:`mmvae_tpu_torch.data.annotation.Annotation`.  The parameters
    are passed to each call, as in the JAX package."""

    def __init__(self, label: np.ndarray, mean_encoding: tuple[int, ...] = (),
                 mean_decoding: tuple[int, ...] = (), mean_latent: int = 2,
                 overdisp_encoding: int = 1, overdisp_latent: int = 1,
                 kappa_min: float = 0.1, kappa_max: float = 100.0,
                 do_relu: bool = False, nu_max: float = 1e4):
        super().__init__()
        self.label = np.asarray(label, dtype=np.float32)
        self.mean_encoding = tuple(mean_encoding)
        self.mean_decoding = tuple(mean_decoding)
        self.mean_latent = mean_latent
        self.overdisp_encoding = overdisp_encoding
        self.overdisp_latent = overdisp_latent
        self.kappa_min = kappa_min
        self.kappa_max = kappa_max
        self.do_relu = do_relu
        self.nu_max = nu_max
        self._masks: dict = {}

    @property
    def data_dim(self) -> int:
        return int(self.label.shape[0])

    @property
    def n_components(self) -> int:
        return int(self.label.shape[1])

    def _filter(self) -> np.ndarray:
        """(1, D) mask of features covered by any component
        (vmfnb_mixture.hh:460-464)."""
        return (self.label.sum(axis=1, keepdims=True).T > 0).astype(
            np.float32)

    @property
    def dd(self) -> float:
        """Effective dimensionality of the vMF loss (vmfnb_mixture.hh:464)."""
        return float(self._filter().sum())

    def masks(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """``(label^T (K, D), filter (D,))`` as float32 tensors on
        ``device``, made once per device."""
        key = str(torch.device(device))
        if key not in self._masks:
            self._masks[key] = (
                torch.tensor(self.label.T.copy(), device=device),
                torch.tensor(self._filter()[0], device=device))
        return self._masks[key]

    def permute_features(self, order: np.ndarray) -> None:
        """Reorder the annotation's genes (``label`` rows) and drop the
        cached masks: the training loop's feature-clustering hook, called
        with its gene order and, on the way out, with the inverse (JAX
        ``cli/vmfnb_vae.py:235-250``)."""
        self.label = self.label[np.asarray(order)]
        self._masks.clear()

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator,
             device: torch.device | str = "cpu") -> dict:
        """LibTorch-initialized parameters, in the JAX package's names,
        order and shapes (``VMFNBMixtureVAE.init``)."""
        D, K, R = self.data_dim, self.n_components, self.mean_latent

        def lin(d_in, d_out):
            return torch_linear_init(generator, d_in, d_out, device=device)

        params: dict = {
            "x_mean": torch.zeros((1, D), device=device),
            "ln_x_sd": torch.ones((1, D), device=device),
            "mu_bias": torch.zeros((1, D), device=device),
            "nu_bias": torch.zeros((1, D), device=device),
            "ln_vmf_mu": torch.zeros((D, K), device=device),
        }
        hidden = list(self.mean_encoding)
        enc, _, d_prev = init_linear_stack(
            generator, "nb_mu_encoding", D, hidden, None if hidden else R,
            device=device)
        params.update(enc)
        heads = [lin(d_prev, R) for _ in range(K)]
        params["nb_mu_representation_mean_k"] = {
            "weight": torch.stack([h["weight"] for h in heads]),  # (K, H, R)
            "bias": torch.stack([h["bias"] for h in heads]),      # (K, R)
        }
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
        return params

    def _enc_names(self) -> list[str]:
        hidden = list(self.mean_encoding)
        if hidden:
            return [f"nb_mu_encoding_{i + 1}" for i in range(len(hidden))]
        return ["nb_mu_encoding"]

    def _can_fuse_step(self) -> bool:
        """The fused step kernels bake NU_HI as the nu clamp and need a
        direct mu decoder (JAX ``VMFNBMixtureVAE._can_fuse_step``)."""
        return not self.mean_decoding and self.nu_max == NU_HI

    # ------------------------------------------------------------------
    # the plain specification (vmfnb_mixture.hh:538-560, 656-696)
    # ------------------------------------------------------------------
    def normalize_nb_x(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        xn = l2_normalize(torch.log1p(x.float()), dim=1)
        return (xn - params["x_mean"]) / (F.softplus(params["ln_x_sd"])
                                          + 1e-2)

    def normalize_vmf_x(self, x: torch.Tensor) -> torch.Tensor:
        eps = 1e-2 / float(x.shape[1])
        filt = self.masks(x.device)[1]
        return l2_normalize((torch.log1p(x.float()) + eps) * filt, dim=1)

    def vmf_forward(self, params: dict, x: torch.Tensor, training: bool,
                    gumbel_u: torch.Tensor | None = None) -> VMFOut:
        """The vMF mixture: E-step responsibilities (soft in training,
        the hard Gumbel draw with the (B, K) uniforms ``gumbel_u`` at
        eval) and the masked reconstruction."""
        vmf_mu = self._vmf_mu(params, x.shape[1])
        kappa = self._kappa(linear_apply(params["ln_kappa"], x.float()))
        return self._estep(self.normalize_vmf_x(x) @ vmf_mu, kappa, vmf_mu,
                           training, gumbel_u)

    def _vmf_mu(self, params: dict, D: int) -> torch.Tensor:
        """(D, K) columns of ``(exp(ln_mu) + eps) * label``, L2-normalized
        over features (vmfnb_mixture.hh:538-560)."""
        label = self.masks(params["ln_vmf_mu"].device)[0]
        eps = 1e-2 / float(D)
        return l2_normalize((torch.exp(params["ln_vmf_mu"]) + eps) * label.T,
                            dim=0)

    def _estep(self, dots, kappa, vmf_mu, training: bool,
               gumbel_u: torch.Tensor | None) -> VMFOut:
        """The E-step from the (n, K) cosines ``<xn, mu_k>``
        (vmfnb_mixture.hh:680-696) and the masked reconstruction."""
        logits = torch.log_softmax(dots * kappa, dim=1)
        if training:
            latent = torch.exp(logits)
        else:
            if gumbel_u is None:
                raise ValueError("vmf_forward(training=False) needs the "
                                 "Gumbel uniforms gumbel_u")
            latent = hard_assignment(
                logits, _tile_rows(gumbel_u.to(dots.device), dots.shape[0]))
        filt = self.masks(dots.device)[1]
        recon = (latent @ vmf_mu.T) * filt
        return VMFOut(vmf_mu, logits, latent, recon, kappa)

    def _heads(self, params: dict, h: torch.Tensor, z: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """The K mean heads mixed by the responsibilities z, and the
        shared log-variance head (vmfnb_mixture.hh:482-500)."""
        lnvar = torch.clamp(
            linear_apply(params["nb_mu_representation_logvariance"], h),
            -4.0, 4.0)
        heads = params["nb_mu_representation_mean_k"]
        mu_k = (torch.einsum("nh,khr->nkr", h, heads["weight"])
                + heads["bias"][None])
        return torch.sum(mu_k * z[:, :, None], dim=1), lnvar

    def nb_encode_mu(self, params: dict, x: torch.Tensor, z: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, lnvar) of the NB posterior, unfolded."""
        h = apply_stack(params, self._enc_names(),
                        self.normalize_nb_x(params, x), self.do_relu,
                        relu_last=True)
        return self._heads(params, h, z)

    # the NB decoders and the nu encoder are the joint model's formulas
    # (vmfnb_mixture.hh:502-507 and the nu pathway of vmfnb.hh:477-493)
    _dec_names = VMFNBVAE._dec_names
    nb_decode_mu = VMFNBVAE.nb_decode_mu
    nb_encode_nu = VMFNBVAE.nb_encode_nu
    _nu_heads = VMFNBVAE._nu_heads
    nb_decode_nu = VMFNBVAE.nb_decode_nu
    _kappa = VMFNBVAE._kappa

    # ------------------------------------------------------------------
    # training: forward and the generic step's losses
    # ------------------------------------------------------------------
    def _encode(self, params: dict, x: torch.Tensor, training: bool,
                gumbel_u=None, plain: bool = False):
        """(vmf, mu_mean, mu_lnvar, nu_mean, nu_lnvar, depth): the vMF
        E-step, the responsibility-weighted mean heads, the nu encoder
        and the depth head.  The kernel route is ONE filtered
        count-encoder call (K4f, backward K5): ``log1p(x)`` against the
        folded first layer and the masked directions ``[Wt; vmu]``, ``x``
        against the ``nb_nu_encoding``, ``depth`` and ``ln_kappa`` rows;
        ``plain`` is the JAX package's unfolded specification."""
        if plain:
            vmf = self.vmf_forward(params, x, training, gumbel_u)
            return (vmf, *self.nb_encode_mu(params, x, vmf.latent),
                    *self.nb_encode_nu(params, x),
                    _softplus(linear_apply(params["depth"], x.float())))
        first = params[self._enc_names()[0]]
        D = self.data_dim
        filt = self.masks(x.device)[1]
        sd = _softplus(params["ln_x_sd"]) + 1e-2                  # (1, D)
        Wt = (first["weight"] / sd.T).T                           # (H1, D)
        vmf_mu = self._vmf_mu(params, D)                          # (D, K)
        ndk = torch.cat([params["nb_nu_encoding"]["weight"],
                         params["depth"]["weight"],
                         params["ln_kappa"]["weight"]], dim=1).T.contiguous()
        hL, hX, st = count_encode(x, torch.cat([Wt, vmf_mu.T]).contiguous(),
                                  ndk, want_stats=True, filt=filt)
        H1 = Wt.shape[0]
        _, ssq, s_f, ssq_f = st.unbind(1)
        eps = 1e-2 / float(D)
        # (L + eps) f . vmu = L . vmu + eps sum(vmu), |(L + eps) f|^2 from
        # the filtered stats (the module docstring's identities)
        nv = torch.sqrt(ssq_f + 2.0 * eps * s_f + eps * eps * self.dd)
        dots = ((hL[:, H1:] + eps * vmf_mu.sum(0))
                / torch.clamp_min(nv, 1e-12)[:, None])
        H = self.overdisp_encoding
        kappa = self._kappa(hX[:, H + 1:H + 2] + params["ln_kappa"]["bias"])
        vmf = self._estep(dots, kappa, vmf_mu, training, gumbel_u)
        inv_nL = 1.0 / torch.clamp_min(torch.sqrt(ssq), 1e-12)
        h = hL[:, :H1] * inv_nL[:, None] - params["x_mean"] @ Wt.T \
            + first["bias"]
        if self.do_relu:
            h = torch.relu(h)
        h = apply_stack(params, self._enc_names()[1:], h, self.do_relu,
                        relu_last=True)
        nu_h = torch.relu(hX[:, :H] + params["nb_nu_encoding"]["bias"])
        depth = _softplus(hX[:, H:H + 1] + params["depth"]["bias"])
        return (vmf, *self._heads(params, h, vmf.latent),
                *self._nu_heads(params, nu_h), depth)

    def forward(self, params: dict, x: torch.Tensor, eps,
                training: bool = True, gumbel_u=None, plain: bool = False
                ) -> VMFNBMixtureOutput:
        """Full forward pass (reference vmfnb_mixture.hh:562-605); ``eps =
        (eps_mu, eps_nu)`` in training; eval mode takes the hard
        assignment's (B, K) uniforms ``gumbel_u`` and no noise."""
        vmf, mu_mean, mu_lnvar, nu_mean, nu_lnvar, depth = self._encode(
            params, x, training, gumbel_u, plain)
        e_mu, e_nu = eps if training else (None, None)
        nb_mu = self.nb_decode_mu(params,
                                  reparameterize(mu_mean, mu_lnvar, e_mu))
        nb_nu = self.nb_decode_nu(params,
                                  reparameterize(nu_mean, nu_lnvar, e_nu))
        return VMFNBMixtureOutput(nb_mu, nb_nu, depth, mu_mean, mu_lnvar,
                                  nu_mean, nu_lnvar, vmf.recon, vmf.logits,
                                  vmf.kappa, vmf.latent)

    def _step_prelude(self, params: dict, x, eps, plain: bool = False):
        """Latents, the stacked decoder rows of the step kernels and the
        vMF half (vmfnb_mixture.py:315-339); the encoder math is
        :meth:`forward`'s in training mode."""
        vmf, mu_mean, mu_lnvar, nu_mean, nu_lnvar, depth = self._encode(
            params, x, True, plain=plain)
        dec, nud = params["nb_mu_decoding"], params["nb_nu_decoding"]
        return dict(
            z_mu=reparameterize(mu_mean, mu_lnvar, eps[0]),
            z_nu=reparameterize(nu_mean, nu_lnvar, eps[1]),
            depth=depth, wd=dec["weight"], bias2=dec["bias"],
            wn=nud["weight"], bias_n=nud["bias"] - params["nu_bias"][0],
            pb=params["mu_bias"][0], vmf=vmf,
            kl=(gaussian_kl(mu_mean, mu_lnvar)
                + gaussian_kl(nu_mean, nu_lnvar) + uniform_kl(vmf.logits)))

    def _step_args(self, pre: dict, x) -> tuple:
        B, D = x.shape
        cz = torch.zeros((B, 1), device=x.device)
        wcz = torch.zeros((1, D), device=x.device)
        return (x, pre["z_mu"], cz, pre["z_nu"], pre["depth"], pre["wd"],
                wcz, pre["bias2"], pre["wn"], pre["bias_n"])

    def fused_step_report(self, params: dict, x, c, eps, beta,
                          include_data_const: bool = True,
                          plain: bool = False):
        """Reporting loss with the NB half through the step kernels' joint
        variant (K1, K6; vmfnb_mixture.py:308-327); without a fusable
        decoder, :meth:`forward` and the composite loss, as in JAX.
        ``c`` is unused (no covariate pathway)."""
        del c
        if not self._can_fuse_step():
            return mixture_composite_loss(
                x, self.forward(params, x, eps, True, plain=plain), beta,
                self.dd)
        pre = self._step_prelude(params, x, eps, plain)
        args = self._step_args(pre, x)
        if plain:
            nll = step_nll_ref(*args, pb=pre["pb"],
                               include_const=include_data_const, nu_exp=True)
        else:
            nll = nb_step_report(*args, include_const=include_data_const,
                                 pb=pre["pb"])
        vmf_nll = _mixture_vmf_nllik_parts(x, pre["vmf"].recon,
                                           pre["vmf"].kappa, self.dd)
        return (nll + vmf_nll + beta * pre["kl"]) / x.shape[0]

    def fused_step_boot(self, params: dict, x, c, eps, beta,
                        need_value: bool = True, plain: bool = False):
        """Boot-step loss with the NB half through the step kernels' joint
        variant (vmfnb_mixture.py:329-350): ``need_value`` runs K2pv and
        returns the loss, otherwise the grad-only K2p whose NB NLL reads
        0.0 (same gradient); without a fusable decoder, :meth:`forward`
        and the composite loss."""
        del c
        if not self._can_fuse_step():
            return mixture_composite_loss(
                x, self.forward(params, x, eps, True, plain=plain), beta,
                self.dd)
        pre = self._step_prelude(params, x, eps, plain)
        args = self._step_args(pre, x)
        if plain:
            nll = step_nll_ref(*args, pb=pre["pb"], include_const=False,
                               nu_exp=True)
        else:
            nll = (nb_step_boot_joint if need_value
                   else nb_step_boot_joint_gradonly)(*args, pre["pb"])
        vmf_nll = _mixture_vmf_nllik_parts(x, pre["vmf"].recon,
                                           pre["vmf"].kappa, self.dd)
        return (nll + vmf_nll + beta * pre["kl"]) / x.shape[0]

    # ------------------------------------------------------------------
    # recording and serving: the folded encoder
    # ------------------------------------------------------------------
    def gumbel_uniforms(self, B: int, seed: int) -> torch.Tensor:
        """The (B, K) uniforms in [1e-20, 1) of the eval-mode hard draw,
        from a CPU ``torch.Generator`` seeded with ``seed`` (the same on
        every device)."""
        g = torch.Generator().manual_seed(int(seed))
        return torch.rand((B, self.n_components), generator=g).clamp_min_(
            1e-20)

    def prepare_encoder(self, params: dict, gumbel_u: torch.Tensor) -> dict:
        """Parameter-only part of the folded encoder: the stacked K4f rows
        ``[Wt; vmu]`` (H1 + K, D), the ``ln_kappa`` row, the ``x_mean``
        term, ``sum(vmu)`` per component, and the noise on the device."""
        first = params[self._enc_names()[0]]
        dev = first["weight"].device
        label, filt = self.masks(dev)
        sd = F.softplus(params["ln_x_sd"]) + 1e-2            # (1, D)
        Wt = (first["weight"] / sd.T).T                       # (H1, D)
        eps = 1e-2 / float(self.data_dim)
        vmu = l2_normalize((torch.exp(params["ln_vmf_mu"].T) + eps) * label,
                           dim=1)                             # (K, D)
        return {"WL": torch.cat([Wt, vmu]).contiguous(),
                "WX": params["ln_kappa"]["weight"].T.contiguous(),
                "xm": (params["x_mean"] @ Wt.T)[0], "bias": first["bias"],
                "fsum": vmu.sum(1), "filt": filt,
                "kbias": params["ln_kappa"]["bias"],
                "u": gumbel_u.to(dev), "h1": Wt.shape[0]}

    def encode_prepared(self, params: dict, prep: dict, x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mean, lnvar, hard assignment) of every row of x (a multiple
        of the noise's B rows) from one K4f call."""
        hL, hX, st = count_encode(x, prep["WL"], prep["WX"],
                                  want_stats=True, filt=prep["filt"])
        H1 = prep["h1"]
        _, ssq, s_f, ssq_f = st.unbind(1)
        eps = 1e-2 / float(self.data_dim)
        inv_nL = 1.0 / torch.clamp_min(torch.sqrt(ssq), 1e-12)
        h = hL[:, :H1] * inv_nL[:, None] - prep["xm"] + prep["bias"]
        if self.do_relu:
            h = torch.relu(h)
        h = apply_stack(params, self._enc_names()[1:], h, self.do_relu,
                        relu_last=True)
        nv = torch.sqrt(ssq_f + 2.0 * eps * s_f + eps * eps * self.dd)
        t = ((hL[:, H1:] + eps * prep["fsum"])
             / torch.clamp_min(nv, 1e-12)[:, None])
        kappa = self._kappa(hX + prep["kbias"])
        logits = torch.log_softmax(t * kappa, dim=1)
        latent = hard_assignment(logits, _tile_rows(prep["u"], x.shape[0]))
        mean, lnvar = self._heads(params, h, latent)
        return mean, lnvar, latent

    def encode_mu(self, params: dict, x: torch.Tensor,
                  gumbel_u: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mean, lnvar, hard assignment) with the model frozen, as the
        reference records (vmfnb_mixture.hh:741-795)."""
        return self.encode_prepared(
            params, self.prepare_encoder(params, gumbel_u), x)

    def record_encoder(self, seed: int, B: int, rows: slice | None = None):
        """The recorder's encode ``(params, x) -> (mean, lnvar, clust)``
        with the uniforms of ``seed`` for B-row batches, and the name of
        its extra artifact.  ``rows`` keeps the uniforms of those rows of
        a batch (a data-parallel rank's, which encodes only its rows)."""
        u = self.gumbel_uniforms(B, seed)
        if rows is not None:
            u = u[rows]
        on_device: dict = {}

        def encode(params, x):
            key = str(x.device)
            if key not in on_device:  # one host->device copy per device
                on_device[key] = u.to(x.device)
            return self.encode_mu(params, x, on_device[key])

        return encode, "clust"

    # ------------------------------------------------------------------
    # tensor parallel: x and the D-sized parameter axes are shards
    # ------------------------------------------------------------------
    def tp_pspecs(self, params: dict) -> dict:
        """The split axis of each leaf (vmfnb_mixture.py:364-380);
        ``ln_vmf_mu`` is a (D, K) row shard."""
        return feature_sharded_pspecs(
            params, row={self._enc_names()[0], "nb_nu_encoding", "depth",
                         "ln_kappa"},
            col={"nb_mu_decoding", "nb_nu_decoding"},
            flat={"x_mean", "ln_x_sd", "mu_bias", "nu_bias"},
            overrides={"ln_vmf_mu": 0})

    def _tp_local_rows(self, x, model_axis):
        """(label^T (K, D / N), filter (D / N,)): the rank's block of the
        annotation's constants, by its model index (vmfnb_mixture.py:
        386-392; the model row's group ranks are its model indices)."""
        label, filt = self.masks(x.device)
        d = x.shape[1]
        i = 0 if model_axis is None else dist.get_rank(model_axis)
        return label[:, i * d:(i + 1) * d], filt[i * d:(i + 1) * d]

    def tp_normalize_nb_x(self, params: dict, x, model_axis):
        xn = tp_l2_normalize(torch.log1p(x.float()), model_axis, dim=1)
        return (xn - params["x_mean"]) / (F.softplus(params["ln_x_sd"])
                                          + 1e-2)

    def tp_vmf_forward(self, params: dict, x, training: bool, model_axis,
                       gumbel_u=None, kappa_pre=None) -> VMFOut:
        """:meth:`vmf_forward` on the shard (vmfnb_mixture.py:412-467): the
        components' column norms over the whole D, the E-step's
        contraction summed over the row, the reconstruction's latent
        cotangent summed where it enters the split product.
        ``kappa_pre`` is the ``ln_kappa`` head's summed pre-activation
        when the caller has it."""
        label, filt = self._tp_local_rows(x, model_axis)
        eps = 1e-2 / float(self.data_dim)
        vmf_mu = tp_l2_normalize(
            (torch.exp(params["ln_vmf_mu"]) + eps) * label.T, model_axis,
            dim=0)
        if kappa_pre is None:
            kappa_pre = psum_id_grad(x.float() @ params["ln_kappa"]["weight"],
                                     model_axis)
        kappa = self._kappa(kappa_pre + params["ln_kappa"]["bias"])
        xn = tp_l2_normalize((torch.log1p(x.float()) + eps) * filt,
                             model_axis, dim=1)
        logits = torch.log_softmax(
            psum_id_grad(xn @ vmf_mu, model_axis) * kappa, dim=1)
        if training:
            latent = torch.exp(logits)
        else:
            if gumbel_u is None:
                raise ValueError("tp_vmf_forward(training=False) needs the "
                                 "Gumbel uniforms gumbel_u")
            latent = hard_assignment(
                logits, _tile_rows(gumbel_u.to(x.device), x.shape[0]))
        recon = (psum_grad(latent, model_axis) @ vmf_mu.T) * filt
        return VMFOut(vmf_mu, logits, latent, recon, kappa)

    def tp_nb_encode_mu(self, params: dict, x, z, model_axis, h_pre=None):
        """:meth:`nb_encode_mu` on the shard (vmfnb_mixture.py:469-487);
        ``h_pre`` the first layer's summed product when the caller has
        it."""
        first = params[self._enc_names()[0]]
        if h_pre is None:
            h_pre = psum_id_grad(self.tp_normalize_nb_x(params, x, model_axis)
                                 @ first["weight"], model_axis)
        h = h_pre + first["bias"]
        if self.do_relu:
            h = torch.relu(h)
        h = apply_stack(params, self._enc_names()[1:], h, self.do_relu,
                        relu_last=True)
        return self._heads(params, h, z)

    def _tp_step_prelude(self, params: dict, x, eps, model_axis):
        """:meth:`_step_prelude` on the shard (vmfnb_mixture.py:498-527):
        the first layers of the NB encoder, the nu encoder, the depth and
        the kappa heads summed in one collective."""
        xf = x.float()
        first = params[self._enc_names()[0]]
        hm, hn, hd, hk = psum_id_grad(
            [self.tp_normalize_nb_x(params, x, model_axis) @ first["weight"],
             xf @ params["nb_nu_encoding"]["weight"],
             xf @ params["depth"]["weight"],
             xf @ params["ln_kappa"]["weight"]], model_axis)
        vmf = self.tp_vmf_forward(params, x, True, model_axis, kappa_pre=hk)
        mu_mean, mu_lnvar = self.tp_nb_encode_mu(params, x, vmf.latent,
                                                 model_axis, h_pre=hm)
        nu_mean, nu_lnvar = self._nu_heads(
            params, torch.relu(hn + params["nb_nu_encoding"]["bias"]))
        dec, nud = params["nb_mu_decoding"], params["nb_nu_decoding"]
        return dict(
            z_mu=reparameterize(mu_mean, mu_lnvar, eps[0]),
            z_nu=reparameterize(nu_mean, nu_lnvar, eps[1]),
            depth=_softplus(hd + params["depth"]["bias"]),
            wd=dec["weight"], bias2=dec["bias"], wn=nud["weight"],
            bias_n=nud["bias"] - params["nu_bias"][0],
            pb=params["mu_bias"][0], vmf=vmf,
            kl=(gaussian_kl(mu_mean, mu_lnvar)
                + gaussian_kl(nu_mean, nu_lnvar) + uniform_kl(vmf.logits)))

    def _need_fused(self):
        if not self._can_fuse_step():
            raise ValueError("TP fused step needs a direct decoder")

    def fused_step_report_tp(self, params: dict, x, c, eps, beta,
                             model_axis, include_data_const: bool = True):
        """Reporting loss on the shard (vmfnb_mixture.py:529-549)."""
        del c
        self._need_fused()
        pre = self._tp_step_prelude(params, x, eps, model_axis)
        nll = nb_step_report(*self._step_args(pre, x),
                             include_const=include_data_const, pb=pre["pb"],
                             model_axis=model_axis)
        vmf_nll = tp_vmf_nllik_parts(x, pre["vmf"].recon, pre["vmf"].kappa,
                                     self.dd, model_axis)
        return (nll + vmf_nll + beta * pre["kl"]) / x.shape[0]

    def fused_step_boot_tp(self, params: dict, x, c, eps, beta, model_axis,
                           need_value: bool = True):
        """Boot-step loss on the shard: K1, K2p (K2pv with
        ``need_value``) and K3 at D / N with their merges."""
        del c
        self._need_fused()
        pre = self._tp_step_prelude(params, x, eps, model_axis)
        nll = (nb_step_boot_joint if need_value
               else nb_step_boot_joint_gradonly)(
            *self._step_args(pre, x), pre["pb"], model_axis=model_axis)
        vmf_nll = tp_vmf_nllik_parts(x, pre["vmf"].recon, pre["vmf"].kappa,
                                     self.dd, model_axis)
        return (nll + vmf_nll + beta * pre["kl"]) / x.shape[0]

    def tp_record_encoder(self, seed: int, B: int, rows, model_axis):
        """The recorder's encode on the shard (``tp_record_encode`` /
        ``tp_record_extra``, cli/vmfnb_vae.py:145-157): the frozen E-step
        with the uniforms of ``seed`` (the data index's ``rows`` of them),
        returning (mean, lnvar, clust), and the extra artifact's name."""
        u = self.gumbel_uniforms(B, seed)
        if rows is not None:
            u = u[rows]
        on_device: dict = {}

        def encode(params, x):
            key = str(x.device)
            if key not in on_device:  # one host->device copy per device
                on_device[key] = u.to(x.device)
            vmf = self.tp_vmf_forward(params, x, False, model_axis,
                                      on_device[key])
            return (*self.tp_nb_encode_mu(params, x, vmf.latent, model_axis),
                    vmf.latent)

        return encode, "clust"


# ----------------------------------------------------------------------
# losses (reference vmfnb_mixture.hh:607-654, 812-848)
# ----------------------------------------------------------------------

def _mixture_vmf_nllik_parts(x: torch.Tensor, recon: torch.Tensor,
                             kappa2d: torch.Tensor, dd: float
                             ) -> torch.Tensor:
    """vMF NLL over the masked feature set (vmfnb_mixture.hh:610-629): the
    joint model's formula restricted to ``dd`` effective features."""
    return vmf_nllik_parts(x, recon, kappa2d, dd=dd)


def mixture_vmf_nllik(x: torch.Tensor, out: VMFNBMixtureOutput, dd: float
                      ) -> torch.Tensor:
    return _mixture_vmf_nllik_parts(x, out.vmf_recon, out.vmf_kappa, dd)


def mixture_composite_loss(x: torch.Tensor, out: VMFNBMixtureOutput, rate,
                           dd: float) -> torch.Tensor:
    """(NB NLL + vMF NLL + rate * (KL_gauss + KL_uniform)) / n (reference
    composite_loss_t, vmfnb_mixture.hh:812-848; the mixture does NOT
    floor the rate at min_rate)."""
    kl = (gaussian_kl(out.nb_mu_mean, out.nb_mu_lnvar)
          + gaussian_kl(out.nb_nu_mean, out.nb_nu_lnvar))
    nb = nb_nllik(x, out.nb_recon_mu, out.nb_recon_nu, out.nb_recon_depth)
    return (nb + mixture_vmf_nllik(x, out, dd)
            + rate * (kl + uniform_kl(out.vmf_logits))) / x.shape[0]
