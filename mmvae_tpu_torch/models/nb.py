"""Negative-binomial VAE: the serving encoder and the generic training
step's losses.

Port of ``mmvae_tpu/models/nb.py`` (reference include/models/nb.hh).
Parameters live in a nested dict keyed with the reference's parameter
names (``mu_encoding``, ``mu_representation_mean``, ``nu_encoding``,
``depth``, ...), weights stored (in, out) — the JAX package's tree, so
:func:`params_from_numpy` / :func:`params_to_numpy` carry weights and
checkpoints across unchanged.

``encode_mu`` folds the learned input standardization into the first
layer, as ``mmvae_tpu/ops/nb_fast.py`` (``NBFastStep._heads``) does:

    ((log1p(x) - x_mean) / sd) @ W = log1p(x) @ Wt^T - x_mean @ Wt^T,
    Wt = (W / sd^T)^T  (H1, D),  sd = softplus(ln_x_sd) + 1e-4

so the (B, D) contraction runs in the count-encoder kernel
(:mod:`mmvae_tpu_torch.ops.enc_kernel`) straight from the integer
counts.  ``Wt`` and the ``x_mean`` term depend on the parameters only;
:meth:`NBVAE.prepare_encoder` builds them once per sweep.

The generic training step (``train.loop.Trainer``) calls one of three
losses, as the JAX package's ``Trainer._batch_step`` does:
:meth:`NBVAE.forward` with ``ops.losses.nb_loss`` (``--no_fused``),
:meth:`NBVAE.fused_loss` (the v1 ELBO kernels K7 / K8, any architecture)
and :meth:`NBVAE.fused_step_report` / :meth:`NBVAE.fused_step_boot` (the
v2 step kernels, direct mu decoder).  Their encoder heads share one
count-encoder call: ``Wt`` on the log1p side, the ``nu_encoding`` and
``depth`` rows on the raw-count side, differentiable through the fold
(backward K5).  Noise is passed in: ``eps = (eps_mu, eps_nu)`` where JAX
takes a key.  ``plain=True`` selects the plain versions (the JAX
package's XLA path) on any device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from typing import NamedTuple

from ..ops.enc_kernel import count_encode, count_encode_ref
from ..ops.initializers import linear_apply, torch_linear_init
from ..ops.losses import gaussian_kl
from ..ops.nb_elbo import _reference_impl, _softplus, nb_nllik_fused
from ..ops.nb_step import (nb_step_boot, nb_step_boot_gradonly,
                           nb_step_report, step_nll_ref)
from .modules import apply_stack, init_linear_stack, reparameterize


class NBVAEOutput(NamedTuple):
    """Forward output (reference: nbvae_out_t, nb.hh:200-210)."""

    recon_mu: torch.Tensor
    recon_nu: torch.Tensor
    recon_depth: torch.Tensor
    mu_mean: torch.Tensor
    mu_lnvar: torch.Tensor
    nu_mean: torch.Tensor
    nu_lnvar: torch.Tensor


class NBVAE(nn.Module):
    """Static model configuration (reference ctor: nb.hh:299-401); the
    parameters are passed to each call, as in the JAX package."""

    def __init__(self, data_dim: int, covar_dim: int = 1,
                 mean_encoding: tuple[int, ...] = (),
                 mean_decoding: tuple[int, ...] = (),
                 mean_latent: int = 2, overdisp_encoding: int = 1,
                 overdisp_latent: int = 1, do_relu: bool = False):
        super().__init__()
        self.data_dim = data_dim
        self.covar_dim = covar_dim
        self.mean_encoding = tuple(mean_encoding)
        self.mean_decoding = tuple(mean_decoding)
        self.mean_latent = mean_latent
        self.overdisp_encoding = overdisp_encoding
        self.overdisp_latent = overdisp_latent
        self.do_relu = do_relu

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator,
             device: torch.device | str = "cpu") -> dict:
        """LibTorch-initialized parameters, in the JAX package's names,
        order and shapes (``mmvae_tpu.models.nb.NBVAE.init``)."""
        D, C, R = self.data_dim, self.covar_dim, self.mean_latent

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
            generator, "mu_encoding", D, hidden, None if hidden else R,
            device=device)
        params.update(enc)
        params["covar_encoding"] = lin(C, R)
        params["mu_representation_mean"] = lin(d_prev, R)
        params["mu_representation_logvariance"] = lin(d_prev, R)
        dec, _, _ = init_linear_stack(
            generator, "mu_decoding", R, list(self.mean_decoding), D,
            device=device)
        params.update(dec)
        params["covar_decoding"] = lin(C, D)
        H, Rn = self.overdisp_encoding, self.overdisp_latent
        params["nu_encoding"] = lin(D, H)
        params["nu_representation_mean"] = lin(H, Rn)
        params["nu_representation_logvariance"] = lin(H, Rn)
        params["nu_decoding"] = lin(Rn, D)
        params["depth"] = lin(D, 1)
        return params

    def _can_fuse_step(self) -> bool:
        """The fused step kernels need a direct mu decoder (JAX
        ``NBVAE._can_fuse_step``)."""
        return not self.mean_decoding

    def _enc_names(self) -> list[str]:
        hidden = list(self.mean_encoding)
        if hidden:
            return [f"mu_encoding_{i + 1}" for i in range(len(hidden))]
        return ["mu_encoding"]

    # ------------------------------------------------------------------
    def prepare_encoder(self, params: dict) -> dict:
        """Parameter-only part of the folded first layer: ``Wt``
        (H1, D) contiguous, and its bias with the ``x_mean`` term
        folded in."""
        first = params[self._enc_names()[0]]
        sd = F.softplus(params["ln_x_sd"]) + 1e-4            # (1, D)
        Wt = (first["weight"] / sd.T).T.contiguous()          # (H1, D)
        bias = first["bias"] - (params["x_mean"] @ Wt.T)[0]
        return {"Wt": Wt, "bias": bias}

    def encode_prepared(self, params: dict, prep: dict, x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`encode_mu` with :meth:`prepare_encoder` already done."""
        hL, _ = count_encode(x, prep["Wt"])
        h = hL + prep["bias"]
        if self.do_relu:
            h = torch.relu(h)
        h = apply_stack(params, self._enc_names()[1:], h, self.do_relu,
                        relu_last=True)
        lnvar = torch.clamp(
            linear_apply(params["mu_representation_logvariance"], h),
            -4.0, 4.0)
        mean = linear_apply(params["mu_representation_mean"], h)
        return mean, lnvar

    def encode_mu(self, params: dict, x: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, lnvar) of q(z_mu | x) — reference nb.hh:403-431."""
        return self.encode_prepared(params, self.prepare_encoder(params), x)

    # ------------------------------------------------------------------
    # training: the generic step's losses
    # ------------------------------------------------------------------
    def _dec_names(self) -> list[str]:
        return [f"mu_decoding_{i + 1}"
                for i in range(len(self.mean_decoding))] + ["mu_decoding"]

    def _heads(self, params: dict, x, c, plain: bool = False):
        """(mu_mean, mu_lnvar, nu_mean, nu_lnvar, depth): ``encode_mu``
        with the covariate (nb.hh:403-431), ``encode_nu`` (nb.hh:444-451)
        and the depth head (nb.hh:498) from ONE count-encoder call — the
        first mu layer folded (``Wt``, log1p side) and the ``nu_encoding``
        and ``depth`` rows (raw-count side)."""
        first = params[self._enc_names()[0]]
        sd = _softplus(params["ln_x_sd"]) + 1e-4                  # (1, D)
        Wt = (first["weight"] / sd.T).T.contiguous()              # (H1, D)
        nd = torch.cat([params["nu_encoding"]["weight"],
                        params["depth"]["weight"]], dim=1).T.contiguous()
        hL, hX = (count_encode_ref if plain else count_encode)(x, Wt, nd)
        h = hL - params["x_mean"] @ Wt.T
        h = h + first["bias"]
        if self.do_relu:
            h = torch.relu(h)
        h = apply_stack(params, self._enc_names()[1:], h, self.do_relu,
                        relu_last=True)
        mu_lnvar = torch.clamp(
            linear_apply(params["mu_representation_logvariance"], h),
            -4.0, 4.0)
        mu_mean = (linear_apply(params["mu_representation_mean"], h)
                   + linear_apply(params["covar_encoding"], c))
        H = self.overdisp_encoding
        nu_h = hX[:, :H] + params["nu_encoding"]["bias"]
        nu_lnvar = torch.clamp(
            linear_apply(params["nu_representation_logvariance"], nu_h),
            -4.0, 4.0)
        nu_mean = linear_apply(params["nu_representation_mean"], nu_h)
        depth = _softplus(hX[:, H:] + params["depth"]["bias"])    # (B, 1)
        return mu_mean, mu_lnvar, nu_mean, nu_lnvar, depth

    def _logits(self, params: dict, z, c):
        """Decoder logits ``h + hc + mu_bias`` before the log-softmax."""
        h = apply_stack(params, self._dec_names(), z, self.do_relu,
                        relu_last=False)
        return h + linear_apply(params["covar_decoding"], c) + params[
            "mu_bias"]

    def decode_mu(self, params: dict, z, c):
        """Composition-vector decoder — reference nb.hh:433-442."""
        return torch.exp(torch.log_softmax(self._logits(params, z, c),
                                           dim=1))

    def _nu_pre(self, params: dict, z):
        return linear_apply(params["nu_decoding"], z) - params["nu_bias"]

    def decode_nu(self, params: dict, z):
        """Reference nb.hh:453-460."""
        return torch.clamp(_softplus(self._nu_pre(params, z)), 1e-4, 1e4)

    def forward(self, params: dict, x, c, eps, training: bool = True,
                plain: bool = False) -> NBVAEOutput:
        """Full forward pass (reference nb.hh:474-508); ``eps = (eps_mu,
        eps_nu)``, unused in eval mode."""
        mu_mean, mu_lnvar, nu_mean, nu_lnvar, depth = self._heads(
            params, x, c, plain)
        z_mu = reparameterize(mu_mean, mu_lnvar, eps[0] if training else None)
        z_nu = reparameterize(nu_mean, nu_lnvar, eps[1] if training else None)
        return NBVAEOutput(self.decode_mu(params, z_mu, c),
                           self.decode_nu(params, z_nu), depth, mu_mean,
                           mu_lnvar, nu_mean, nu_lnvar)

    def fused_loss(self, params: dict, x, c, eps, beta,
                   training: bool = True, include_data_const: bool = True,
                   plain: bool = False):
        """The whole NB-VAE loss with the decoder activations and the
        likelihood in the v1 ELBO kernels (:func:`nb_nllik_fused`: K7,
        backward K8); ``plain`` takes the JAX package's XLA spec
        (``_reference_impl``) instead (nb.py:185-225)."""
        mu_mean, mu_lnvar, nu_mean, nu_lnvar, depth = self._heads(
            params, x, c, plain)
        z_mu = reparameterize(mu_mean, mu_lnvar, eps[0] if training else None)
        z_nu = reparameterize(nu_mean, nu_lnvar, eps[1] if training else None)
        h = self._logits(params, z_mu, c)
        nu_pre = self._nu_pre(params, z_nu)
        nll = (_reference_impl if plain else nb_nllik_fused)(
            x, h, nu_pre, depth, include_data_const)
        total = nll + gaussian_kl(mu_mean, mu_lnvar) * beta
        total = total + gaussian_kl(nu_mean, nu_lnvar) * beta
        return total / x.shape[0]

    def _step_prelude(self, params: dict, x, c, eps, plain: bool = False):
        """Latents and the stacked decoder rows of the v2 step kernels
        (nb.py:232-262); the encoder math is :meth:`fused_loss`'s."""
        mu_mean, mu_lnvar, nu_mean, nu_lnvar, depth = self._heads(
            params, x, c, plain)
        dec, cov = params["mu_decoding"], params["covar_decoding"]
        nud = params["nu_decoding"]
        return dict(
            z_mu=reparameterize(mu_mean, mu_lnvar, eps[0]),
            z_nu=reparameterize(nu_mean, nu_lnvar, eps[1]),
            depth=depth, wd=dec["weight"], wc=cov["weight"],
            bias2=dec["bias"] + cov["bias"] + params["mu_bias"][0],
            wn=nud["weight"], bias_n=nud["bias"] - params["nu_bias"][0],
            kl=gaussian_kl(mu_mean, mu_lnvar) + gaussian_kl(nu_mean,
                                                            nu_lnvar))

    def _step_args(self, pre: dict, x, c) -> tuple:
        return (x, pre["z_mu"], c, pre["z_nu"], pre["depth"], pre["wd"],
                pre["wc"], pre["bias2"], pre["wn"], pre["bias_n"])

    def fused_step_report(self, params: dict, x, c, eps, beta,
                          include_data_const: bool = True,
                          plain: bool = False):
        """Reporting loss through the v2 step kernels (K1, K6); a hidden
        mu decoder takes :meth:`fused_loss` (nb.py:268-282)."""
        if not self._can_fuse_step():
            return self.fused_loss(params, x, c, eps, beta, True,
                                   include_data_const, plain)
        pre = self._step_prelude(params, x, c, eps, plain)
        args = self._step_args(pre, x, c)
        nll = (step_nll_ref(*args, include_const=include_data_const)
               if plain else
               nb_step_report(*args, include_const=include_data_const))
        return (nll + beta * pre["kl"]) / x.shape[0]

    def fused_step_boot(self, params: dict, x, c, eps, beta,
                        need_value: bool = True, plain: bool = False):
        """Boot-step loss through the v2 step kernels (nb.py:284-305):
        ``need_value`` runs K2v (:func:`nb_step_boot`) and returns the
        loss, otherwise the grad-only K2 whose NLL reads 0.0 (same
        gradient); a hidden mu decoder takes :meth:`fused_loss`."""
        if not self._can_fuse_step():
            return self.fused_loss(params, x, c, eps, beta, True, False,
                                   plain)
        pre = self._step_prelude(params, x, c, eps, plain)
        args = self._step_args(pre, x, c)
        if plain:
            nll = step_nll_ref(*args, include_const=False)
        else:
            nll = (nb_step_boot if need_value
                   else nb_step_boot_gradonly)(*args)
        return (nll + beta * pre["kl"]) / x.shape[0]

    def record_encoder(self, seed: int, B: int, rows: slice | None = None):
        """The recorder's encode ``(params, x) -> (mean, lnvar)`` and its
        extra artifact's name (none); seed, B and rows do not enter it."""
        del seed, B, rows
        return self.encode_mu, None


def params_from_numpy(tree: dict, device: torch.device | str = "cpu"
                      ) -> dict:
    """JAX param tree as numpy -> the port's float32 tensors (same keys)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def params_to_numpy(tree: dict) -> dict:
    """The port's tensors (on any device; numpy passes through) -> numpy
    arrays (same keys).  Works on the named tree and on the packed
    ``{P, sv}`` alike."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def adam_from_numpy(state, device: torch.device | str = "cpu") -> dict:
    """Adam state as numpy -> the port's ``{"count", "mu", "nu"}``.

    ``state`` is the JAX trainer's optax chain state (a tuple whose
    element 2 is ``ScaleByAdamState(count, mu, nu)``, leaves as numpy),
    that ``ScaleByAdamState`` alone, or a dict with those three keys; the
    moment trees may be named or packed."""
    if isinstance(state, (tuple, list)) and not hasattr(state, "mu"):
        state = state[2]
    get = state.__getitem__ if isinstance(state, dict) else (
        lambda k: getattr(state, k))
    return {"count": torch.tensor(int(np.asarray(get("count"))),
                                  dtype=torch.int32, device=device),
            "mu": params_from_numpy(get("mu"), device),
            "nu": params_from_numpy(get("nu"), device)}


def adam_to_numpy(state: dict) -> dict:
    """The port's Adam state -> ``{"count": int32, "mu", "nu"}`` numpy
    (wrap into optax's ``ScaleByAdamState`` to hand it to JAX)."""
    return {"count": np.asarray(state["count"].cpu().numpy(), np.int32),
            "mu": params_to_numpy(state["mu"]),
            "nu": params_to_numpy(state["nu"])}
