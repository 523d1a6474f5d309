"""von Mises-Fisher VAE: a likelihood on the unit sphere.

Port of ``mmvae_tpu/models/vmf.py`` (reference include/models/vmf.hh:
191-440): the parameter tree (``init``), ``encode``, ``decode``,
``forward`` with its noise injected, a folded encoder for serving, and
the tensor-parallel forms (vmf.py:140-245: ``tp_pspecs``,
``tp_standardize``, ``tp_encode``, ``tp_decode``, ``tp_step_loss``), in
which ``x`` and the D-sized parameter axes are this rank's shard and
``model_axis`` is the model row's process group: the Angular first
layer's column norms and partial product, the decoder's row norm and
the likelihood's cosine are summed over the row.  The tree converters of
:mod:`mmvae_tpu_torch.models.nb` (``params_from_numpy``,
``adam_from_numpy`` and their inverses) work on this tree unchanged.

Data rows are L2-normalized after log1p; the encoder stack is Angular
(direction-only) layers; the decoder is ``normalize(exp(dec(z)) +
covar_dec(c))``; one learned scalar ``ln_kappa`` is exponentiated and
clamped to ``[kappa_min, kappa_max]``.  The reference's quirks the port
keeps: the encoder standardization's eps is 1e-2 / D (vmf.hh:253-258);
lnvar is clamped to +-4; ``ln_kappa`` starts at log(kappa_min)
(vmf.hh:323); eval mode takes the mean; the covariate decoder keeps the
reference's name ``covar_decoding_`` (vmf.hh:388).

The kappa clamp is ``minimum(maximum(exp(ln_kappa), kappa_min),
kappa_max)``, JAX's ``jnp.clip``: at a tie (``ln_kappa`` starts at
exactly log(kappa_min), and exp gives back kappa_min for 0.5 or 1.0)
the gradient splits in half, where ``torch.clamp`` would pass it whole.

The whole model is plain PyTorch, as the JAX package computes it in XLA:
no kernel of the port lies on its path.  The serving encoder folds the
standardization through the Angular first layer, as
``mmvae_tpu/ops/vmf_fast.py:218-222`` does, and the row norm through the
product, as the joint model's encoder does::

    ((L / |L| - x_mean) / sd) @ ww = (L @ Wt^T) / |L| - x_mean @ Wt^T,
    Wt = (ww / sd^T)^T,  sd = softplus(ln_x_sd) + 1e-2 / D,

``L = log1p(x)``, ``ww`` the ReLU'd, column-normalized first-layer
weight: the (B, D) work of a batch is ``log1p`` of the stored counts,
one row-norm reduction and one product, nothing more materialised.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..ops.initializers import linear_apply, torch_linear_init
from ..ops.losses import gaussian_kl, l2_normalize, vmf_loss_parts
from ..ops.nb_elbo import _softplus
from ..parallel.collectives import psum_grad, psum_id_grad, tp_l2_normalize
from ..parallel.mesh import feature_sharded_pspecs
from .modules import apply_stack, init_linear_stack, reparameterize


class VMFVAEOutput(NamedTuple):
    """Forward output (reference vmf_vae_out_t, vmf.hh:191-196)."""

    recon: torch.Tensor
    mean: torch.Tensor
    lnvar: torch.Tensor
    kappa: torch.Tensor


def clip_kappa(e: torch.Tensor, kappa_min: float, kappa_max: float
               ) -> torch.Tensor:
    """``jnp.clip(e, kappa_min, kappa_max)`` with JAX's gradient at a tie
    (half to each side of ``maximum`` / ``minimum``)."""
    lo = torch.tensor(kappa_min, dtype=e.dtype, device=e.device)
    hi = torch.tensor(kappa_max, dtype=e.dtype, device=e.device)
    return torch.minimum(torch.maximum(e, lo), hi)


class VMFVAE(nn.Module):
    """Static configuration (reference ctor: vmf.hh:307-389); the
    parameters are passed to each call, as in the JAX package."""

    #: the recorder's and the serving CLI's posterior artifact names
    latent_names = ("latent_mean", "latent_lnvar")

    def __init__(self, data_dim: int, covar_dim: int, latent: int = 2,
                 encoding: tuple[int, ...] = (),
                 decoding: tuple[int, ...] = (), kappa_min: float = 0.1,
                 kappa_max: float = 10.0, do_relu: bool = False):
        super().__init__()
        self.data_dim = data_dim
        self.covar_dim = covar_dim
        self.latent = latent
        self.encoding = tuple(encoding)
        self.decoding = tuple(decoding)
        self.kappa_min = kappa_min
        self.kappa_max = kappa_max
        self.do_relu = do_relu

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator,
             device: torch.device | str = "cpu") -> dict:
        """LibTorch-initialized parameters, in the JAX package's names,
        order and shapes (``mmvae_tpu.models.vmf.VMFVAE.init``)."""
        D, C, Z = self.data_dim, self.covar_dim, self.latent

        def lin(d_in, d_out):
            return torch_linear_init(generator, d_in, d_out, device=device)

        params: dict = {
            "x_mean": torch.zeros((1, D), device=device),
            "ln_x_sd": torch.ones((1, D), device=device),
            "ln_kappa": torch.full((1,), math.log(self.kappa_min),
                                   device=device),
        }
        hidden = list(self.encoding)
        enc, _, d_prev = init_linear_stack(
            generator, "encoding", D, hidden, None if hidden else Z,
            device=device, angular=True)
        params.update(enc)
        params["covar_encoding"] = lin(C, Z)
        params["representation_mean"] = lin(d_prev, Z)
        params["representation_logvariance"] = lin(d_prev, Z)
        dec, _, _ = init_linear_stack(generator, "decoding", Z,
                                      list(self.decoding), D, device=device)
        params.update(dec)
        params["covar_decoding_"] = lin(C, D)
        return params

    def _enc_names(self) -> list[str]:
        if self.encoding:
            return [f"encoding_{i + 1}" for i in range(len(self.encoding))]
        return ["encoding"]

    def _dec_names(self) -> list[str]:
        return [f"decoding_{i + 1}"
                for i in range(len(self.decoding))] + ["decoding"]

    # ------------------------------------------------------------------
    # the plain specification
    # ------------------------------------------------------------------
    def _standardize(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """vmf.hh:250-258: the unit row of log1p(x), standardized with eps
        1e-2 / D."""
        xn = l2_normalize(torch.log1p(x.float()), dim=1)
        return (xn - params["x_mean"]) / (_softplus(params["ln_x_sd"])
                                          + 1e-2 / float(x.shape[1]))

    def _heads(self, params: dict, h: torch.Tensor, c):
        lnvar = torch.clamp(
            linear_apply(params["representation_logvariance"], h), -4.0, 4.0)
        mean = linear_apply(params["representation_mean"], h)
        if c is not None:
            mean = mean + linear_apply(params["covar_encoding"], c)
        return mean, lnvar

    def encode(self, params: dict, x: torch.Tensor,
               c: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, lnvar) of q(z | x) (vmf.hh:250-281); the covariate term
        enters the mean only when ``c`` is given."""
        h = apply_stack(params, self._enc_names(),
                        self._standardize(params, x), self.do_relu,
                        relu_last=True, angular=True)
        return self._heads(params, h, c)

    def decode(self, params: dict, z: torch.Tensor, c: torch.Tensor
               ) -> torch.Tensor:
        """Unit rows ``normalize(exp(dec(z)) + covar_dec(c))``
        (vmf.hh:283-290)."""
        h = torch.exp(apply_stack(params, self._dec_names(), z,
                                  self.do_relu, relu_last=False))
        return l2_normalize(h + linear_apply(params["covar_decoding_"], c),
                            dim=1)

    def kappa(self, ln_kappa: torch.Tensor) -> torch.Tensor:
        """``clip(exp(ln_kappa), kappa_min, kappa_max)`` with JAX's tie
        rule (:func:`clip_kappa`)."""
        return clip_kappa(torch.exp(ln_kappa), self.kappa_min,
                          self.kappa_max)

    def forward(self, params: dict, x: torch.Tensor, c: torch.Tensor, eps,
                training: bool = True) -> VMFVAEOutput:
        """Full forward pass (vmf.hh:292-304); ``eps = (eps_z,)``, unused in
        eval mode."""
        mean, lnvar = self.encode(params, x, c)
        z = reparameterize(mean, lnvar, eps[0] if training else None)
        return VMFVAEOutput(self.decode(params, z, c), mean, lnvar,
                            self.kappa(params["ln_kappa"]))

    # ------------------------------------------------------------------
    # serving: the folded encoder
    # ------------------------------------------------------------------
    def prepare_encoder(self, params: dict) -> dict:
        """Parameter-only part of the folded Angular first layer: ``Wt``
        (H1, D) contiguous and the ``x_mean`` term."""
        ww = l2_normalize(
            torch.relu(params[self._enc_names()[0]]["weight"]) + 1e-4, dim=0)
        sd = _softplus(params["ln_x_sd"]) + 1e-2 / float(self.data_dim)
        Wt = (ww / sd.T).T.contiguous()                       # (H1, D)
        return {"Wt": Wt, "xm": (params["x_mean"] @ Wt.T)[0]}

    def encode_prepared(self, params: dict, prep: dict, x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`encode` with ``c = None`` and :meth:`prepare_encoder`
        done: ``log1p`` of the counts in their stored dtype (int8, int16
        or float32 widen to the same float32), their row norms and one
        (B, D) x (D, H1) product."""
        L = torch.log1p(x)
        nrm = torch.clamp_min(torch.linalg.vector_norm(L, dim=1,
                                                       keepdim=True), 1e-12)
        h = (L @ prep["Wt"].T) / nrm - prep["xm"]
        if self.do_relu:
            h = torch.relu(h)
        h = apply_stack(params, self._enc_names()[1:], h, self.do_relu,
                        relu_last=True, angular=True)
        return self._heads(params, h, None)

    def encode_mu(self, params: dict, x: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, lnvar) with no covariate, folded: the recorder's and the
        serving CLI's encode (``mmvae_tpu/cli/vmf_vae.py:73-78``)."""
        return self.encode_prepared(params, self.prepare_encoder(params), x)

    def record_encoder(self, seed: int, B: int, rows: slice | None = None):
        """The recorder's encode ``(params, x) -> (mean, lnvar)`` and its
        extra artifact's name (none); seed, B and rows do not enter it."""
        del seed, B, rows
        return self.encode_mu, None

    # ------------------------------------------------------------------
    # tensor parallel: x and the D-sized parameter axes are shards; the
    # whole model stays plain PyTorch, as JAX computes it in XLA
    # ------------------------------------------------------------------
    def tp_pspecs(self, params: dict) -> dict:
        """The split axis of each leaf (vmf.py:149-161): the Angular first
        layer's (D, H) rows (no bias), the last decoder's and the
        covariate decoder's columns, ``x_mean`` and ``ln_x_sd``."""
        return feature_sharded_pspecs(
            params, row={self._enc_names()[0]},
            col={self._dec_names()[-1], "covar_decoding_"},
            flat={"x_mean", "ln_x_sd"})

    def tp_standardize(self, params: dict, x, model_axis) -> torch.Tensor:
        """:meth:`_standardize` with the row norm summed over the row; eps
        1e-2 / D of the whole D (vmf.py:163-171)."""
        xn = tp_l2_normalize(torch.log1p(x.float()), model_axis, dim=1)
        return (xn - params["x_mean"]) / (_softplus(params["ln_x_sd"])
                                          + 1e-2 / float(self.data_dim))

    def tp_encode(self, params: dict, x, c, model_axis):
        """:meth:`encode` on the shard (vmf.py:173-199): the Angular first
        layer's column norms and its partial product summed over the
        row."""
        names = self._enc_names()
        ww = tp_l2_normalize(torch.relu(params[names[0]]["weight"]) + 1e-4,
                             model_axis, dim=0)
        h = psum_id_grad(self.tp_standardize(params, x, model_axis) @ ww,
                         model_axis)
        if self.do_relu:
            h = torch.relu(h)
        h = apply_stack(params, names[1:], h, self.do_relu, relu_last=True,
                        angular=True)
        return self._heads(params, h, c)

    def tp_decode(self, params: dict, z, c, model_axis) -> torch.Tensor:
        """:meth:`decode` with the last layer's columns split (vmf.py:
        201-216): the replicated hidden stack's cotangent is summed over
        the row where it enters the split layer, and so is the row norm."""
        names = self._dec_names()
        h = apply_stack(params, names[:-1], z, self.do_relu, relu_last=True)
        h = torch.exp(linear_apply(params[names[-1]],
                                   psum_grad(h, model_axis)))
        return tp_l2_normalize(h + linear_apply(params["covar_decoding_"], c),
                               model_axis, dim=1)

    def tp_step_loss(self, params: dict, x, c, eps, beta, model_axis):
        """The whole loss on the shard (vmf.py:218-245), the report and the
        boot loss of a tensor-parallel ``Trainer`` alike; ``eps =
        (eps_z,)``."""
        mean, lnvar = self.tp_encode(params, x, c, model_axis)
        recon = self.tp_decode(params, reparameterize(mean, lnvar, eps[0]),
                               c, model_axis)
        dd = float(self.data_dim)
        yobs = tp_l2_normalize(torch.log1p(torch.relu(x.float())) + 1e-2 / dd,
                               model_axis, dim=1)
        cos = psum_id_grad(torch.sum(yobs * recon, dim=1), model_axis)
        return vmf_loss_parts(cos, self.kappa(params["ln_kappa"]),
                              gaussian_kl(mean, lnvar), beta, dd)

    def tp_record_encoder(self, seed: int, B: int, rows, model_axis):
        """The recorder's encode on the shard (``tp_encode`` with no
        covariate, cli/vmf_vae.py:113-116) and its extra name (none)."""
        del seed, B, rows
        return (lambda p, x: self.tp_encode(p, x, None, model_axis), None)
