"""Joint vMF + NB VAE: two likelihoods on the same data, one shared
encoder.

Port of ``mmvae_tpu/models/vmfnb.py`` (reference include/models/
vmfnb.hh:241-758) for what the packed step and serving need: the
parameter tree (``init``), the plain shared encoder
(``shared_encode_mu``, with ``normalize_nb_x``), ``_can_fuse_step``,
and a folded encoder for serving.  ``forward``, ``nb_encode_nu`` and
``vmf_decode_mu`` belong to the generic step path (ROADMAP.md Queue 1
item 11) and are not ported.  The tree converters of
:mod:`mmvae_tpu_torch.models.nb` (``params_from_numpy``,
``adam_from_numpy`` and their inverses) work on this tree unchanged.

The reference's quirks the port keeps (they differ from the NB model):
the encoder input is ``log1p(x)`` L2-normalized per row, then
standardized with ``eps = 1e-2`` (vmfnb.hh:601-611); ``mu_bias`` sits
outside the log-softmax; nu decodes as ``clamp(exp(.), 0, 1e4)``; the nu
encoder's hidden layer is ReLU'd.

Serving folds the standardization and the row norm into the first layer,
as ``mmvae_tpu/ops/vmfnb_fast.py:384-396`` does::

    ((L / |L| - x_mean) / sd) @ W = (L @ Wt^T) / |L| - x_mean @ Wt^T,
    Wt = (W / sd^T)^T,  sd = softplus(ln_x_sd) + 1e-2

with ``|L|`` from the row stats of the same count-encoder call (K4 with
``want_stats``), so nothing (B, D) is materialised.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.enc_kernel import count_encode
from ..ops.initializers import linear_apply, torch_linear_init
from ..ops.losses import l2_normalize
from ..ops.nb_elbo import NU_HI
from .modules import apply_stack, init_linear_stack


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
        return self._heads(params, h)

    def _heads(self, params: dict, h: torch.Tensor):
        lnvar = torch.clamp(
            linear_apply(params["nb_mu_representation_logvariance"], h),
            -4.0, 4.0)
        return linear_apply(params["nb_mu_representation_mean"], h), lnvar

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
        return self._heads(params, h)

    def encode_mu(self, params: dict, x: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, lnvar) of q(z | x), the recorder's and the serving
        CLI's encode (reference vmfnb.hh:449-460)."""
        return self.encode_prepared(params, self.prepare_encoder(params), x)

    def record_encoder(self, seed: int, B: int):
        """The recorder's encode ``(params, x) -> (mean, lnvar)`` and its
        extra artifact's name (none); seed and B do not enter it."""
        del seed, B
        return self.encode_mu, None
