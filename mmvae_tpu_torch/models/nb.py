"""Negative-binomial VAE: the encoder side that serving runs.

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
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.enc_kernel import count_encode
from ..ops.initializers import linear_apply, torch_linear_init
from .modules import apply_stack, init_linear_stack


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

    def record_encoder(self, seed: int, B: int):
        """The recorder's encode ``(params, x) -> (mean, lnvar)`` and its
        extra artifact's name (none); seed and B do not enter it."""
        del seed, B
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
