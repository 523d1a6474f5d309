"""Negative-binomial constants, positive-domain lgamma / digamma, and the
v1 fused NB ELBO data term with its two kernels.

Port of ``mmvae_tpu/ops/nb_elbo.py``:

- ``EPS``, ``NU_LO``, ``NU_HI`` and the shift-into-Stirling
  ``_lgamma_pos`` / ``_digamma_pos`` (nb_elbo.py:36-38, 75-114).  The
  arguments are always positive and bounded (nu in [2e-4, 1e4], nu plus
  counts), so shifting below 8 and a three-term Stirling series are
  accurate to ~1e-7 relative.  The CUDA kernels
  (``mmvae_tpu_torch/csrc/nb_step_common.cuh``) evaluate the same series.
- :func:`nb_nllik_fused`, the NB NLL of the decoder logits ``h`` and the
  overdispersion pre-activation ``nu_pre`` (both materialized (B, D)),
  as a ``torch.autograd.Function`` over two kernels:

  * forward (K7, ``csrc/nb_elbo.cu``, replacing ``_make_fwd_kernel`` /
    ``_fwd_call``): the scalar NLL and the per-row residuals
    ``lse = logsumexp(h)``, ``rowsum(dls)`` and ``rowsum(dmu * p)``, a
    thread-block cluster a row; plain version :func:`elbo_fwd_ref`;
  * backward (K8, replacing ``_bwd_kernel`` / ``_bwd_call``): ``dh`` and
    ``dnu`` recomputed from the residuals, 4 adjacent columns a thread;
    plain version :func:`elbo_bwd_ref`.

  :func:`elbo_plan` is both kernels' launch plan, which the C entries
  check.

  ``elbo_fwd`` and ``elbo_bwd`` pick by where ``x`` lies: a CPU tensor
  goes to the plain version, a CUDA tensor launches the kernel or raises.
  ``elbo_fwd.launches`` / ``elbo_fwd.const_launches`` (the instance that
  adds ``lgamma(x + 1)``) and ``elbo_bwd.launches`` count launches.
  :func:`_reference_impl` is the JAX package's plain XLA spec (what it
  runs off the TPU), differentiated by autograd.

Semantics (up to float reassociation)::

    ls  = log_softmax(h, axis=1)
    mu  = exp(ls) * depth + EPS
    nu  = clip(softplus(nu_pre), NU_LO, NU_HI) + EPS
    nll = sum(lgamma(nu) - lgamma(nu + x)
              + x * (log(mu + nu) - log(mu)) + nu * (log(mu + nu) - log(nu)))
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .enc_kernel import _DTYPE_CODE

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


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(v, 0)."""
    return torch.logaddexp(v, torch.zeros_like(v))


# ----------------------------------------------------------------------
# the JAX package's plain spec, and the kernels' math as plain versions
# ----------------------------------------------------------------------

def _reference_impl(x, h, nu_pre, depth, include_data_const: bool = False):
    """Plain spec (``_reference_impl``, nb_elbo.py:320), with
    ``torch.lgamma``; differentiable by autograd in h, nu_pre, depth."""
    x = x.float()
    mu = torch.exp(torch.log_softmax(h, dim=1)) * depth + EPS
    nu = torch.clamp(_softplus(nu_pre), NU_LO, NU_HI) + EPS
    denom = torch.log(mu + nu)
    terms = (torch.lgamma(nu) - torch.lgamma(nu + x)
             + x * (denom - torch.log(mu)) + nu * (denom - torch.log(nu)))
    if include_data_const:
        terms = terms + torch.lgamma(x + 1.0)
    return torch.sum(terms)


def _activations(x, h, nu_pre, depth, lse):
    """The kernels' shared recompute (``_activations``, nb_elbo.py:116):
    activations and d nll / d mu."""
    p = torch.exp(h - lse)                              # softmax(h)
    mu = p * depth + EPS
    sp = _softplus(nu_pre)
    nu = torch.clamp(sp, NU_LO, NU_HI) + EPS
    inv_mn = 1.0 / (mu + nu)
    dmu = x * (inv_mn - 1.0 / mu) + nu * inv_mn
    return p, mu, sp, nu, inv_mn, dmu


def elbo_fwd_ref(x, h, nu_pre, depth, with_const: bool):
    """K7's outputs: ``(nll, lse, rowsum(dls), rowsum(dmu * p))``, the
    scalar NLL and three (B, 1) residuals, ``dls = dmu * p * depth``
    (phase 1 of ``_make_fwd_kernel``, with ``_lgamma_pos`` for every
    lgamma, ``lgamma(x + 1)`` included)."""
    x = x.float()
    lse = torch.logsumexp(h, dim=1, keepdim=True)
    p, mu, sp, nu, inv_mn, dmu = _activations(x, h, nu_pre, depth, lse)
    denom = torch.log(mu + nu)
    terms = (_lgamma_pos(nu) - _lgamma_pos(nu + x)
             + x * (denom - torch.log(mu)) + nu * (denom - torch.log(nu)))
    if with_const:
        terms = terms + _lgamma_pos(x + 1.0)
    dmu_p = dmu * p
    return (terms.sum(), lse, (dmu_p * depth).sum(1, keepdim=True),
            dmu_p.sum(1, keepdim=True))


def elbo_bwd_ref(g, x, h, nu_pre, depth, lse, rowsum):
    """K8's outputs ``(dh, dnu)`` for the cotangent ``g`` of the NLL
    (``_bwd_kernel``, nb_elbo.py:266): ``dh = g (dls - p rowsum)``;
    ``dnu`` is zero where the softplus sits outside (NU_LO, NU_HI)."""
    x = x.float()
    p, mu, sp, nu, inv_mn, dmu = _activations(x, h, nu_pre, depth, lse)
    dh = g * (dmu * p * depth - p * rowsum)
    dnu = (_digamma_pos(nu) - _digamma_pos(nu + x) + (x + nu) * inv_mn
           + torch.log(mu + nu) - torch.log(nu) - 1.0)
    in_range = (sp > NU_LO) & (sp < NU_HI)
    return dh, torch.where(in_range, g * dnu * torch.sigmoid(nu_pre),
                           torch.zeros_like(dnu))


# ----------------------------------------------------------------------
# the launch plan and the kernel wrappers
# ----------------------------------------------------------------------

ELBO_THREADS = 256         # K7's threads a block (kFwdThreads)
ELBO_MAX_CLUSTER = 8       # blocks a row at most: the portable cluster size
ELBO_MIN_SLICE = 1024      # columns a block before a row is cut further
ELBO_SLICE_ALIGN = 32      # a slice is whole warps of columns
ELBO_COL_BYTES = 12        # h, nu_pre and the widened count of a column
# a slice's shared memory at most: the 232,448 bytes an H100 block can
# have, less 1 KB kept for the kernel's static shared memory
ELBO_SLICE_SMEM = 232448 - 1024
ELBO_BWD_BLOCK_COLS = 1024  # K8's columns a block: 256 threads x 4


class ElboPlan(NamedTuple):
    """One K7 / K8 call: K7's cluster of blocks a row, threads a block,
    columns a block (``slice``), dynamic shared memory a block, instance
    ("onchip": the slice of h, nu_pre and the counts held in shared
    memory; "reread": read again from global memory), grid (cluster x B
    blocks) and workspace (the (4, B) rows, in floats); K8's grid
    (column blocks, B) of ``bwd_block_cols`` columns a block."""
    cluster: int
    threads: int
    slice: int
    smem: int
    instance: str
    grid: int
    workspace: int
    bwd_block_cols: int
    bwd_grid: tuple[int, int]


def elbo_plan(B: int, D: int) -> ElboPlan:
    """K7's and K8's launch plan for (B, D) operands, from the shape
    alone (never the dtype or the card), so every sum's order is fixed by
    (B, D).  A row's cluster doubles from one block while each block keeps
    at least ``ELBO_MIN_SLICE`` columns, up to ``ELBO_MAX_CLUSTER``; the
    slice is the row's share rounded up to whole warps of columns; the
    on-chip instance takes every slice whose 12 bytes a column fit
    ``ELBO_SLICE_SMEM`` (D <= 154,112 at 8 blocks), the re-read instance
    the rest."""
    if B < 1 or D < 1:
        raise ValueError(f"nb_elbo: empty operands (B={B}, D={D})")
    if B > 65535:
        raise ValueError(f"nb_elbo: B={B} rows, past the 65,535 a launch "
                         f"takes")
    cluster = 1
    while (cluster < ELBO_MAX_CLUSTER
           and -(-D // (2 * cluster)) >= ELBO_MIN_SLICE):
        cluster *= 2
    share = -(-D // cluster)
    slice_ = -(-share // ELBO_SLICE_ALIGN) * ELBO_SLICE_ALIGN
    smem = slice_ * ELBO_COL_BYTES
    onchip = smem <= ELBO_SLICE_SMEM
    return ElboPlan(cluster, ELBO_THREADS, slice_, smem if onchip else 0,
                    "onchip" if onchip else "reread", cluster * B, 4 * B,
                    ELBO_BWD_BLOCK_COLS, (-(-D // ELBO_BWD_BLOCK_COLS), B))


def _check(what: str, x, named: dict) -> torch.device:
    """Everything the kernels do not take raises here, before any CUDA
    call.  ``named`` maps a name to (float32 tensor, expected shape)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: x must be int8, int16 or float32, got "
                        f"{x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{what}: x must be a non-empty (B, D) matrix")
    for name, (t, shape) in {"x": (x, tuple(x.shape)), **named}.items():
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if name != "x" and t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
    return dev


def _call(dev, what: str, fn: str, *args) -> None:
    from . import _cuda

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda.check(getattr(_cuda.lib(), fn)(*args, stream), what)


def elbo_fwd(x, h, nu_pre, depth, with_const: bool = False):
    """K7: ``(nll, lse, rowsum, ddepth)`` as :func:`elbo_fwd_ref`."""
    if x.device.type == "cpu":
        return elbo_fwd_ref(x, h, nu_pre, depth, with_const)
    B, D = x.shape
    dev = _check("nb_elbo.fwd", x, {"h": (h, (B, D)),
                                    "nu_pre": (nu_pre, (B, D)),
                                    "depth": (depth, (B, 1))})
    plan = elbo_plan(B, D)
    rows = torch.empty((4, B), dtype=torch.float32, device=dev)
    nll = torch.empty((), dtype=torch.float32, device=dev)
    _call(dev, "nb_elbo.fwd", "mmvae_nb_elbo_fwd", x.data_ptr(),
          _DTYPE_CODE[x.dtype], h.data_ptr(), nu_pre.data_ptr(),
          depth.data_ptr(), B, D, int(bool(with_const)), plan.cluster,
          plan.threads, plan.slice, int(plan.instance == "onchip"),
          rows.data_ptr(), rows.numel(), nll.data_ptr())
    if with_const:
        elbo_fwd.const_launches += 1
    else:
        elbo_fwd.launches += 1
    # rows: [lse | rowsum(dls) | rowsum(dmu p) | per-row NLL partial]
    return nll, rows[0, :, None], rows[1, :, None], rows[2, :, None]


elbo_fwd.launches = 0
elbo_fwd.const_launches = 0


def elbo_bwd(g, x, h, nu_pre, depth, lse, rowsum):
    """K8: ``(dh, dnu)`` as :func:`elbo_bwd_ref`; ``g`` is the scalar
    cotangent (a 0-d tensor on x's device, read by the kernel)."""
    if x.device.type == "cpu":
        return elbo_bwd_ref(g, x, h, nu_pre, depth, lse, rowsum)
    B, D = x.shape
    g = g.to(torch.float32).reshape(()).contiguous()
    lse, rowsum = lse.contiguous(), rowsum.contiguous()
    dev = _check("nb_elbo.bwd", x, {
        "g": (g, ()), "h": (h, (B, D)), "nu_pre": (nu_pre, (B, D)),
        "depth": (depth, (B, 1)), "lse": (lse, (B, 1)),
        "rowsum": (rowsum, (B, 1))})
    dh = torch.empty((B, D), dtype=torch.float32, device=dev)
    dnu = torch.empty((B, D), dtype=torch.float32, device=dev)
    _call(dev, "nb_elbo.bwd", "mmvae_nb_elbo_bwd", g.data_ptr(),
          x.data_ptr(), _DTYPE_CODE[x.dtype], h.data_ptr(),
          nu_pre.data_ptr(), depth.data_ptr(), lse.data_ptr(),
          rowsum.data_ptr(), B, D, elbo_plan(B, D).bwd_block_cols,
          dh.data_ptr(), dnu.data_ptr())
    elbo_bwd.launches += 1
    return dh, dnu


elbo_bwd.launches = 0


class _NBNllikFused(torch.autograd.Function):
    """Forward K7 saving the (B, 1) residuals; backward K8 (``_vjp_fwd``
    / ``_vjp_bwd``, nb_elbo.py:362-383).  x is data (no gradient)."""

    @staticmethod
    def forward(ctx, x, h, nu_pre, depth, include_data_const):
        h, nu_pre, depth = (t.contiguous() for t in (h, nu_pre, depth))
        nll, lse, rowsum, ddepth = elbo_fwd(x, h, nu_pre, depth,
                                            include_data_const)
        ctx.save_for_backward(x, h, nu_pre, depth, lse, rowsum, ddepth)
        return nll

    @staticmethod
    def backward(ctx, g):
        x, h, nu_pre, depth, lse, rowsum, ddepth = ctx.saved_tensors
        dh, dnu = elbo_bwd(g, x, h, nu_pre, depth, lse, rowsum)
        return None, dh, dnu, g * ddepth, None


def nb_nllik_fused(x, h, nu_pre, depth, include_data_const: bool = False):
    """NB NLL fused with the decoder activations.

    x      : (B, D) counts, int8 / int16 / float32 (data, no gradient)
    h      : (B, D) decoder logits (pre log_softmax), covariate and bias in
    nu_pre : (B, D) overdispersion pre-activation (nu_dec(z) - nu_bias)
    depth  : (B, 1) sequencing depth (post softplus)

    ``include_data_const`` adds the zero-gradient ``lgamma(x + 1)``
    (reported losses); gradient steps leave it off."""
    return _NBNllikFused.apply(x, h, nu_pre, depth, bool(include_data_const))
