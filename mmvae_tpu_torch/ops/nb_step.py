"""Fused NB step: reporting NLL and the grad-only boot-step NLL.

Port of ``mmvae_tpu/ops/nb_step.py`` for the default NB model and the
NB half of the joint vMF+NB model.  The decoder logits
``h = zm @ wd + c @ wc + bias2`` and the overdispersion pre-activation
``zn @ wn + bias_n`` are built inside the kernels from the (B, R)
latents and the stacked weight rows ``W = [wd; wc; bias2; wn; bias_n]``
(T = R + C + Rn + 2 rows), so the only (B, D) tensor any kernel reads is
the count matrix ``x`` (int8, int16 or float32).

The joint model's variant (``pb`` / ``nu_exp``, vmfnb.hh:462-493) adds
the post-softmax log-bias ``pb`` as the last stacked row (T = R + C +
Rn + 3; ``mu = exp(log_softmax(h) + pb) * depth``) and decodes
``nu = clamp(exp(nu_pre), 0, NU_HI)`` instead of the softplus-clip.  K6
and K2 and their plain versions take both as one ``joint`` flag, as the
kernels' one JOINT instance does; only :func:`step_nll_ref` keeps
``pb=`` / ``nu_exp=`` apart, as ``xla_step_nll`` does.  K1 and K3 read
only the first R + C + 1 rows, so they take either W unchanged.

Four kernels, each a wrapper with a plain PyTorch version beside it:

- :func:`lse` (K1): row logsumexp of ``h``; :func:`lse_plan` is its
  launch plan and workspace;
- :func:`value` (K6): the NB NLL given that normaliser (reporting pass);
  :func:`value_plan` is its launch plan and workspace;
- :func:`valgrad` (K2): one pass over ``x`` giving the stacked per-column
  gradient rows ``gout`` and the per-row ``rsum``, ``u1``, ``dzn``, and
  with ``need_value`` the NLL without ``lgamma(x + 1)`` (K2v for the NB
  model, K2pv for the joint one); :func:`valgrad_plan` is its launch
  plan and workspace;
- :func:`finish` (K3): the softmax-coupling terms ``fout``, ``u2``;
  :func:`finish_plan` is its launch plan and workspace.

Every kernel takes the widths the reference trains: a compile-time
instance for the CLI defaults ((R, C, Rn) = (2, 1, 1)) and a general one
for any other R >= 1, C >= 0, Rn >= 1, up to the card's shared memory
(``MAX_STACKED_ROWS``: 181 stacked rows for K2 and K3, 908 for K6, no
limit for K1), which each plan states and names when it refuses.

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches its kernel (``mmvae_tpu_torch/csrc/nb_*.cu``) or raises — there
is no fallback on the card.  ``<wrapper>.launches`` counts the launches
of the NB instance, ``value.joint_launches`` and
``valgrad.joint_launches`` those of the joint one,
``valgrad.value_launches`` those of K2v and
``valgrad.joint_value_launches`` those of K2pv.

:func:`nb_step_report` runs K1 then K6.  :func:`nb_step_boot`,
:func:`nb_step_boot_gradonly`, :func:`nb_step_boot_joint` and
:func:`nb_step_boot_joint_gradonly` are ``torch.autograd.Function``s
whose forward runs K1, K2 (K2v / K2pv for the value-bearing forms), K3
and assembles the gradients (``_boot_fwd_impl``, nb_step.py:801-868),
and whose backward scales them by the incoming cotangent
(``_boot_bwd``); the grad-only forms' primal is 0.0, as on the JAX
kernel path, the value-bearing forms' the NLL without
``lgamma(x + 1)``.
:func:`step_nll_ref` is the differentiable plain specification
(``xla_step_nll``); tensor-parallel ``model_axis`` is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .enc_kernel import _DTYPE_CODE
from .nb_elbo import EPS, NU_HI, NU_LO, _softplus

# K2's, K6's and K3's launch plans (csrc/nb_valgrad.cu, nb_value.cu,
# nb_finish.cu, their shared layout nbk::tile): a block's D tile (kTile),
# its warps (kWarps, one value partial each), the widths of the
# compile-time instances, and each kernel's row chunking, at most 8
# chunks: ceil(B / 20) for K2 and K6, ceil(B / 50) for K3 (the best of
# 1-8 chunks at the main path's B = 100 on the H100, PERF.md)
VALGRAD_TILE = 64
VALGRAD_WARPS = 4
VALGRAD_FIXED = (2, 1, 1)
VALGRAD_CHUNK_ROWS = 20
VALGRAD_MAX_CHUNKS = 8
VALUE_CHUNK_ROWS = 20
VALUE_MAX_CHUNKS = 8
FINISH_FIXED = (2, 1)
FINISH_CHUNK_ROWS = 50
FINISH_MAX_CHUNKS = 8
# K1's launch plan (csrc/nb_lse.cu): a block's D tile (kTile: 8 warps x
# 32 columns) and rows (kGroup: one a lane), and the widths (R, C) of its
# compile-time instance
LSE_TILE = 256
LSE_GROUP = 32
LSE_FIXED = (2, 1)
# The only width limit, forced by the card: the shared memory an H100
# block can have (kMaxSmem).  The general instances of K2 and K3 keep a
# float a (stacked row, column) for the tile's weights and for each of
# the block's 4 warps' column sums, 5 x 64 x 4 = 1,280 bytes a row: at
# most 181 rows (R + C + Rn + 2 for K2, R + C + 1 for K3).  K6's keeps
# the weights alone, 256 bytes a row: 908 rows.  K1 walks its rows in
# slices and has no limit.
MAX_SMEM_BYTES = 232448
SMEM_ROW_BYTES = {"valgrad": (1 + VALGRAD_WARPS) * VALGRAD_TILE * 4,
                  "value": VALGRAD_TILE * 4,
                  "finish": (1 + VALGRAD_WARPS) * VALGRAD_TILE * 4}
MAX_STACKED_ROWS = {k: MAX_SMEM_BYTES // v for k, v in SMEM_ROW_BYTES.items()}


class TilePlan(NamedTuple):
    """One K2, K6 or K3 call: its stage-1 instance ("fixed", the
    compile-time widths, or "general"), the D tile width and count, the
    row chunks, the stage-1 grid (tiles, chunks), the workspace in
    floats: row partials (outputs, tiles, B), column partials (chunks,
    rows, D) when chunks > 1, value partials (chunks, tiles, warps); and
    the general instance's dynamic shared memory in bytes (0 for the
    compile-time one)."""
    instance: str
    tile: int
    tiles: int
    chunks: int
    grid: tuple[int, int]
    row_parts: int
    col_parts: int
    value_parts: int
    smem: int

    @property
    def workspace(self) -> int:
        return self.row_parts + self.col_parts + self.value_parts


def _chunks(B: int, rows: int, most: int) -> int:
    return min(-(-B // rows), most)


def _check_rows(what: str, kernel: str, rows: int, R: int, C: int,
                Rn: int = 1) -> int:
    """The general instance's shared memory for ``rows`` stacked rows, or
    a refusal naming the card's limit."""
    if R < 1 or C < 0 or Rn < 1:
        raise ValueError(f"{what} takes R >= 1 latent, C >= 0 covariate "
                         f"and Rn >= 1 overdispersion stacked rows (R={R}, "
                         f"C={C}, Rn={Rn})")
    smem = rows * SMEM_ROW_BYTES[kernel]
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{what}: {rows} stacked rows need {smem:,} bytes of shared "
            f"memory in the general instance ({SMEM_ROW_BYTES[kernel]:,} a "
            f"row), past the {MAX_SMEM_BYTES:,} bytes an H100 block can "
            f"have: at most {MAX_STACKED_ROWS[kernel]} stacked rows "
            f"(R={R}, C={C}, Rn={Rn})")
    return smem


def _check_shape(B, D):
    if B < 1 or D < 1:
        raise ValueError(f"empty operands (B={B}, D={D})")


def valgrad_plan(B: int, D: int, R: int, C: int, Rn: int,
                 joint: bool = False, need_value: bool = False
                 ) -> TilePlan:
    """K2's launch plan for x (B, D).  The tile width and the chunking
    depend on (B, D) alone, never on the widths, the dtype or the card,
    so the order of every sum is fixed by (B, D); the instance by the
    widths; the workspace by the shape and ``need_value`` (the pb row of
    ``joint`` is a copy of the colsum(dls) row and needs none).  Any
    widths whose R + C + Rn + 2 rows fit the general instance's shared
    memory (``MAX_STACKED_ROWS["valgrad"]``)."""
    Tc = R + C + Rn + 2
    smem = _check_rows("nb_step.valgrad", "valgrad", Tc, R, C, Rn)
    _check_shape(B, D)
    fixed = (R, C, Rn) == VALGRAD_FIXED
    tiles = -(-D // VALGRAD_TILE)
    chunks = _chunks(B, VALGRAD_CHUNK_ROWS, VALGRAD_MAX_CHUNKS)
    return TilePlan(
        "fixed" if fixed else "general", VALGRAD_TILE, tiles, chunks,
        (tiles, chunks), (1 + R + Rn) * tiles * B,
        chunks * Tc * D if chunks > 1 else 0,
        chunks * tiles * VALGRAD_WARPS if need_value else 0,
        0 if fixed else smem)


def value_plan(B: int, D: int, R: int, C: int, Rn: int,
               joint: bool = False) -> TilePlan:
    """K6's launch plan for x (B, D): K2's tiles, its own chunking (by B
    alone), one value partial a warp; the instance by the widths (the
    compile-time (2, 1, 1), or the general one for any widths whose
    R + C + Rn + 2 weight rows fit its shared memory,
    ``MAX_STACKED_ROWS["value"]``; ``joint``'s pb row is read apart)."""
    Tw = R + C + Rn + 2
    smem = _check_rows("nb_step.value", "value", Tw, R, C, Rn)
    _check_shape(B, D)
    fixed = (R, C, Rn) == VALGRAD_FIXED
    tiles = -(-D // VALGRAD_TILE)
    chunks = _chunks(B, VALUE_CHUNK_ROWS, VALUE_MAX_CHUNKS)
    return TilePlan("fixed" if fixed else "general", VALGRAD_TILE, tiles,
                    chunks, (tiles, chunks), 0, 0,
                    chunks * tiles * VALGRAD_WARPS, 0 if fixed else smem)


def finish_plan(B: int, D: int, R: int, C: int) -> TilePlan:
    """K3's launch plan for B rows of D columns from R + C latents: K2's
    tiles, its own chunking (by B alone), u2's row partials (R, tiles, B)
    and, with more than one chunk, the chunks' partials of fout's
    R + C + 1 rows; the instance by (R, C) (the compile-time (2, 1), or
    the general one for any R + C + 1 <= ``MAX_STACKED_ROWS["finish"]``).
    K3 reads no overdispersion rows: the widths are R and C alone."""
    Tc = R + C + 1
    smem = _check_rows("nb_step.finish", "finish", Tc, R, C)
    _check_shape(B, D)
    fixed = (R, C) == FINISH_FIXED
    tiles = -(-D // VALGRAD_TILE)
    chunks = _chunks(B, FINISH_CHUNK_ROWS, FINISH_MAX_CHUNKS)
    return TilePlan("fixed" if fixed else "general", VALGRAD_TILE, tiles,
                    chunks, (tiles, chunks), R * tiles * B,
                    chunks * Tc * D if chunks > 1 else 0, 0,
                    0 if fixed else smem)


class LsePlan(NamedTuple):
    """One K1 call: its stage-1 instance ("fixed", the compile-time
    (R, C) = (2, 1), or "general", any R >= 1, C >= 0), the D tile width
    and count, the row groups, the stage-1 grid (row groups, tiles), and
    the workspace in floats: one (max, sum) pair per (tile, row)."""
    instance: str
    tile: int
    tiles: int
    groups: int
    grid: tuple[int, int]
    workspace: int


def lse_plan(B: int, D: int, R: int, C: int) -> LsePlan:
    """K1's launch plan for B rows of D logits from R + C latents.  The
    tile and the row groups depend on (B, D) alone, so the order of every
    merge is fixed by the shape; the instance by the widths (the general
    one walks any R + C in slices of 16 stacked rows)."""
    if R < 1 or C < 0:
        raise ValueError(f"nb_step.lse takes R >= 1, C >= 0 stacked rows "
                         f"(R={R}, C={C})")
    _check_shape(B, D)
    tiles = -(-D // LSE_TILE)
    groups = -(-B // LSE_GROUP)
    return LsePlan("fixed" if (R, C) == LSE_FIXED else "general", LSE_TILE,
                   tiles, groups, (groups, tiles), tiles * B * 2)


def _terms(x, ls, nu_pre, depth, include_const: bool, pb=None,
           nu_exp: bool = False) -> torch.Tensor:
    """Per-element NB NLL terms from log-softmax ``ls`` and the
    overdispersion pre-activation (reference nb.hh:453-460, 511-531);
    ``pb`` is added after the log-softmax and ``nu_exp`` decodes
    ``clamp(exp(nu_pre), 0, NU_HI)`` (vmfnb.hh:462-493)."""
    x = x.float()
    if pb is not None:
        ls = ls + pb
    mu = torch.exp(ls) * depth + EPS
    if nu_exp:
        nu = torch.clamp(torch.exp(nu_pre), 0.0, NU_HI) + EPS
    else:
        nu = torch.clamp(_softplus(nu_pre), NU_LO, NU_HI) + EPS
    denom = torch.log(mu + nu)
    terms = (torch.lgamma(nu) - torch.lgamma(nu + x)
             + x * (denom - torch.log(mu)) + nu * (denom - torch.log(nu)))
    if include_const:
        terms = terms + torch.lgamma(x + 1.0)
    return terms


def step_nll_ref(x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n, pb=None,
                 include_const: bool = False, nu_exp: bool = False
                 ) -> torch.Tensor:
    """Plain, differentiable specification of the fused step NLL
    (``xla_step_nll``, nb_step.py:102): ``pb`` an optional (D,) log-bias
    after the log-softmax, ``nu_exp`` the exp-clamp nu decode."""
    h = zm @ wd + c @ wc + bias2
    return _terms(x, torch.log_softmax(h, dim=1), zn @ wn + bias_n, depth,
                  include_const, pb, nu_exp).sum()


def stack_rows(wd, wc, bias2, wn, bias_n, pb=None) -> torch.Tensor:
    """``W = [wd; wc; bias2; wn; bias_n(; pb)]`` (T, D), the host stacking
    of ``_prep`` (nb_step.py:732-745) without the TPU's 8-row and lane
    padding: the ``pb`` row goes last."""
    rows = [wd, wc, bias2.reshape(1, -1), wn, bias_n.reshape(1, -1)]
    if pb is not None:
        rows.append(pb.reshape(1, -1))
    return torch.cat(rows, dim=0).contiguous()


def _pb_row(W, R, C, Rn, joint):
    return W[R + C + Rn + 2] if joint else None


def _h(zc, W, RC):
    return zc @ W[:RC] + W[RC]


def _nupre(zn, W, base, Rn):
    return zn @ W[base:base + Rn] + W[base + Rn]


# ----------------------------------------------------------------------
# plain versions of the four kernels (same inputs, same outputs)
# ----------------------------------------------------------------------

def lse_ref(zc, W, R, C):
    """(B, 1) logsumexp over D of ``h = zc @ W[:R+C] + W[R+C]``."""
    return torch.logsumexp(_h(zc, W, R + C), dim=1, keepdim=True)


def value_ref(x, zc, zn, depth, lse, W, R, C, Rn, with_const: bool,
              joint: bool = False):
    """Scalar NB NLL with ``log_softmax(h) = h - lse``; ``joint``: W's
    last row is the post-softmax log-bias and nu decodes exp-clamp."""
    RC = R + C
    return _terms(x, _h(zc, W, RC) - lse, _nupre(zn, W, RC + 1, Rn), depth,
                  with_const, _pb_row(W, R, C, Rn, joint), joint).sum()


def valgrad_ref(x, zc, zn, depth, lse, W, R, C, Rn, joint: bool = False,
                need_value: bool = False):
    """K2's outputs from autograd of the plain NLL (``include_const``
    off): ``dls = d nll / d h`` with the normaliser ``lse`` held fixed,
    ``dnp = d nll / d nu_pre``, assembled as (gout (T, D), rsum (B, 1),
    u1 (B, R), dzn (B, Rn)); with ``joint`` gout's last row is
    ``d nll / d pb = colsum(dls)``; ``need_value`` appends the NLL
    itself (equal to ``value_ref(..., with_const=False)``)."""
    RC = R + C
    base = RC + 1
    zc, zn, depth, lse, W = (t.detach() for t in (zc, zn, depth, lse, W))
    with torch.enable_grad():
        h = _h(zc, W, RC).requires_grad_()
        npre = _nupre(zn, W, base, Rn).requires_grad_()
        nll = _terms(x, h - lse, npre, depth, False,
                     _pb_row(W, R, C, Rn, joint), joint).sum()
        dls, dnp = torch.autograd.grad(nll, (h, npre))
    rows = [zc.T @ dls, dls.sum(0, keepdim=True), zn.T @ dnp,
            dnp.sum(0, keepdim=True)]
    if joint:
        rows.append(dls.sum(0, keepdim=True))
    out = (torch.cat(rows), dls.sum(1, keepdim=True), dls @ W[:R].T,
           dnp @ W[base:base + Rn].T)
    return (*out, nll.detach()) if need_value else out


def finish_ref(zc, lse, rsum, W, R, C):
    """K3's outputs: ``p = exp(h - lse)``; ``fout = [zc^T (p rsum);
    colsum(p rsum)]`` (R+C+1, D) and ``u2 = p @ wd^T`` (B, R)."""
    RC = R + C
    p = torch.exp(_h(zc, W, RC) - lse)
    pr = p * rsum
    return torch.cat([zc.T @ pr, pr.sum(0, keepdim=True)]), p @ W[:R].T


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------

def _check(what: str, x, named: dict) -> torch.device:
    """Everything the kernels do not take raises here, before any CUDA
    call.  ``named`` maps a name to (tensor, expected shape)."""
    dev = next(iter(named.values()))[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    if x is not None:
        if x.dtype not in _DTYPE_CODE:
            raise TypeError(f"{what}: x must be int8, int16 or float32, "
                            f"got {x.dtype}")
        named = {"x": (x, None), **named}
    for name, (t, shape) in named.items():
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if name != "x" and t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
    return dev


def _dims(zc, W, R, C):
    """(B, D) of the latents zc (B, R + C) and the stacked rows W (T, D);
    each kernel's plan checks the widths."""
    if zc.dim() != 2 or W.dim() != 2 or zc.shape[1] != R + C:
        raise ValueError(f"zc {tuple(zc.shape)} / W {tuple(W.shape)} do not "
                         f"match R={R}, C={C}")
    return zc.shape[0], W.shape[1]


def _lib():
    from . import _cuda

    return _cuda.lib()


def _call(dev, what: str, fn: str, *args) -> None:
    """Launch C entry ``fn`` on ``dev``'s current stream; raise if the
    launch was refused."""
    from . import _cuda

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda.check(getattr(_lib(), fn)(*args, stream), what)


def _f32(shape, dev):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def lse(zc, W, R: int, C: int) -> torch.Tensor:
    """K1: (B, 1) row logsumexp of ``h = zc @ W[:R+C] + W[R+C]``."""
    if zc.device.type == "cpu":
        return lse_ref(zc, W, R, C)
    return _lse_kernel(zc, W, R, C)


def _lse_kernel(zc, W, R, C):
    B, D = _dims(zc, W, R, C)
    plan = lse_plan(B, D, R, C)
    if W.shape[0] < R + C + 1:
        raise ValueError("nb_step.lse: W needs R + C + 1 rows")
    dev = _check("nb_step.lse", None, {"zc": (zc, (B, R + C)),
                                       "W": (W, (W.shape[0], D))})
    ws = _f32((plan.workspace,), dev)
    out = _f32((B, 1), dev)
    _call(dev, "nb_step.lse", "mmvae_nb_lse", zc.data_ptr(), W.data_ptr(),
          B, D, R, C, int(plan.instance == "fixed"), plan.tile,
          ws.data_ptr(), plan.workspace, out.data_ptr())
    lse.launches += 1
    return out


lse.launches = 0


def _row_inputs(what, x, zc, zn, depth, norm, W, R, C, Rn, joint):
    B, D = _dims(zc, W, R, C)
    if tuple(x.shape) != (B, D):
        raise ValueError(f"{what}: x has shape {tuple(x.shape)}, expected "
                         f"{(B, D)}")
    dev = _check(what, x, {
        "zc": (zc, (B, R + C)), "zn": (zn, (B, Rn)), "depth": (depth, (B, 1)),
        "lse": (norm, (B, 1)), "W": (W, (R + C + Rn + 2 + joint, D))})
    return B, D, dev


def value(x, zc, zn, depth, norm, W, R: int, C: int, Rn: int,
          with_const: bool = True, joint: bool = False) -> torch.Tensor:
    """K6: scalar NB NLL given the row normaliser ``norm`` (reporting
    pass); ``with_const`` adds ``lgamma(x + 1)``; ``joint`` the joint
    model's variant (W's last row is ``pb``, nu decodes exp-clamp)."""
    if x.device.type == "cpu":
        return value_ref(x, zc, zn, depth, norm, W, R, C, Rn, with_const,
                         joint)
    return _value_kernel(x, zc, zn, depth, norm, W, R, C, Rn, with_const,
                         joint)


def _value_kernel(x, zc, zn, depth, norm, W, R, C, Rn, with_const,
                  joint=False):
    joint = bool(joint)
    B, D, dev = _row_inputs("nb_step.value", x, zc, zn, depth, norm, W, R,
                            C, Rn, joint)
    plan = value_plan(B, D, R, C, Rn, joint)
    ws = _f32((plan.workspace,), dev)
    out = _f32((), dev)
    _call(dev, "nb_step.value", "mmvae_nb_value", x.data_ptr(),
          _DTYPE_CODE[x.dtype], zc.data_ptr(), zn.data_ptr(),
          depth.data_ptr(), norm.data_ptr(), W.data_ptr(), B, D, R, C, Rn,
          int(with_const), int(joint), int(plan.instance == "fixed"),
          plan.tile, plan.chunks, ws.data_ptr(), plan.workspace,
          out.data_ptr())
    if joint:
        value.joint_launches += 1
    else:
        value.launches += 1
    return out


value.launches = 0
value.joint_launches = 0


def valgrad(x, zc, zn, depth, norm, W, R: int, C: int, Rn: int,
            joint: bool = False, need_value: bool = False):
    """K2: (gout (T, D), rsum (B, 1), u1 (B, R), dzn (B, Rn)) of the NLL
    without ``lgamma(x + 1)``, normaliser ``norm`` held fixed; ``joint``
    the joint model's variant (gout's last row is the ``pb`` gradient);
    ``need_value`` (K2v, with ``joint`` K2pv) appends that NLL as a 0-d
    tensor."""
    if x.device.type == "cpu":
        return valgrad_ref(x, zc, zn, depth, norm, W, R, C, Rn, joint,
                           need_value)
    return _valgrad_kernel(x, zc, zn, depth, norm, W, R, C, Rn, joint,
                           need_value)


def _valgrad_kernel(x, zc, zn, depth, norm, W, R, C, Rn, joint=False,
                    need_value=False):
    joint = bool(joint)
    B, D, dev = _row_inputs("nb_step.valgrad", x, zc, zn, depth, norm, W,
                            R, C, Rn, joint)
    plan = valgrad_plan(B, D, R, C, Rn, joint, need_value)
    ws = _f32((plan.workspace,), dev)
    gout = _f32((R + C + Rn + 2 + joint, D), dev)
    rows = _f32((B, 1 + R + Rn), dev)
    nll = _f32((), dev)
    _call(dev, "nb_step.valgrad", "mmvae_nb_valgrad", x.data_ptr(),
          _DTYPE_CODE[x.dtype], zc.data_ptr(), zn.data_ptr(),
          depth.data_ptr(), norm.data_ptr(), W.data_ptr(), B, D, R, C, Rn,
          int(joint), int(bool(need_value)), int(plan.instance == "fixed"),
          plan.tile, plan.chunks, gout.data_ptr(), ws.data_ptr(),
          plan.workspace, rows.data_ptr(), nll.data_ptr())
    if joint and need_value:
        valgrad.joint_value_launches += 1
    elif joint:
        valgrad.joint_launches += 1
    elif need_value:
        valgrad.value_launches += 1
    else:
        valgrad.launches += 1
    out = (gout, rows[:, :1], rows[:, 1:1 + R], rows[:, 1 + R:])
    return (*out, nll) if need_value else out


valgrad.launches = 0
valgrad.joint_launches = 0
valgrad.value_launches = 0
valgrad.joint_value_launches = 0


def finish(zc, norm, rsum, W, R: int, C: int):
    """K3: (fout (R+C+1, D), u2 (B, R)) — the softmax-coupling terms,
    recomputing ``p = softmax(h)`` from the latents (no read of x)."""
    if zc.device.type == "cpu":
        return finish_ref(zc, norm, rsum, W, R, C)
    return _finish_kernel(zc, norm, rsum, W, R, C)


def _finish_kernel(zc, norm, rsum, W, R, C):
    B, D = _dims(zc, W, R, C)
    plan = finish_plan(B, D, R, C)
    rsum = rsum.contiguous()
    dev = _check("nb_step.finish", None, {
        "zc": (zc, (B, R + C)), "lse": (norm, (B, 1)),
        "rsum": (rsum, (B, 1)), "W": (W, (W.shape[0], D))})
    if W.shape[0] < R + C + 1:
        raise ValueError("nb_step.finish: W needs R + C + 1 rows")
    ws = _f32((plan.workspace,), dev)
    fout = _f32((R + C + 1, D), dev)
    u2 = _f32((B, R), dev)
    _call(dev, "nb_step.finish", "mmvae_nb_finish", zc.data_ptr(),
          norm.data_ptr(), rsum.data_ptr(), W.data_ptr(), B, D, R, C,
          int(plan.instance == "fixed"), plan.tile, plan.chunks,
          fout.data_ptr(), ws.data_ptr(), plan.workspace, u2.data_ptr())
    finish.launches += 1
    return fout, u2


finish.launches = 0


# ----------------------------------------------------------------------
# public ops
# ----------------------------------------------------------------------

def _operands(zm, c, zn, depth, wd, wc, bias2, wn, bias_n, pb=None):
    zc = torch.cat([zm, c], dim=1).contiguous()
    W = stack_rows(wd, wc, bias2, wn, bias_n, pb)
    return zc, zn.contiguous(), depth.contiguous(), W


def nb_step_report(x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n,
                   include_const: bool = True, pb=None) -> torch.Tensor:
    """Reporting-pass NLL (value only, no gradient; reference
    mmvae_alg.hh:277-285): K1 then K6.  With ``pb``, the joint model's NB
    half (``nb_step_report(pb=pb, nu_exp=True)``, nb_step.py:765-788):
    the post-softmax log-bias and the exp-clamp nu decode."""
    R, C, Rn = zm.shape[1], c.shape[1], zn.shape[1]
    with torch.no_grad():
        zc, zn, depth, W = _operands(zm, c, zn, depth, wd, wc, bias2, wn,
                                     bias_n, pb)
        return value(x, zc, zn, depth, lse(zc, W, R, C), W, R, C, Rn,
                     include_const, pb is not None)


def _boot_fwd_impl(x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n, pb,
                   need_value: bool = False):
    """K1 -> K2 -> K3 and the gradient assembly of the boot step
    (nb_step.py:801-868): (the NLL without ``lgamma(x + 1)`` when
    ``need_value``, else None; the cotangents of (zm, zn, depth, wd, wc,
    bias2, wn, bias_n) and, with ``pb``, of ``pb``)."""
    R, C, Rn = zm.shape[1], c.shape[1], zn.shape[1]
    zc, znc, dep, W = _operands(zm, c, zn, depth, wd, wc, bias2, wn, bias_n,
                                pb)
    norm = lse(zc, W, R, C)
    gout, rsum, u1, dzn, *nll = valgrad(x, zc, znc, dep, norm, W, R, C, Rn,
                                        pb is not None, need_value)
    # d nll / d depth = rowsum(dmu * pe) = rsum / depth exactly; at
    # depth == 0 the 0/0 is zeroed (depth >= 0 at every call site)
    dd = torch.where(dep > 0, rsum / torch.clamp_min(dep, 1e-30),
                     torch.zeros_like(rsum))
    # K3 recomputes the plain p: the coupling term has no exp(pb)
    fout, u2 = finish(zc, norm, rsum, W, R, C)
    # dh = dls - p * rowsum(dls): gout holds the dls contractions,
    # fout the p * rowsum ones
    gw = gout[:R + C + 1] - fout
    base = R + C + 1
    res = [u1 - rsum * u2, dzn, dd, gw[:R], gw[R:R + C], gw[R + C],
           gout[base:base + Rn], gout[base + Rn]]
    if pb is not None:
        # pb sits outside the log-softmax: no coupling subtraction
        res.append(gout[base + Rn + 1])
    return (nll[0] if need_value else None), res


class _Boot(torch.autograd.Function):
    """Boot-step NLL: the forward computes every gradient in one pass
    (K1 -> K2 -> K3) and saves it; the backward scales.  The primal is
    the NLL with ``need_value`` (K2v, K2pv), else 0.0."""

    @staticmethod
    def forward(ctx, x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n, pb,
                need_value):
        ctx.joint = pb is not None
        nll, res = _boot_fwd_impl(x, zm, c, zn, depth, wd, wc, bias2, wn,
                                  bias_n, pb, need_value)
        ctx.save_for_backward(*res)
        return nll if need_value else zm.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        d_zm, d_zn, d_dep, d_wd, d_wc, d_b2, d_wn, d_bn = saved[:8]
        d_pb = g * saved[8] if ctx.joint else None
        return (None, g * d_zm, None, g * d_zn, g * d_dep, g * d_wd,
                g * d_wc, g * d_b2, g * d_wn, g * d_bn, d_pb, None)


def nb_step_boot(x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n
                 ) -> torch.Tensor:
    """Boot-step NLL without ``lgamma(x + 1)`` (nb_step.py:792), its
    value from K2v in the same pass as the gradient, differentiable in
    (zm, zn, depth, wd, wc, bias2, wn, bias_n); x and c are data."""
    return _Boot.apply(x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n, None,
                       True)


def nb_step_boot_gradonly(x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n
                          ) -> torch.Tensor:
    """Boot-step NLL (no ``lgamma(x + 1)``) whose primal is 0.0 and whose
    gradient in (zm, zn, depth, wd, wc, bias2, wn, bias_n) is the NLL's;
    x and c are data.  Never use it where the loss value is read."""
    return _Boot.apply(x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n, None,
                       False)


def nb_step_boot_joint(x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n, pb
                       ) -> torch.Tensor:
    """:func:`nb_step_boot` for the joint model's NB half (nb_step.py:901):
    ``pb`` (D,) is the post-softmax log-bias and nu decodes as
    ``clamp(exp(.), 0, NU_HI)``; the value comes from K2pv in the same
    pass as the gradient, which also reaches ``pb``."""
    return _Boot.apply(x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n, pb,
                       True)


def nb_step_boot_joint_gradonly(x, zm, c, zn, depth, wd, wc, bias2, wn,
                                bias_n, pb) -> torch.Tensor:
    """:func:`nb_step_boot_gradonly` for the joint model's NB half
    (nb_step.py:991-1005): ``pb`` (D,) is the post-softmax log-bias and
    nu decodes as ``clamp(exp(.), 0, NU_HI)``; the gradient also reaches
    ``pb``.  Primal 0.0: never use it where the loss value is read."""
    return _Boot.apply(x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n, pb,
                       False)
