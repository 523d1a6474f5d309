"""Fused count-encoder contraction: ``(log1p(x) @ WL^T, x @ WX^T)`` and,
optionally, the row stats ``[sum L, sum L^2, sum L*f, sum L^2*f]``
(``L = log1p(x)``, ``f`` an optional feature filter) the vMF+NB models'
row norms come from.

Port of ``mmvae_tpu/ops/enc_kernel.py`` (``want_stats`` and the labeled
mixture's ``filt`` included).  :func:`count_encode` is a
``torch.autograd.Function`` over two kernels, each with its plain
PyTorch version beside it:

- forward (K4; K4s with ``want_stats``; K4f with ``want_stats`` and
  ``filt``): :func:`count_encode_ref`, or the CUDA kernel
  ``csrc/count_encode.cu``, which reads the integer counts once and forms
  ``log1p(x)`` in registers, one block per (D tile, 32 rows), and adds
  the tiles' partials in a fixed order in a second stage (launch plan:
  :func:`fwd_plan`); the stats take no gradient;
- backward (K5): :func:`count_encode_bwd` — ``dWL = g1^T log1p(x)``,
  ``dWX = g2^T x`` — :func:`count_encode_bwd_ref`, or the CUDA kernel
  ``csrc/count_encode_bwd.cu``, one block per (D tile, row chunk) with
  the chunk's cotangents in shared memory and 2 columns a thread, and a
  second stage that adds the chunks in a fixed order when there is more
  than one (launch plan: :func:`bwd_plan`).

Both run in float32 (the JAX package's bf16 operand views emulate the
TPU's DEFAULT matmul precision and are not ported).  Each picks by where
``x`` lies: a CPU tensor goes to the plain version; a CUDA tensor
launches the kernel or raises — there is no fallback on the card.
``count_encode.launches`` (no stats), ``count_encode.stats_launches``
(the stats instance), ``count_encode.filt_launches`` (the filtered-stats
instance) and ``count_encode_bwd.launches`` count kernel launches.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_DTYPE_CODE = {torch.float32: 0, torch.int16: 1, torch.int8: 2}
# weight rows a launch keeps in registers: the backward (K5) <= 16
# stacked rows, the forward <= 16 log1p (WL) rows and <= 4 raw (WX) rows
MAX_ROWS_PER_LAUNCH = 16
MAX_X_ROWS_PER_LAUNCH = 4
FWD_TILE = 256  # D columns of a forward block's tile: kTile of count_encode.cu
# K5's launch plan (csrc/count_encode_bwd.cu): a block's D tile (kTile:
# 32 lanes x 2 columns), the widths of its compile-time instances (the
# trainers' (log1p rows, raw rows)), and the row chunking: ceil(M / 128)
# chunks, at most 8
BWD_TILE = 64
BWD_FIXED = ((2, 2), (5, 3), (12, 3))
BWD_CHUNK_ROWS = 128
BWD_MAX_CHUNKS = 8


class FwdLaunch(NamedTuple):
    """One forward launch: WL rows [l0, l1) and WX rows [x0, x1), whether
    it writes the stats (and reads the filter), and its workspace
    ``(tiles, M, width)`` of per-tile row partials."""
    l0: int
    l1: int
    x0: int
    x1: int
    stats: bool
    filt: bool
    tiles: int
    width: int

    def workspace(self, M: int) -> tuple[int, int, int]:
        return (self.tiles, M, self.width)


def fwd_plan(D: int, r1: int, r2: int, want_stats: bool = False,
             filt: bool = False) -> list[FwdLaunch]:
    """The forward kernel's launches for x (M, D) against r1 log1p rows
    WL and r2 raw rows WX: launch i takes WL rows [16 i, 16 i + 16) and WX
    rows [4 i, 4 i + 4); the first alone writes the stats and reads the
    filter.  A launch tiles D in ``FWD_TILE`` columns, so its tiles and
    partials depend on D and the instance only, never on M or the dtype:
    the fixed tiling is what keeps a row's result invariant to how rows
    are grouped into launches."""
    tiles = -(-D // FWD_TILE)
    n = max(-(-r1 // MAX_ROWS_PER_LAUNCH), -(-r2 // MAX_X_ROWS_PER_LAUNCH))
    out = []
    for i in range(n):
        l0 = min(i * MAX_ROWS_PER_LAUNCH, r1)
        l1 = min(l0 + MAX_ROWS_PER_LAUNCH, r1)
        x0 = min(i * MAX_X_ROWS_PER_LAUNCH, r2)
        x1 = min(x0 + MAX_X_ROWS_PER_LAUNCH, r2)
        stats, fl = bool(want_stats) and i == 0, bool(filt) and i == 0
        out.append(FwdLaunch(l0, l1, x0, x1, stats, fl, tiles,
                             l1 - l0 + x1 - x0
                             + (4 if fl else 2 if stats else 0)))
    return out


class BwdPlan(NamedTuple):
    """One K5 launch: its stage-1 instance ("fixed", one of the
    compile-time widths ``BWD_FIXED``, or "general"), the D tile width
    and count, the row chunks, the stage-1 grid (tiles, chunks), and the
    workspace in floats: the chunks' column partials (chunks, r1 + r2, D)
    when there is more than one chunk (stage 2 adds them), else none."""
    instance: str
    tile: int
    tiles: int
    chunks: int
    grid: tuple[int, int]
    workspace: int


def bwd_plan(M: int, D: int, r1: int, r2: int) -> BwdPlan:
    """K5's launch plan for x (M, D) against r1 log1p and r2 raw
    cotangent columns (r1 + r2 <= ``MAX_ROWS_PER_LAUNCH``).  The tile and
    the chunking depend on (M, D) alone, never on the widths or the
    dtype, so the order of every sum is fixed by the shape; the instance
    by the widths."""
    if r1 < 0 or r2 < 0 or not 1 <= r1 + r2 <= MAX_ROWS_PER_LAUNCH:
        raise ValueError(f"count_encode_bwd: a launch takes 1 to "
                         f"{MAX_ROWS_PER_LAUNCH} cotangent columns "
                         f"(r1={r1}, r2={r2})")
    if M < 1 or D < 1:
        raise ValueError(f"count_encode_bwd: empty operands (M={M}, D={D})")
    tiles = -(-D // BWD_TILE)
    chunks = min(-(-M // BWD_CHUNK_ROWS), BWD_MAX_CHUNKS)
    return BwdPlan("fixed" if (r1, r2) in BWD_FIXED else "general",
                   BWD_TILE, tiles, chunks, (tiles, chunks),
                   chunks * (r1 + r2) * D if chunks > 1 else 0)


def bwd_groups(r1: int, r2: int) -> list[tuple[int, int, int, int]]:
    """K5's launches for r1 log1p and r2 raw cotangent columns: slots
    [g0, g0 + 16) of the stack [g1 | g2] each, as (l0, l1, x0, x1): g1
    columns [l0, l1) and g2 columns [x0, x1)."""
    out = []
    for g0 in range(0, r1 + r2, MAX_ROWS_PER_LAUNCH):
        g1e = min(g0 + MAX_ROWS_PER_LAUNCH, r1 + r2)
        out.append((min(g0, r1), min(g1e, r1), max(g0 - r1, 0),
                    max(g1e - r1, 0)))
    return out


def _check_filt(filt, want_stats: bool):
    if filt is not None and not want_stats:
        raise ValueError("count_encode: filt only enters the row stats; "
                         "pass want_stats=True")


def count_encode_ref(x: torch.Tensor, WL: torch.Tensor,
                     WX: torch.Tensor | None = None,
                     want_stats: bool = False,
                     filt: torch.Tensor | None = None) -> tuple:
    """Plain version: float32 ``(log1p(x) @ WL^T, x @ WX^T)``, and with
    ``want_stats`` the (M, 4) row stats ``[sum L, sum L^2, sum L*f,
    sum L^2*f]`` of ``L = log1p(x)`` (``_xla_encode``; without ``filt``
    the filtered pair is the plain one).  It computes in WL's dtype:
    float32 on every path, float64 where a check needs an anchor."""
    _check_filt(filt, want_stats)
    xf = x.to(WL.dtype)
    L = torch.log1p(xf)
    hL = L @ WL.T
    hX = xf.new_empty((x.shape[0], 0)) if WX is None else xf @ WX.T
    if not want_stats:
        return hL, hX
    with torch.no_grad():
        s, ssq = L.sum(1), (L * L).sum(1)
        if filt is None:
            sf, ssqf = s, ssq
        else:
            Lm = L * filt.reshape(1, -1)
            sf, ssqf = Lm.sum(1), (Lm * L).sum(1)
        stats = torch.stack([s, ssq, sf, ssqf], dim=1)
    return hL, hX, stats


def count_encode_bwd_ref(x: torch.Tensor, g1: torch.Tensor,
                         g2: torch.Tensor | None
                         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain version of the backward: the VJP of :func:`count_encode_ref`
    in (WL, WX), ``(g1^T log1p(x), g2^T x)``, in g1's dtype (as the
    forward computes in WL's)."""
    xf = x.to(g1.dtype)
    return g1.T @ torch.log1p(xf), (None if g2 is None else g2.T @ xf)


class _CountEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, WL, WX, want_stats, filt):
        ctx.save_for_backward(x)
        ctx.has_wx = WX is not None
        if x.device.type == "cpu":
            out = count_encode_ref(x, WL, WX, want_stats, filt)
        else:
            out = _kernel_route(x, WL, WX, want_stats, filt)
        if want_stats:
            ctx.mark_non_differentiable(out[2])
        return out

    @staticmethod
    def backward(ctx, gL, gX, *_g_stats):
        (x,) = ctx.saved_tensors
        if not ctx.needs_input_grad[1] and not ctx.needs_input_grad[2]:
            return None, None, None, None, None
        dWL, dWX = count_encode_bwd(x, gL, gX if ctx.has_wx else None)
        return None, dWL, dWX, None, None


def count_encode(x: torch.Tensor, WL: torch.Tensor,
                 WX: torch.Tensor | None = None,
                 want_stats: bool = False,
                 filt: torch.Tensor | None = None) -> tuple:
    """``(hL, hX) = (log1p(x) @ WL^T, float(x) @ WX^T)`` in float32,
    differentiable in WL and WX (backward: :func:`count_encode_bwd`).
    With ``want_stats`` a third output, the (M, 4) row stats
    ``[sum L, sum L^2, sum L*f, sum L^2*f]`` of ``L = log1p(x)`` in
    float32, which carry no gradient.

    x    : (M, D) counts, int8 / int16 / float32 — data, no gradient
    WL   : (r1, D) float32 rows contracted against log1p(x)
    WX   : (r2, D) float32 rows contracted against x, or None (r2 = 0)
    filt : optional (D,) or (1, D) float32 filter of the stats' second
           pair (the labeled mixture's feature mask; with ``want_stats``
           only); without it the second pair equals the first
    """
    _check_filt(filt, want_stats)
    return _CountEncode.apply(x, WL, WX, bool(want_stats), filt)


count_encode.launches = 0
count_encode.stats_launches = 0
count_encode.filt_launches = 0


def count_encode_bwd(x: torch.Tensor, g1: torch.Tensor,
                     g2: torch.Tensor | None
                     ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``(dWL, dWX) = (g1^T log1p(x), g2^T x)``: the weight gradient of
    :func:`count_encode` for row cotangents g1 (M, r1), g2 (M, r2)."""
    if x.device.type == "cpu":
        return count_encode_bwd_ref(x, g1, g2)
    return _bwd_kernel_route(x, g1, g2)


count_encode_bwd.launches = 0


def _check_kernel_args(x, WL, WX, filt=None) -> torch.Tensor:
    """Everything the kernel does not take raises here, before any CUDA
    call; returns WX as a (r2, D) tensor."""
    if torch.is_grad_enabled() and (
            WL.requires_grad or (WX is not None and WX.requires_grad)):
        raise NotImplementedError(
            "count_encode: the raw kernel route records no graph; call "
            "count_encode(), whose backward is the K5 kernel "
            "(count_encode_bwd)")
    if x.dim() != 2 or WL.dim() != 2:
        raise ValueError(f"count_encode: x and WL must be 2-D, got "
                         f"{tuple(x.shape)} and {tuple(WL.shape)}")
    if WX is None:
        WX = WL.new_empty((0, WL.shape[1]))
    if WX.dim() != 2:
        raise ValueError(f"count_encode: WX must be 2-D, got "
                         f"{tuple(WX.shape)}")
    D = x.shape[1]
    if WL.shape[1] != D or WX.shape[1] != D:
        raise ValueError(f"count_encode: weight rows must have D={D} "
                         f"columns, got {tuple(WL.shape)} and "
                         f"{tuple(WX.shape)}")
    if WL.shape[0] + WX.shape[0] < 1:
        raise ValueError("count_encode: needs at least one weight row")
    if filt is not None and filt.numel() != D:
        raise ValueError(f"count_encode: filt must have D={D} elements, "
                         f"got {tuple(filt.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"count_encode: x must be int8, int16 or float32, "
                        f"got {x.dtype}")
    named = [("x", x), ("WL", WL), ("WX", WX)]
    if filt is not None:
        named.append(("filt", filt))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"count_encode: {name} is on {t.device}, "
                             f"x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"count_encode: {name} must be contiguous")
    for name, t in named[1:]:
        if t.dtype != torch.float32:
            raise TypeError(f"count_encode: {name} must be float32, got "
                            f"{t.dtype}")
    return WX


def _kernel_route(x, WL, WX, want_stats=False, filt=None):
    _check_filt(filt, want_stats)
    WX = _check_kernel_args(x, WL, WX, filt)
    if x.device.type != "cuda":
        raise ValueError(f"count_encode: no kernel for device {x.device}")
    from . import _cuda

    lib = _cuda.lib()
    M, D = x.shape
    r1, r2 = WL.shape[0], WX.shape[0]
    hL = torch.empty((M, r1), dtype=torch.float32, device=x.device)
    hX = torch.empty((M, r2), dtype=torch.float32, device=x.device)
    st = (torch.empty((M, 4), dtype=torch.float32, device=x.device)
          if want_stats else None)
    out = (hL, hX, st) if want_stats else (hL, hX)
    if M == 0:
        return out
    plan = fwd_plan(D, r1, r2, want_stats, filt is not None)
    # one workspace, sized for the largest launch, serves them all in turn
    ws = torch.empty((max(math.prod(p.workspace(M)) for p in plan),),
                     dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for p in plan:
            rc = lib.mmvae_count_encode_fwd(
                x.data_ptr(), _DTYPE_CODE[x.dtype], M, D,
                WL.data_ptr() + 4 * p.l0 * D, p.l1 - p.l0,
                WX.data_ptr() + 4 * p.x0 * D, p.x1 - p.x0,
                hL.data_ptr() + 4 * p.l0, r1,
                hX.data_ptr() + 4 * p.x0, r2,
                st.data_ptr() if p.stats else None,
                filt.data_ptr() if p.filt else None,
                ws.data_ptr(), ws.numel(), stream,
            )
            _cuda.check(rc, "count_encode")
            if p.filt:
                count_encode.filt_launches += 1
            elif p.stats:
                count_encode.stats_launches += 1
            else:
                count_encode.launches += 1
    return out


def _bwd_kernel_route(x, g1, g2):
    """K5 launches (``bwd_groups``: one per group of <= 16 stacked
    cotangent columns [g1 | g2], each on its ``bwd_plan``); everything
    the kernel does not take raises first."""
    g1 = g1.contiguous()
    g2 = None if g2 is None else g2.contiguous()
    if x.dim() != 2 or g1.dim() != 2 or (g2 is not None and g2.dim() != 2):
        raise ValueError("count_encode_bwd: x, g1 and g2 must be 2-D")
    M, D = x.shape
    r1 = g1.shape[1]
    r2 = 0 if g2 is None else g2.shape[1]
    if g1.shape[0] != M or (g2 is not None and g2.shape[0] != M):
        raise ValueError(f"count_encode_bwd: cotangents need {M} rows")
    if M < 1 or D < 1 or r1 + r2 < 1:
        raise ValueError(f"count_encode_bwd: empty operands (M={M}, "
                         f"D={D}, r1={r1}, r2={r2})")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"count_encode_bwd: x must be int8, int16 or "
                        f"float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("count_encode_bwd: x must be contiguous")
    for name, t in (("g1", g1), ("g2", g2)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"count_encode_bwd: {name} must be float32")
        if t.device != x.device:
            raise ValueError(f"count_encode_bwd: {name} is on {t.device}, "
                             f"x on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"count_encode_bwd: no kernel for {x.device}")
    from . import _cuda

    lib = _cuda.lib()
    dWL = torch.empty((r1, D), dtype=torch.float32, device=x.device)
    dWX = (None if g2 is None
           else torch.empty((r2, D), dtype=torch.float32, device=x.device))
    g2p = 0 if g2 is None else g2.data_ptr()
    dxp = 0 if dWX is None else dWX.data_ptr()
    groups = bwd_groups(r1, r2)
    plans = [bwd_plan(M, D, l1 - l0, x1 - x0) for l0, l1, x0, x1 in groups]
    # one workspace, sized for the largest launch, serves them all in
    # turn; a plan with one chunk needs none
    n_ws = max(p.workspace for p in plans)
    ws = (torch.empty((n_ws,), dtype=torch.float32, device=x.device)
          if n_ws else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for (l0, l1, x0, x1), p in zip(groups, plans):
            rc = lib.mmvae_count_encode_bwd(
                x.data_ptr(), _DTYPE_CODE[x.dtype], M, D,
                g1.data_ptr() + 4 * l0, l1 - l0, r1,
                g2p + 4 * x0, x1 - x0, r2,
                int(p.instance == "fixed"), p.tile, p.chunks,
                dWL.data_ptr() + 4 * l0 * D, dxp + 4 * x0 * D,
                None if ws is None else ws.data_ptr(), n_ws, stream)
            _cuda.check(rc, "count_encode_bwd")
            count_encode_bwd.launches += 1
    return dWL, dWX
