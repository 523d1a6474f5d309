"""Fused count-encoder contraction: ``(log1p(x) @ WL^T, x @ WX^T)``.

Port of ``mmvae_tpu/ops/enc_kernel.py`` (forward, without the row stats
that only the vMF-side models use).  Two versions of one function:

- :func:`count_encode_ref`, the plain PyTorch version, in float32 (the
  JAX package's bf16 operand views emulate the TPU's DEFAULT matmul
  precision and are not ported);
- the CUDA kernel ``csrc/count_encode.cu``, which reads the integer
  counts once and forms ``log1p(x)`` in registers.

:func:`count_encode` picks by where ``x`` lies: a CPU tensor goes to the
plain version; a CUDA tensor launches the kernel or raises — there is no
fallback on the card.  ``count_encode.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

_DTYPE_CODE = {torch.float32: 0, torch.int16: 1, torch.int8: 2}
MAX_ROWS_PER_LAUNCH = 16  # weight rows the kernel keeps in registers


def count_encode_ref(x: torch.Tensor, WL: torch.Tensor,
                     WX: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: float32 ``(log1p(x) @ WL^T, x @ WX^T)``."""
    xf = x.float()
    hL = torch.log1p(xf) @ WL.T
    if WX is None:
        return hL, xf.new_empty((x.shape[0], 0))
    return hL, xf @ WX.T


def count_encode(x: torch.Tensor, WL: torch.Tensor,
                 WX: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hL, hX) = (log1p(x) @ WL^T, float(x) @ WX^T)`` in float32.

    x  : (M, D) counts, int8 / int16 / float32 — data, no gradient
    WL : (r1, D) float32 rows contracted against log1p(x)
    WX : (r2, D) float32 rows contracted against x, or None (r2 = 0)
    """
    if x.device.type == "cpu":
        return count_encode_ref(x, WL, WX)
    return _kernel_route(x, WL, WX)


count_encode.launches = 0


def _check_kernel_args(x, WL, WX) -> torch.Tensor:
    """Everything the kernel does not take raises here, before any CUDA
    call; returns WX as a (r2, D) tensor."""
    if torch.is_grad_enabled() and (
            WL.requires_grad or (WX is not None and WX.requires_grad)):
        raise NotImplementedError(
            "count_encode: backward (K5) not ported yet; call under "
            "torch.no_grad() / torch.inference_mode()")
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
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"count_encode: x must be int8, int16 or float32, "
                        f"got {x.dtype}")
    for name, t in (("x", x), ("WL", WL), ("WX", WX)):
        if t.device != x.device:
            raise ValueError(f"count_encode: {name} is on {t.device}, "
                             f"x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"count_encode: {name} must be contiguous")
    for name, t in (("WL", WL), ("WX", WX)):
        if t.dtype != torch.float32:
            raise TypeError(f"count_encode: {name} must be float32, got "
                            f"{t.dtype}")
    return WX


def _kernel_route(x, WL, WX):
    WX = _check_kernel_args(x, WL, WX)
    if x.device.type != "cuda":
        raise ValueError(f"count_encode: no kernel for device {x.device}")
    from . import _cuda

    lib = _cuda.lib()
    M, D = x.shape
    r1, r2 = WL.shape[0], WX.shape[0]
    hL = torch.empty((M, r1), dtype=torch.float32, device=x.device)
    hX = torch.empty((M, r2), dtype=torch.float32, device=x.device)
    if M == 0:
        return hL, hX
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # one launch per group of <= 16 stacked rows [WL; WX]
        for g0 in range(0, r1 + r2, MAX_ROWS_PER_LAUNCH):
            g1 = min(g0 + MAX_ROWS_PER_LAUNCH, r1 + r2)
            l0, l1 = min(g0, r1), min(g1, r1)
            x0, x1 = max(g0 - r1, 0), max(g1 - r1, 0)
            rc = lib.mmvae_count_encode_fwd(
                x.data_ptr(), _DTYPE_CODE[x.dtype], M, D,
                WL.data_ptr() + 4 * l0 * D, l1 - l0,
                WX.data_ptr() + 4 * x0 * D, x1 - x0,
                hL.data_ptr() + 4 * l0, r1,
                hX.data_ptr() + 4 * x0, r2,
                stream,
            )
            _cuda.check(rc, "count_encode")
            count_encode.launches += 1
    return hL, hX
