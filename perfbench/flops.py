"""The model's matrix-product FLOPs a training batch step, from the
configuration's widths alone.

A product of an (m, k) matrix by a (k, n) matrix counts ``2 m k n``.  A
model family lists its layers' products in ``models/<model>.py``
(``matmuls(cfg)``: the (k, n) of each layer applied to the batch's
rows), so the count is the same whatever implements the step: a fused
kernel, a folded standardization or a plain chain of products.

A batch step is the reporting pass (forward only) and ``nboot``
gradient passes, each a forward and a backward; the backward is counted
as twice the forward (the products' gradients with respect to their two
operands).  So a batch step counts ``forward * (1 + 3 nboot)``.
"""

from __future__ import annotations

# H100 SXM, NVIDIA's data sheet (700 W): float32 outside the tensor
# cores.  TF32 is off in the program and the reference, so its 495
# TFLOP/s is not the peak of this work.  Copied from chip_smoke.py.
PEAK_F32 = 67e12


def forward_flops(matmuls: list, rows: int) -> float:
    """2 m k n summed over the layers' (k, n) at m = ``rows``."""
    return float(sum(2 * rows * k * n for k, n in matmuls))


def step_flops(matmuls: list, rows: int, nboot: int) -> float:
    """The products of one batch step: the reporting pass and ``nboot``
    forward-and-backward passes."""
    return forward_flops(matmuls, rows) * (1 + 3 * nboot)
