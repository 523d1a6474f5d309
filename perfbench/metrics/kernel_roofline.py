"""``kernel_roofline`` (%, hand-written kernels): the sum over the
port's hand-written kernels' calls in the traced sub-window of each
call's least time (``roofline.py``: the larger of its bytes over the
HBM rate and its operations over the float32 rate, from its shape), over
their summed device time.  A call is counted by the program's launch
counter that booked it; a kernel with device time whose counters the
cell's table does not know is named on standard error and left out of
both sums.  Moves ``train_cells_per_s``."""

import sys

from perfbench.roofline import least_s
from perfbench.trace import COUNTER_KERNEL


def read(r):
    table = r.extra.get("kernel_calls") or {}
    least, known = 0.0, set()
    for counter, n in r.counters.items():
        if counter not in table:
            continue
        kernel, shape = table[counter]
        least += n * least_s(kernel, shape)[0]
        known.add(kernel)
    booked = {COUNTER_KERNEL.get(c.split(".")[0]) for c in r.counters}
    for kernel, s in sorted(r.by_kernel.items()):
        if kernel in ("torch", "nccl") or kernel in known:
            continue
        print(f"[perfbench] kernel_roofline: {kernel} ({s * 1e3:.4f} ms"
              f"{', booked' if kernel in booked else ''}) is not in this "
              f"cell's table; left out", file=sys.stderr)
    device = sum(r.by_kernel.get(k, 0.0) for k in known)
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device
