"""``step_mfu`` (%, packed batch step): the model's matrix-product FLOPs
a batch step (``flops.py``, from the configuration's widths) times the
batch steps a second of the untraced window, over the card's float32
peak outside the tensor cores (TF32 is off).  The same count whatever
implements the step, so it bounds what a kernel's roofline can claim.
Read only where the trace saw the card work.  Moves
``train_cells_per_s``."""

from perfbench.flops import PEAK_F32


def read(r):
    fl = r.extra.get("flops_per_batch")
    rate = r.extra.get("batches_per_s")
    if not fl or not rate or r.busy_s <= 0:
        return None
    return 100.0 * fl * rate / PEAK_F32
