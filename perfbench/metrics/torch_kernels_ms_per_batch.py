"""``torch_kernels_ms_per_batch`` (ms, packed batch step): device
milliseconds a batch step in kernels and copies that are not the port's
hand-written ones (PyTorch's own elementwise, reduction and product
kernels inside the packed step and the optimizer), NCCL's counted apart.
Moves ``train_cells_per_s``."""


def read(r):
    s = r.kernel_s("torch")
    if s <= 0 or r.batches <= 0:
        return None
    return 1e3 * s / r.batches
