"""Profile the packed fast-step epoch and print time by kernel: the port
of ``benchmarks/trace_step.py``.

    python -m mmvae_tpu_torch.benchmarks.trace_step [nb|vmf|joint|mixture]
        [D] [S] [B] [--device cuda] [--out DIR]

Builds the model at its default architecture on its packed fast step
(the mixture with K = 5 labels, ``rng.random((D, K)) < 0.3`` from numpy
seed 0 plus the fallback column), makes S x B cells of ``Poisson(0.5)``
int16 counts on the device from a ``torch.Generator`` seeded 42, runs 3
warm epochs of the dense-resident epoch runner, then profiles 2 epochs
with :func:`mmvae_tpu_torch.utils.profiling.trace` (a Chrome trace under
``--out``, default ``$TMPDIR/trace_<kind>``).  It prints cells/sec and
the table of device time by kernel, microseconds a batch and launches,
each row named with the port's kernel it belongs to, from
:func:`~mmvae_tpu_torch.utils.profiling.kernel_times`.  With ``--device
cpu`` it runs, and its table is host op time, never device time.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

from ..utils.profiling import host_times, kernel_times, trace

KINDS = ("nb", "vmf", "joint", "mixture")
# the port's kernel each CUDA function belongs to (csrc/*.cu): each
# kernel's two stages are one kernel's time (K4's count_encode_tiles and
# _sum, K2's valgrad_tiles and _sum, K7's elbo_fwd_rows and _sum, ...)
PORT_KERNELS = (
    ("count_encode_tiles", "count_encode"),
    ("count_encode_sum", "count_encode"),
    ("count_encode_bwd_tiles", "count_encode_bwd"),
    ("count_encode_bwd_sum", "count_encode_bwd"),
    ("lse_tiles", "nb_lse"), ("lse_sum", "nb_lse"),
    ("value_tiles", "nb_value"), ("value_sum", "nb_value"),
    ("valgrad_tiles", "nb_valgrad"), ("valgrad_sum", "nb_valgrad"),
    ("finish_tiles", "nb_finish"), ("finish_sum", "nb_finish"),
    ("elbo_fwd_rows", "nb_elbo_fwd"), ("elbo_fwd_sum", "nb_elbo_fwd"),
    ("elbo_bwd_groups", "nb_elbo_bwd"),
    ("elementwise_kernel", "roofline_probe"),
)


def port_kernel(name: str) -> str:
    """The port's kernel a profiled CUDA function belongs to (the port's
    kernels live in an anonymous namespace), or "torch" for PyTorch's own
    kernels and copies."""
    return next((k for sym, k in PORT_KERNELS if re.search(
        rf"\(anonymous namespace\)::{sym}[<(]", name)), "torch")


def build(kind: str, D: int, S: int, device="cuda"):
    """(model, packed step, parameters) of ``kind`` at the default
    architecture (the JAX script's ``build``)."""
    from ..train.config import TrainingOptions

    topt = TrainingOptions(nboot=3, superbatch=S, seed=0)
    if kind == "vmf":
        from ..models.vmf import VMFVAE
        from ..ops.vmf_fast import VMFFastStep

        model = VMFVAE(data_dim=D, covar_dim=1, latent=2)
        fast = VMFFastStep(model, topt)
    elif kind == "nb":
        from ..models.nb import NBVAE
        from ..ops.nb_fast import NBFastStep

        model = NBVAE(data_dim=D, covar_dim=1, mean_latent=2)
        fast = NBFastStep(model, topt)
    elif kind == "joint":
        from ..models.vmfnb import VMFNBVAE
        from ..ops.vmfnb_fast import VMFNBFastStep

        model = VMFNBVAE(data_dim=D, mean_latent=2)
        fast = VMFNBFastStep(model, topt)
    elif kind == "mixture":
        from ..models.vmfnb_mixture import VMFNBMixtureVAE
        from ..ops.vmfnb_fast import VMFNBMixtureFastStep

        K = 5
        rng = np.random.default_rng(0)
        label = rng.random((D, K)) < 0.3
        label[:, 0] |= ~label.any(axis=1)
        model = VMFNBMixtureVAE(label=label, mean_latent=2)
        fast = VMFNBMixtureFastStep(model, topt)
    else:
        raise ValueError(f"unknown model kind {kind!r}: {' | '.join(KINDS)}")
    params = model.init(torch.Generator().manual_seed(0), device=device)
    return model, fast, params


def counts(ntot: int, D: int, device) -> torch.Tensor:
    """(ntot, D) int16 Poisson(0.5) counts made on ``device`` from a
    generator seeded 42."""
    g = torch.Generator(device=device)
    g.manual_seed(42)
    rate = torch.full((ntot, D), 0.5, device=device)
    return torch.poisson(rate, generator=g).to(torch.int16)


def summarize(prof, nbatch: int, device: str) -> dict:
    """Print the profile's time by kernel (device) or by host op (CPU
    runs), microseconds a batch; returns {row name: (us, count)}."""
    if device == "cuda":
        rows = kernel_times(prof)
        what = "device kernel"
    else:
        rows = host_times(prof)
        what = "host op self time (CPU run: not device time)"
    total = sum(us for us, _ in rows.values())
    print(f"{what} total {total / 1e3:.2f} ms over {nbatch} batches "
          f"({total / nbatch:.1f} us/batch)\n")
    print(f"{'us/batch':>9}  {'count':>6}  {'kernel':16s}  name")
    for nm, (us, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:45]:
        label = port_kernel(nm) if device == "cuda" else "host"
        print(f"{us / nbatch:9.2f}  {n:6d}  {label:16s}  {nm[:90]}")
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("kind", nargs="?", default="joint", choices=KINDS)
    p.add_argument("D", nargs="?", type=int, default=20000)
    p.add_argument("S", nargs="?", type=int, default=32)
    p.add_argument("B", nargs="?", type=int, default=100)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("trace_step --device cuda: no CUDA device is "
                           "available (pass --device cpu)")
    from ..train.loop import DenseEpochRunner

    _, fast, params = build(a.kind, a.D, a.S, device)
    ntot = a.S * a.B
    runner = DenseEpochRunner(fast, counts(ntot, a.D, device), a.B, seed=0)
    q = fast.pack(params)
    po = fast.optimizer.init(q)
    for it in range(3):
        q, po, reps, _ = runner(q, po, it)
    reps.cpu()

    out_dir = a.out or os.path.join(tempfile.gettempdir(), f"trace_{a.kind}")
    with trace(out_dir) as prof:
        t0 = time.perf_counter()
        for it in range(2):
            q, po, reps, _ = runner(q, po, 3 + it)
        reps.cpu()
        dt = time.perf_counter() - t0
    print(f"{a.kind}: 2 epochs of {a.S} batches of {a.B} x {a.D} in "
          f"{dt:.3f}s -> {2 * ntot / dt:.0f} cells/sec (on {device}, "
          f"profiled)")
    return summarize(prof, 2 * a.S, device.type)


if __name__ == "__main__":
    main(sys.argv[1:])
