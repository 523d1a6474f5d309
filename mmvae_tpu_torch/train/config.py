"""Layered option dataclasses with the reference's CLI flag surface.

A copy of ``mmvae_tpu/train/config.py`` (``MMVaeOptions``,
``TrainingOptions``, ``_csv_ints``): the shared module cannot be imported
without loading JAX (``mmvae_tpu/train/__init__.py`` imports the JAX
trainer).  Flags and defaults are the same, so one command line means
the same run to both packages.  ``apply_runtime_config`` starts the
multi-process group (``parallel.multihost.init_multihost``); JAX's
``jax_debug_nans`` has no counterpart and ``--debug_nans`` is accepted
and ignored.  Each option group is a dataclass with
an ``add_args``/``from_args`` pair; the CLIs run all groups over one
command line (reference include/mmvae.hh:109-120).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass


def _csv_ints(s: str) -> tuple[int, ...]:
    """Comma-separated layer dims, e.g. '10,10' (reference: nb.hh:114-121)."""
    s = s.strip()
    if not s:
        return ()
    return tuple(int(t) for t in s.split(","))


@dataclass
class MMVaeOptions:
    """Data/IO + KL options (reference: mmvae_options_t, mmvae.hh:31-56)."""

    mtx: str = ""
    idx: str = ""
    out: str = ""
    row: str = ""
    col: str = ""
    annot: str = ""
    covar_mtx: str = ""
    covar_idx: str = ""
    batch_size: int = 100
    kl_discount: float = 0.1
    kl_min: float = 1e-2
    kl_max: float = 1.0
    # beyond the reference: streaming vs in-memory data blocks
    data_mode: str = "auto"  # auto | stream | memory

    @staticmethod
    def add_args(p: argparse.ArgumentParser) -> None:
        p.add_argument("--mtx", type=str, default="")
        p.add_argument("--idx", type=str, default="")
        p.add_argument("--out", "--output", dest="out", type=str, default="")
        p.add_argument("--row", type=str, default="")
        p.add_argument("--col", "--column", dest="col", type=str, default="")
        p.add_argument("--annot", "--annotation", dest="annot", type=str,
                       default="")
        p.add_argument("--covar", "--cov", dest="covar_mtx", type=str,
                       default="")
        p.add_argument("--covar_idx", "--cov_idx", dest="covar_idx", type=str,
                       default="")
        p.add_argument("--batch_size", "--batch", dest="batch_size", type=int,
                       default=100)
        p.add_argument("--kl_discount", type=float, default=0.1)
        p.add_argument("--kl_min", type=float, default=1e-2)
        p.add_argument("--kl_max", type=float, default=1.0)
        p.add_argument("--data_mode", choices=("auto", "stream", "memory"),
                       default="auto")

    @classmethod
    def from_args(cls, ns: argparse.Namespace) -> "MMVaeOptions":
        opt = cls(
            mtx=ns.mtx, idx=ns.idx, out=ns.out, row=ns.row, col=ns.col,
            annot=ns.annot, covar_mtx=ns.covar_mtx, covar_idx=ns.covar_idx,
            batch_size=ns.batch_size, kl_discount=ns.kl_discount,
            kl_min=ns.kl_min, kl_max=ns.kl_max,
            data_mode=getattr(ns, "data_mode", "auto"),
        )
        opt.finalize()
        return opt

    def finalize(self) -> None:
        """Derived defaults (reference: mmvae.hh:197-207)."""
        if not self.mtx or not os.path.exists(self.mtx):
            raise FileNotFoundError(f"missing mtx file: {self.mtx!r}")
        if not self.out:
            raise ValueError("need output file header (--out)")
        if not self.idx:
            self.idx = self.mtx + ".index"
        if not self.covar_idx and self.covar_mtx:
            self.covar_idx = self.covar_mtx + ".index"


@dataclass
class TrainingOptions:
    """Training-loop options (reference: training_options_t,
    mmvae_alg.hh:14-33)."""

    lr: float = 1e-3
    grad_clip: float = 1.0
    nboot: int = 3
    max_epoch: int = 101
    recording: int = 10
    weight_decay: float = 1e-4  # hard-coded in the reference (mmvae_alg.hh:236)
    # beyond the reference (no reference analog):
    superbatch: int = 8          # minibatches fused per jit dispatch
    fused: bool = True           # use the fused Pallas ELBO kernel (NB model)
    fused_step: bool = True      # single-pass step kernels (ops/nb_step.py)
                                 # when the architecture allows them
    seed: int = 0                # deterministic PRNG (reference: random_device)
    resume: str = ""             # checkpoint directory to resume from
    checkpoint_dir: str = ""     # where to write checkpoints ("" = off)
    data_parallel: bool = False  # shard the batch over all local devices
    dp_shard: bool = False       # shard_map DP: per-shard kernels + pmean
                                 # grads (multi-chip high-throughput mode)
    ondevice: bool = False       # device-resident sparse data, on-device epochs
    auto_ondevice: bool = True   # flip ondevice on automatically when the
                                 # padded-ELL data fits a safe HBM budget
    debug_nans: bool = False     # jax_debug_nans (SURVEY §5.2 analog)
    # Multi-host (SURVEY §5.8): one process per host, a global device
    # mesh, per-host sharded BGZF input (each host seeks its own column
    # ranges via the index — mmutil_index.hh:192-228 is what makes this
    # embarrassingly shardable).  Flags default from the MMVAE_COORDINATOR
    # / MMVAE_NUM_HOSTS / MMVAE_HOST_ID environment.
    coordinator: str = ""        # host:port of process 0
    num_hosts: int = 1
    host_id: int = 0
    # Kernel-aware tensor parallelism (SURVEY §5.7): shard the feature
    # dimension D over a 'model' mesh axis of this size; the fused step
    # kernels run on local D slices with psum'd normalizers.
    tensor_parallel: int = 1
    # On-device epoch-loss fetches drain in groups of this size when
    # stderr is not a TTY, checkpointing is off, and the run is
    # single-host (each per-epoch sync costs a full tunnel drain on
    # remote devices).  0 = keep the MMVAE_REPORT_EVERY env default.
    report_every: int = 0

    @staticmethod
    def add_args(p: argparse.ArgumentParser) -> None:
        p.add_argument("--lr", "--learning", "--learn_rate", "--learning_rate",
                       "--rate", dest="lr", type=float, default=1e-3)
        p.add_argument("--grad_clip", type=float, default=1.0)
        p.add_argument("--nboot", "--boot", "--bootstrap", dest="nboot",
                       type=int, default=3)
        p.add_argument("--max_epoch", "--epoch", dest="max_epoch", type=int,
                       default=101)
        p.add_argument("--recording", type=int, default=10)
        p.add_argument("--superbatch", type=int, default=8)
        p.add_argument("--fused", dest="fused", action="store_true",
                       default=True)
        p.add_argument("--no_fused", dest="fused", action="store_false")
        p.add_argument("--fused_step", dest="fused_step",
                       action="store_true", default=True)
        p.add_argument("--no_fused_step", dest="fused_step",
                       action="store_false")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--resume", type=str, default="")
        p.add_argument("--checkpoint_dir", type=str, default="")
        p.add_argument("--data_parallel", action="store_true")
        p.add_argument("--dp_shard", action="store_true")
        p.add_argument("--ondevice", action="store_true")
        p.add_argument("--no_auto_ondevice", dest="auto_ondevice",
                       action="store_false", default=True)
        p.add_argument("--debug_nans", action="store_true")
        p.add_argument("--coordinator", type=str,
                       default=os.environ.get("MMVAE_COORDINATOR", ""))
        p.add_argument("--num_hosts", type=int,
                       default=int(os.environ.get("MMVAE_NUM_HOSTS", "1")))
        p.add_argument("--host_id", type=int,
                       default=int(os.environ.get("MMVAE_HOST_ID", "0")))
        p.add_argument("--tensor_parallel", "--tp", dest="tensor_parallel",
                       type=int, default=1)
        p.add_argument("--report_every", type=int, default=0,
                       help="batch per-epoch loss fetches in groups of "
                            "N on-device epochs (0 = MMVAE_REPORT_EVERY "
                            "env, default 8 when stderr is not a TTY)")

    @classmethod
    def from_args(cls, ns: argparse.Namespace) -> "TrainingOptions":
        return cls(
            lr=ns.lr, grad_clip=ns.grad_clip, nboot=ns.nboot,
            max_epoch=ns.max_epoch, recording=ns.recording,
            superbatch=ns.superbatch, fused=ns.fused,
            fused_step=ns.fused_step, seed=ns.seed,
            resume=ns.resume,
            checkpoint_dir=ns.checkpoint_dir, data_parallel=ns.data_parallel,
            dp_shard=ns.dp_shard,
            ondevice=ns.ondevice,
            auto_ondevice=getattr(ns, "auto_ondevice", True),
            debug_nans=ns.debug_nans,
            coordinator=getattr(ns, "coordinator", ""),
            num_hosts=getattr(ns, "num_hosts", 1),
            host_id=getattr(ns, "host_id", 0),
            report_every=getattr(ns, "report_every", 0),
            tensor_parallel=getattr(ns, "tensor_parallel", 1),
        )

    def apply_runtime_config(self, device):
        """Process-level set-up (call once in CLI mains, before any CUDA
        tensor is made; JAX ``config.py:194-200``): with ``--num_hosts >
        1`` join the process group at ``--coordinator`` as rank
        ``--host_id``.  Returns this process's device (the rank's card)."""
        from ..parallel.multihost import init_multihost

        return init_multihost(self.coordinator, self.num_hosts,
                              self.host_id, device)
