"""Multi-process initialization and per-rank sharded input.

Port of ``mmvae_tpu/parallel/multihost.py``.  In the port a process is a
rank and drives one device: ``cuda:{rank % device_count}``, or the CPU.
The ranks meet at ``--coordinator host:port`` (:func:`init_multihost`),
and each reads only its B/world rows of every global batch straight
from the shared BGZF file, whose column index makes any range of cells
seekable on its own (reference include/mmutil_index.hh:192-228), so the
ranks need no coordination beyond the deterministic batch schedule
(:func:`sharded_batches`).

There is no ``global_batch_array``: torch has no global arrays.  A
rank's rows stay its own tensor, and what crosses ranks is an explicit
collective (``parallel.collectives``); :func:`local_rows`, the inverse
direction, gathers each rank's rows of an output to rank 0.

The backend is chosen by rule, never by fallback: NCCL when every rank
has a card of its own, gloo when two ranks share a card or any rank runs
on the CPU (NCCL refuses two ranks on one device; gloo moves CUDA
tensors through host memory).  The ranks learn each other's device
through the coordinator's key-value store before the process group
exists, so all of them pick the same backend.
"""

from __future__ import annotations

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..data.pipeline import sequential_batches
from ..utils.logging import TLOG
from .collectives import gather_rows


def dist_timeout() -> datetime.timedelta:
    """``MMVAE_DIST_TIMEOUT`` seconds (default 120, as in the JAX
    package): how long a rank waits for its peers at start-up, and for a
    collective."""
    return datetime.timedelta(
        seconds=float(os.environ.get("MMVAE_DIST_TIMEOUT", "120")))


def rank_device(device: torch.device, rank: int) -> torch.device:
    """The device of ``rank``: ``cuda:{rank % device_count}`` for a CUDA
    run, the CPU for a CPU run."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def choose_backend(device_keys: list[str]) -> tuple[str, str]:
    """(backend, reason) for ranks whose devices are ``device_keys``
    (``host/device`` strings, one a rank)."""
    if any(k.endswith("/cpu") for k in device_keys):
        return "gloo", "a rank runs on the CPU"
    if len(set(device_keys)) < len(device_keys):
        return "gloo", "ranks share a card"
    return "nccl", "every rank has a card of its own"


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   device: torch.device) -> torch.device:
    """Join the ``num_processes`` ranks at ``coordinator`` (host:port;
    rank 0 listens there) as rank ``process_id``; returns this rank's
    device.  A no-op returning ``device`` for one process, or when the
    process group already exists with this rank and size.

    Each rank selects its card before anything touches CUDA, registers
    ``host/device`` in the coordinator's store and reads every other
    rank's, then starts the process group on the backend
    :func:`choose_backend` gives.  A peer that does not come up within
    :func:`dist_timeout` raises ``RuntimeError`` naming the coordinator;
    no rank carries on alone."""
    if num_processes <= 1:
        return device
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                        process_id):
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks (rank "
                f"{dist.get_rank()}) exists; asked for rank {process_id} "
                f"of {num_processes}")
        return rank_device(device, process_id)
    if not coordinator or ":" not in coordinator:
        raise ValueError(f"--num_hosts {num_processes} needs --coordinator "
                         f"host:port (or MMVAE_COORDINATOR); got "
                         f"{coordinator!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--host_id {process_id} outside [0, "
                         f"{num_processes})")
    device = rank_device(device, process_id)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    host, port = coordinator.rsplit(":", 1)
    timeout = dist_timeout()
    try:
        store = dist.TCPStore(host, int(port), num_processes,
                              is_master=process_id == 0, timeout=timeout,
                              wait_for_workers=True)
        store.set(f"mmvae/device/{process_id}",
                  f"{socket.gethostname()}/{device}")
        keys = [store.get(f"mmvae/device/{r}").decode()
                for r in range(num_processes)]
    except (RuntimeError, OSError) as e:  # DistStoreError is a RuntimeError
        raise RuntimeError(
            f"multi-process start-up: rank {process_id} of {num_processes} "
            f"did not meet its peers at the coordinator {coordinator} within "
            f"{timeout.total_seconds():g} s (MMVAE_DIST_TIMEOUT): {e}"
        ) from e
    backend, why = choose_backend(keys)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    TLOG(f"Process {process_id} of {num_processes} on {device}: backend "
         f"{backend} ({why}; devices {', '.join(keys)})")
    return device


def host_role() -> bool:
    """Whether this process writes: rank 0 of a process group, or the
    one process of a run without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (no-op for one process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def host_slice(batch: np.ndarray, host_id: int, host_count: int
               ) -> np.ndarray:
    """Rank ``host_id``'s contiguous slice of a global batch's cell ids:
    the batch is split evenly over the ranks in order."""
    B = len(batch)
    if B % host_count:
        raise ValueError(f"global batch {B} not divisible by {host_count} "
                         f"processes")
    bh = B // host_count
    return batch[host_id * bh:(host_id + 1) * bh]


def sharded_batches(ntot: int, global_batch: int, host_id: int,
                    host_count: int) -> list[np.ndarray]:
    """Rank ``host_id``'s slices of the global deterministic schedule
    (each a contiguous range of cells of its global batch, so a rank's
    read coalesces into one BGZF seek)."""
    return [host_slice(gb, host_id, host_count)
            for gb in sequential_batches(ntot, global_batch)]


def local_rows(t: torch.Tensor, mesh=None) -> torch.Tensor | None:
    """Every data index's rows of an epoch's (nbatch, M, width) output,
    concatenated along the row axis in data order on rank 0 (None on the
    others): with each data index's slice of every batch, the result is
    the global batches' (nbatch, B, width).  One ``gather_rows`` over the
    world, or under tensor parallelism over the data column of model
    index 0 (the outputs are replicated over each model row, so the
    other model indices send nothing)."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return t
    group = None
    if mesh is not None and mesh.tp:
        if mesh.model_index != 0:
            return None
        if mesh.data_group is None:
            return t if dist.get_rank() == 0 else None
        group = mesh.data_group
    full = gather_rows([t.transpose(0, 1)], group)[0].transpose(0, 1)
    return full if dist.get_rank() == 0 else None
