"""The data axis of a data-parallel run.

Port of the data axis of ``mmvae_tpu/parallel/mesh.py`` (``make_mesh``,
``batch_sharding``, :27-64): the world size, this process's rank and
device, and the rows of a global batch that the rank owns.  A rank owns
the contiguous slice ``[rank * M, (rank + 1) * M)`` of every global batch
of B rows, M = B / world.  The model axis of tensor parallelism is not
ported yet (ROADMAP.md Queue 1 item 13).

Two modes, the JAX package's (README "Scaling", ``train/loop.py:91-107``):

- ``data_parallel`` (``--data_parallel``, and any multi-process run
  without ``--dp_shard``): the single-device trajectory.  Every rank
  makes the global batch's draws; each computes its rows of the report
  and of every bootstrap's resampled positions (the resampled rows are
  those of the whole batch, so the batch's counts are gathered once a
  step, :meth:`DataMesh.step_inputs`); the losses are means over rows,
  so the mean of the ranks' means is the global mean.
- ``dp_shard`` (``--dp_shard``, JAX's ``shard_map`` semantics): each
  rank draws its own noise and resamples within its own rows; only the
  report and the gradients cross ranks.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from .collectives import gather_rows

MODES = ("data_parallel", "dp_shard")


@dataclass(frozen=True)
class DataMesh:
    """World size, rank, device and mode of a data-parallel run (one
    process a rank)."""

    world: int
    rank: int
    device: torch.device
    mode: str = "data_parallel"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")

    @property
    def shard(self) -> bool:
        """Per-rank draws and resampling (``--dp_shard``)."""
        return self.mode == "dp_shard"

    def local_batch(self, B: int) -> int:
        """M = B / world, the rows of a global batch a rank owns."""
        if B % self.world:
            raise ValueError(f"--batch_size {B} not divisible by the "
                             f"{self.world} processes")
        return B // self.world

    def rows(self, B: int) -> slice:
        """This rank's rows of a global batch of B."""
        M = self.local_batch(B)
        return slice(self.rank * M, (self.rank + 1) * M)

    def step_inputs(self, x: torch.Tensor, c: torch.Tensor, rand: dict):
        """(counts, covariate, draws) of a batch step's bootstrap passes.

        ``x`` and ``c`` are this rank's rows.  Under ``dp_shard`` they and
        ``rand`` (the rank's own draws) are returned as they are.  Under
        ``data_parallel`` ``rand`` is the global batch's: the counts and
        covariates of the whole batch are gathered (one collective) and
        the draws cut to this rank's rows — its rows of ``rep_eps`` and
        of each ``boot_eps``, and its positions of each ``ridx``, whose
        values index the whole batch."""
        if self.shard:
            return x, c, rand
        xg, cg = gather_rows([x, c])
        sl = self.rows(xg.shape[0])
        return xg, cg, {
            "rep_eps": tuple(e[sl] for e in rand["rep_eps"]),
            "ridx": rand["ridx"][:, sl],
            "boot_eps": tuple(e[:, sl] for e in rand["boot_eps"])}


def make_mesh(device: torch.device, mode: str) -> DataMesh | None:
    """The data axis over the process group (None for one process: a
    world of one trains the single-device step)."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return None
    return DataMesh(dist.get_world_size(), dist.get_rank(),
                    torch.device(device), mode)
