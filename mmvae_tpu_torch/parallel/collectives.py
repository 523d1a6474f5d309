"""The data-parallel collectives of a batch step.

Port of the ``pmean`` reductions of the JAX package's ``shard_map`` steps
(``ops/nb_fast.py:299-323``, ``train/loop.py:291-319``) and of the
batch gather its SPMD partitioner inserts under ``--data_parallel``.
The tensor-parallel collectives (``mmvae_tpu/parallel/collectives.py``)
are not ported yet (ROADMAP.md Queue 1 item 13).

Each function is ONE collective a call: its tensors travel in one flat
buffer.  :func:`pmean` is an ``all_reduce``: both backends reduce each
element once and send every rank the same result, so the ranks hold the
same bits, and a fixed world on fixed devices repeats them from run to
run (tests/test_torch_parallel.py checks both on gloo, ``chip_smoke.py``
phase 37 on gloo, or on NCCL where the machine has two cards).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def pmean(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The mean over ranks of each tensor (float32, any shapes), from one
    ``all_reduce`` of their flat concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat = flat / dist.get_world_size()
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def gather_rows(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every rank's rows of each (M, ...) tensor, concatenated in rank
    order: (world * M, ...) with each tensor's dtype.  The tensors ride
    one ``all_gather`` as raw bytes, so narrow counts (int8, int16) move
    in their storage width whatever dtypes the backend reduces."""
    M = tensors[0].shape[0]
    views = [t.contiguous().view(torch.uint8).reshape(M, -1)
             for t in tensors]
    widths = [v.shape[1] for v in views]
    flat = torch.cat(views, dim=1)
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    full = torch.cat(parts, dim=0)
    out, off = [], 0
    for t, w in zip(tensors, widths):
        out.append(full[:, off:off + w].contiguous().view(t.dtype)
                   .reshape(full.shape[0], *t.shape[1:]))
        off += w
    return out
