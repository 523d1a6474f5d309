"""The count matrix of a cell and the draws of its checked epoch, made
on the device from the seed.

Counts: Poisson around a log-normal gene profile, ``rate = profile /
sum(profile) * counts_per_cell`` (about that many counts a cell), in the
traffic's count dtype, clipped to it.  The rows are made by blocks of
``row_block`` rows, each from a generator seeded by (seed, block), so a
rank of a data-parallel cell that makes only its own blocks holds the
same rows as the one-process matrix, and the reference can make any
block again without the rest.  The arithmetic is ``chip_smoke.py``'s
``full_size_counts``.

Draws: an epoch's noise in the structure of the training step's
``draw_rand`` (``rep_eps``, ``ridx``, ``boot_eps``), from a generator
seeded by (seed, epoch), so the benchmark hands the program and the
reference the same draws.
"""

from __future__ import annotations

import torch

_MASK = (1 << 63) - 1


def mix(*parts: int) -> int:
    """A 63-bit seed from whole numbers (splitmix64 over them), so seeds
    of nearby runs, blocks and ranks give unrelated streams."""
    z = 0x9E3779B97F4A7C15
    for p in parts:
        z = (z + (int(p) & ((1 << 64) - 1)) + 0x9E3779B97F4A7C15) \
            & ((1 << 64) - 1)
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
        z ^= z >> 31
    return z & _MASK


PROFILE, BLOCK, DRAWS, PARAMS = 1, 2, 3, 4

DTYPES = {"int8": (torch.int8, 127), "int16": (torch.int16, 32767)}


def profile_rate(seed: int, D: int, per_cell: float, device) -> torch.Tensor:
    """(1, D) Poisson rates: a log-normal gene profile scaled to
    ``per_cell`` counts a cell."""
    g = torch.Generator(device=device).manual_seed(mix(seed, PROFILE))
    prof = torch.exp(torch.randn((1, D), generator=g, device=device))
    return prof / prof.sum() * float(per_cell)


def make_blocks(seed: int, blocks, traffic: dict, D: int, device
                ) -> torch.Tensor:
    """The rows of row blocks ``blocks`` (global block indices), in that
    order, as one (len(blocks) * row_block, D) tensor."""
    rb = int(traffic["row_block"])
    dtype, hi = DTYPES[traffic["count_dtype"]]
    rate = profile_rate(seed, D, traffic["counts_per_cell"], device)
    rate = rate.expand(rb, D).contiguous()
    blocks = list(blocks)
    out = torch.empty((len(blocks) * rb, D), dtype=dtype, device=device)
    g = torch.Generator(device=device)
    for i, k in enumerate(blocks):
        g.manual_seed(mix(seed, BLOCK, k))
        out[i * rb:(i + 1) * rb] = torch.poisson(rate, generator=g).clamp_(
            max=hi).to(dtype)
    return out


def rank_blocks(nbatch: int, M: int, rank: int, world: int, rb: int) -> list:
    """The global row blocks a rank holds, batch after batch: the rank's
    M rows of every global batch of ``M * world`` rows (``dp_shard``'s
    contiguous slice of each batch), ``M`` a multiple of ``rb``."""
    per = M // rb
    return [(b * world + rank) * per + j for b in range(nbatch)
            for j in range(per)]


def draws(seed: int, epoch: int, nbatch: int, M: int, nboot: int,
          widths: tuple, device) -> dict:
    """Epoch ``epoch``'s draws for ``nbatch`` batch steps of ``M`` rows:
    ``rep_eps`` (nbatch, M, w) a width, ``ridx`` (nbatch, nboot, M),
    ``boot_eps`` (nbatch, nboot, M, w) a width."""
    g = torch.Generator(device=device).manual_seed(mix(seed, DRAWS, epoch))
    rep = tuple(torch.randn((nbatch, M, w), generator=g, device=device)
                for w in widths)
    ridx = torch.randint(0, M, (nbatch, nboot, M), generator=g,
                         device=device)
    boot = tuple(torch.randn((nbatch, nboot, M, w), generator=g,
                             device=device) for w in widths)
    return {"rep_eps": rep, "ridx": ridx, "boot_eps": boot}


def param_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, PARAMS))
