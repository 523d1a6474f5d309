"""The count generator and the draws: the same rows whatever the number
of ranks, the same draws for the same seed."""

import torch

from perfbench import counts

TR = {"row_block": 10, "count_dtype": "int8", "counts_per_cell": 300}


def test_rows_same_for_any_number_of_ranks():
    D, M, nbatch = 50, 20, 6
    whole = counts.make_blocks(7, counts.rank_blocks(nbatch * 4, M, 0, 1,
                                                     10), TR, D, "cpu")
    for world in (2, 4):
        for r in range(world):
            mine = counts.make_blocks(
                7, counts.rank_blocks(nbatch * 4 // world, M, r, world, 10),
                TR, D, "cpu")
            for b in range(nbatch * 4 // world):
                g = b * world + r
                assert torch.equal(mine[b * M:(b + 1) * M],
                                   whole[g * M:(g + 1) * M])


def test_counts_deterministic_and_seeded():
    a = counts.make_blocks(2**31 + 5, range(3), TR, 40, "cpu")
    b = counts.make_blocks(2**31 + 5, range(3), TR, 40, "cpu")
    c = counts.make_blocks(2**31 + 6, range(3), TR, 40, "cpu")
    assert a.dtype == torch.int8 and torch.equal(a, b)
    assert not torch.equal(a, c)
    assert 0 < float(a.float().sum(1).mean()) < 1000


def test_draws_structure_and_seed():
    d = counts.draws(11, 1, 5, 20, 3, (2, 1), "cpu")
    assert [tuple(e.shape) for e in d["rep_eps"]] == [(5, 20, 2), (5, 20, 1)]
    assert tuple(d["ridx"].shape) == (5, 3, 20)
    assert int(d["ridx"].max()) < 20
    assert [tuple(e.shape) for e in d["boot_eps"]] == [(5, 3, 20, 2),
                                                       (5, 3, 20, 1)]
    e = counts.draws(11, 1, 5, 20, 3, (2, 1), "cpu")
    assert torch.equal(d["ridx"], e["ridx"])
    f = counts.draws(11, 2, 5, 20, 3, (2, 1), "cpu")
    assert not torch.equal(d["ridx"], f["ridx"])
