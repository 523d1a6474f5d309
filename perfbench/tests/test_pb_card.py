"""On a card: the control (the reference in TF32 in the program's place)
and the planted faults read past the cell's limits, at the cells' own
sizes (the reference runs only the checked steps, so these hold in a
test run).  Skips without a card."""

import pytest

from perfbench import control, judge, spec

CELLS = ["nb_train_resident", "vmfnb_train_resident"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail(card, cell):
    try:
        c = spec.load_cell(cell)
    except KeyError:
        pytest.skip(f"{cell} is not in BENCHMARK.json")
    for seed in (3, 2**31 + 7, 12345):
        got = control.readings(c, seed, card)
        for what, nums in got.items():
            ok, _ = judge.verdict(nums, c.limits["limits"])
            assert not ok, (what, seed, nums)


@pytest.mark.card
def test_probe_reads_a_node_cost(card):
    from perfbench.probe import NodeProbe

    probe = NodeProbe(card, nodes=200)
    us = probe.us_per_node()
    probe.close()
    assert 0.1 < us < 10.0
