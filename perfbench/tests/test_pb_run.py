"""Whole runs of the benchmark on the CPU over tiny cells (the tests'
``data/``): the reference agrees with the port's CPU path, the result
line keeps its keys, and with the timed path broken underneath
``correct`` comes out false."""

import json
import os
import subprocess
import sys

import pytest

from .conftest import DATA, REPO, run_cpu

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["nb_tiny", "vmfnb_tiny"])
def test_reference_agrees_with_the_cpu_path(cell):
    rc, line, err = run_cpu(cell, 2**31 + 17)
    assert rc == 0, err[-3000:]
    out = json.loads(line)
    assert out["correct"] is True, out["checks"]
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"train_cells_per_s", "setup_s"}
    assert out["metrics"]["train_cells_per_s"]["unit"] == "cells/s"
    assert out["attempted"] > 0 and out["failed"] == 0
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"]
        assert f"check {name}:" in err


def test_clustered_genes_agree():
    """The genes clustered (forced on the CPU): the program trains in its
    order, the reference works the order out again and undoes it."""
    rc, line, err = run_cpu("nb_tiny", 19,
                            extra_env={"MMVAE_FEATURE_PERM": "force"})
    assert rc == 0, err[-3000:]
    assert "Feature clustering:" in err
    out = json.loads(line)
    assert out["correct"] is True, out["checks"]
    angle = float(err.split("encoder_angle=")[1].split()[0])
    assert angle < 1e-4


def test_traced_line():
    rc, line, err = run_cpu("nb_tiny", 23, trace=1)
    assert rc == 0, err[-3000:]
    out = json.loads(line)
    assert list(out)[:5] == KEYS
    assert "breakdown" in out and "window_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the device's metrics find nothing to read
    assert "device_idle_share" not in out["metrics"]


@pytest.mark.parametrize("cell,fault,number", [
    ("nb_tiny", "unchanged", "change_gap"),
    ("nb_tiny", "half_batch", "loss_gap"),
    ("vmfnb_tiny", "unchanged", "change_gap"),
    ("vmfnb_tiny", "half_batch", "loss_gap"),
    # faults that only the check epoch's replay sees: epoch 0's first
    # replay is staged and weighted right
    ("nb_tiny", "stale_batches", "loss_gap"),
    ("nb_tiny", "first_beta", "loss_gap"),
    ("vmfnb_tiny", "stale_batches", "loss_gap"),
    ("vmfnb_tiny", "first_beta", "loss_gap"),
])
def test_fault_is_not_correct(cell, fault, number):
    r = subprocess.run(
        [sys.executable, "-m", "perfbench.tests._faulty", fault,
         "--workload", cell, "--seed", "41", "--seconds", "0.5", "--trace",
         "0", "--device", "cpu", "--root", DATA, "--bench",
         os.path.join(DATA, "BENCHMARK.json")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is False
    c = out["checks"][number]
    assert c["value"] > c["limit"]
