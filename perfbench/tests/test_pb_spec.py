"""BENCHMARK.json and the files it names: every configuration, cell and
metric loads by name, the contract's shapes hold, and a cell, a
configuration, a traffic mix and a metric added as new files are found
without an edit to any file already there."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import spec

from .conftest import DATA, REPO, run_cpu

BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(cell):
    c = spec.load_cell(cell)
    assert c.chips in (1, 4)
    assert c.module("drivers").run
    assert c.module("models").build
    ref = c.module("reference")
    assert ref.loss and ref.init_params and ref.eps_widths
    assert set(c.limits["limits"]) <= {"loss_gap", "grad_gap", "change_gap",
                                       "change_median", "encoder_angle"}
    assert {"loss_gap", "grad_gap"} <= set(c.limits["limits"])
    assert {m["name"] for m in c.end_to_end} == {"train_cells_per_s",
                                                 "setup_s"}
    assert c.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_loads(metric):
    assert callable(spec.Cell.metric_reader(metric).read)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert config["file"] == f"perfbench/configs/{config['name']}.json"
    cfg = json.load(open(os.path.join(REPO, config["file"])))
    assert cfg["source"] == config["source"]
    assert config["reduced"] == []
    assert os.path.exists(os.path.join(REPO, "perfbench", "reference",
                                       f"{cfg['model']}.py"))


def test_names_units_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= cells if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    assert {m["layer"] for m in BENCH["per_layer"]} <= {
        "device", "packed batch step", "hand-written kernels",
        "superbatch graphs"}


def test_added_files_are_found(tmp_path):
    """A copy of the benchmark with a new configuration, traffic mix,
    cell, limits and per-layer metric, each a new file plus new
    BENCHMARK.json entries: the copy's loader finds them all."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    pb = root / "perfbench"
    cfg = json.load(open(pb / "configs" / "nb_default.json"))
    cfg["mean_latent"] = 10
    (pb / "configs" / "nb_wide.json").write_text(json.dumps(cfg))
    tr = json.load(open(pb / "traffic" / "resident_100k.json"))
    tr["cells"] = 50000
    (pb / "traffic" / "resident_50k.json").write_text(json.dumps(tr))
    (pb / "workloads" / "nb_wide_half.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-4, "grad_gap": 0.1, "change_gap": 0.1}}))
    (pb / "metrics" / "batches_traced.py").write_text(
        "def read(r):\n    return float(r.batches)\n")
    bench["configs"].append(dict(bench["configs"][0], name="nb_wide",
                                 file="perfbench/configs/nb_wide.json",
                                 reduced=[]))
    bench["workloads"].append({"name": "nb_wide_half", "config": "nb_wide",
                               "traffic": "resident_50k", "chips": 1,
                               "why": "added"})
    bench["per_layer"].append({"name": "batches_traced", "unit": "count",
                               "better": "higher", "source": "device_trace",
                               "layer": "device",
                               "moves": "train_cells_per_s",
                               "workloads": ["nb_wide_half"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from perfbench import spec\n"
            "from perfbench.trace import Reading\n"
            "c = spec.load_cell('nb_wide_half')\n"
            "assert c.config['mean_latent'] == 10\n"
            "assert c.traffic['cells'] == 50000\n"
            "m = [x['name'] for x in c.per_layer]\n"
            "assert 'batches_traced' in m, m\n"
            "r = Reading(window_s=1.0, batches=64, replays=8)\n"
            "print(c.metric_reader('batches_traced').read(r))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "64.0"


def test_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits with an error and prints no result."""
    shutil.copytree(os.path.join(REPO, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0", "--device", "cpu"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "{" not in r.stdout


def test_unread_traffic_key_is_refused(tmp_path):
    """A traffic key the cell's driver does not read stops the run before
    it starts: a mix that asks for what the driver ignores would measure
    another path."""
    root = tmp_path / "data"
    shutil.copytree(DATA, root)
    tr = json.load(open(root / "traffic" / "tiny.json"))
    tr["recording"] = True
    (root / "traffic" / "tiny.json").write_text(json.dumps(tr))
    rc, line, err = run_cpu("nb_tiny", 5, root=str(root))
    assert rc != 0 and line == ""
    assert "reads no traffic key recording" in err
