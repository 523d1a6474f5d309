"""Find a cell's pieces by name.

A cell of ``BENCHMARK.json`` names its configuration and its traffic
mix; each is a file under this folder (``configs/<config>.json``,
``traffic/<traffic>.json``), the cell's own limits are
``workloads/<cell>.json``, each per-layer metric is a reader
``metrics/<metric>.py``, the traffic's ``"driver"`` is
``drivers/<driver>.py`` and the configuration's ``"model"`` is the
program's build for that family (``models/<model>.py``) and its plain
reference (``reference/<model>.py``).  Adding any of them takes new
files and new ``BENCHMARK.json`` entries, never an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))


def load_module(path: str, name: str):
    """The module of the file ``path`` (its name may hold dots, as a
    metric's may), imported under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One cell, with everything its run reads."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def module(self, kind: str):
        """``perfbench.<kind>.<name>``: this cell's driver (by its
        traffic's ``"driver"``), or the program's build or the reference
        of its model family (by its configuration's ``"model"``)."""
        name = (self.traffic["driver"] if kind == "drivers"
                else self.config["model"])
        return importlib.import_module(f"perfbench.{kind}.{name}")

    @staticmethod
    def metric_reader(name: str):
        """``metrics/<name>.py`` (a metric's name may hold dots)."""
        return load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                           f"perfbench_metric_{name.replace('.', '_')}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = HERE, bench: str | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (default: ``BENCHMARK.json`` beside
    this folder), its data files under ``root`` (the tests point it at
    their own tiny cells)."""
    bench = bench or os.path.join(os.path.dirname(root), "BENCHMARK.json")
    spec = _json(bench)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench} (it has "
                       f"{', '.join(cells)})")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(root, "configs", f"{w['config']}.json")),
        traffic=_json(os.path.join(root, "traffic", f"{w['traffic']}.json")),
        limits=_json(os.path.join(root, "workloads", f"{name}.json")),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])
