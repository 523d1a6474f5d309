"""The readings the limits of a training cell are set from, other than
the program's own (which every run of the cell prints).

    python3 -m perfbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed, at the cell's own sizes on one card, the plain
reference in the program's place against the reference itself:

- ``control``: the reference with TF32 on, the precision below the
  configuration's float32 with TF32 off;
- ``half_batch``: the reference with half of every batch left out and
  the mean taken over the rest.

A step that returns its state unchanged reads 1 by ``change_gap``'s
measure and needs no run.  Prints one JSON line a seed.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def readings(cell, seed: int, device) -> dict:
    from . import judge
    from .drivers.train import reference_run

    leaf = cell.module("reference").ENCODER_LEAF
    base = reference_run(cell, seed, device)
    out = {"control": judge.readings(
        reference_run(cell, seed, device, tf32=True), base, leaf)}
    out["half_batch"] = judge.readings(
        reference_run(cell, seed, device, fault="half_batch"), base, leaf)
    for v in out.values():
        v["angles"] = v.pop("_leaves")["angles"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--root", default=None)
    p.add_argument("--bench", default=None)
    a = p.parse_args(argv)
    import torch

    from . import spec

    cell = spec.load_cell(a.workload, a.root or spec.HERE, a.bench)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("perfbench.control: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(a.device)
    for seed in a.seeds:
        print(json.dumps({"workload": a.workload, "seed": seed,
                          **readings(cell, seed, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
