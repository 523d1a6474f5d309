"""Run one cell of ``BENCHMARK.json`` once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout, on a CUDA card (every cell takes one).
The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number with its limit; the same numbers are the last lines of
standard error.

``--device cpu`` (with ``--root`` and ``--bench``, the tests' tiny
cells) skips the look for a card and runs the rest on the CPU.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mmvae_tpu")


def log(*msg) -> None:
    print("[perfbench]", *msg, file=sys.stderr, flush=True)


def loaded_forbidden() -> list:
    """Top-level names in ``sys.modules`` that the benchmark must never
    load: JAX, Flax and the JAX package the port was made from, compared
    as whole names (``mmvae_tpu_torch`` is not ``mmvae_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--root", default=None,
                   help="the folder of the cell's data files")
    p.add_argument("--bench", default=None, help="the BENCHMARK.json")
    return p.parse_args(argv)


def device_info(torch, device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(r.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def per_layer(cell, reading) -> dict:
    """Each per-layer metric's reader on the traced sub-window; a reader
    that finds nothing to read returns None and its metric is left
    out."""
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"]).read(reading)
        if value is None:
            log(f"metric {m['name']}: nothing to read in this cell")
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    a = parse(argv)
    from . import spec

    root = a.root or spec.HERE
    cell = spec.load_cell(a.workload, root, a.bench)
    import torch

    driver = cell.module("drivers")
    unknown = sorted(set(cell.traffic) - driver.TRAFFIC_KEYS)
    if unknown:
        log(f"{cell.name}: the {cell.traffic['driver']} driver reads no "
            f"traffic key {', '.join(unknown)}")
        return 2
    if cell.chips != 1:
        log(f"{cell.name} asks for {cell.chips} chips; this benchmark runs "
            f"one process on one card")
        return 2
    if a.device == "cuda" and not (torch.cuda.is_available()
                                   and torch.cuda.device_count() >= 1):
        log(f"{cell.name} needs a CUDA card; this machine has none")
        return 3
    device = torch.device(a.device)
    res = driver.run(cell, a.seed, a.seconds, bool(a.trace), device,
                     T_START, log)
    bad = loaded_forbidden()
    if bad:
        log(f"loaded after the window: {', '.join(bad)}; the benchmark runs "
            f"the port alone")
        return 5
    dev = device_info(torch, device, res["peak"])
    if a.trace:
        metrics = per_layer(cell, res["reading"])
        dev["busy_s"], dev["window_s"] = res["busy_s"], res["window_s"]
        for note in res["reading"].notes:
            log(note)
    else:
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in res["metrics"]]
        if missing:
            log(f"the {cell.traffic['driver']} driver gives no {missing}")
            return 6
        metrics = {m["name"]: {"value": res["metrics"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    if a.trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
