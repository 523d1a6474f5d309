"""Structured metrics logging (SURVEY §5.5).

The reference reports a single scalar loss per batch/epoch on stderr
(include/mmvae_alg.hh:283-284, 326-327).  Here every epoch appends one
JSON line — epoch, mean loss, KL weight, cells/sec, phase timings — to
``${out}.metrics.jsonl`` alongside the reference-compatible
``scores.gz`` artifact, so dashboards and regression tooling can consume
training runs without parsing logs.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, path: str | os.PathLike | None):
        self.path = os.fspath(path) if path else None
        self._t0 = time.time()

    def log_epoch(self, epoch: int, **fields) -> None:
        if not self.path:
            return
        rec = {"epoch": epoch, "wall_time": round(time.time() - self._t0, 3)}
        for k, v in fields.items():
            if isinstance(v, float):
                v = round(v, 6)
            rec[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
