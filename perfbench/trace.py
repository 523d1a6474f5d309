"""Reduce one profiled sub-window to what the per-layer metrics read.

The sub-window is a run of whole superbatch replays.  On a card each
replay waits behind a spin kernel (``torch.cuda._sleep``) that the
harness launches with the card idle, so the host has enqueued the
replay's input copies and graph before the card reaches them: the
replay then runs as it does untraced, where the host runs ahead of the
card.  (Under the profiler a graph launch waits for the previous replay
to end, so replays enqueued back to back leave gaps of the profiler's
own between them.)  The sub-window is the sum, over the replays, of the
time from a spin's end to the end of the last device event before the
next spin, all read from the trace itself; the spins are left out.

Device time by kernel name is ``utils/profiling.py``'s ``kernel_times``
arithmetic (the profiler's CUDA events summed by name, its "Activity
Buffer Request" row left out); the names of the port's hand-written
kernels are ``benchmarks/trace_step.py``'s ``PORT_KERNELS``, copied
here.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

# the port's kernel each CUDA function belongs to (csrc/*.cu); a
# kernel's two stages are one kernel's time; the first of each pair is
# its stage 1, launched once a call
PORT_KERNELS = (
    ("count_encode_tiles", "count_encode"),
    ("count_encode_sum", "count_encode"),
    ("count_encode_bwd_tiles", "count_encode_bwd"),
    ("count_encode_bwd_sum", "count_encode_bwd"),
    ("lse_tiles", "nb_lse"), ("lse_sum", "nb_lse"),
    ("value_tiles", "nb_value"), ("value_sum", "nb_value"),
    ("valgrad_tiles", "nb_valgrad"), ("valgrad_sum", "nb_valgrad"),
    ("finish_tiles", "nb_finish"), ("finish_sum", "nb_finish"),
    ("elbo_fwd_rows", "nb_elbo_fwd"), ("elbo_fwd_sum", "nb_elbo_fwd"),
    ("elbo_bwd_groups", "nb_elbo_bwd"),
    ("elementwise_kernel", "roofline_probe"),
)
STAGE1 = {"count_encode_tiles", "count_encode_bwd_tiles", "lse_tiles",
          "value_tiles", "valgrad_tiles", "finish_tiles", "elbo_fwd_rows",
          "elbo_bwd_groups", "elementwise_kernel"}
# the port's kernel each of the program's launch counters counts
COUNTER_KERNEL = {"count_encode": "count_encode",
                  "count_encode_bwd": "count_encode_bwd",
                  "lse": "nb_lse", "value": "nb_value",
                  "valgrad": "nb_valgrad", "finish": "nb_finish",
                  "elbo_fwd": "nb_elbo_fwd", "elbo_bwd": "nb_elbo_bwd"}


def classify(name: str) -> tuple[str, bool]:
    """(the port's kernel, or "nccl" or "torch"; whether it is a stage
    1) of a device event's name."""
    for sym, kernel in PORT_KERNELS:
        if re.search(rf"\(anonymous namespace\)::{sym}[<(]", name):
            return kernel, sym in STAGE1
    if "nccl" in name.lower():
        return "nccl", False
    return "torch", False


@dataclass
class Reading:
    """One traced sub-window: its length and replays, the device time
    by kernel name and by class, the union of the device's busy
    intervals, the idle gaps with what the host was doing, and the
    launch counters the replays booked."""

    window_s: float
    batches: int
    replays: int
    busy_s: float = 0.0
    by_name: dict = field(default_factory=dict)   # name: seconds
    by_kernel: dict = field(default_factory=dict)  # port kernel: seconds
    stage1: dict = field(default_factory=dict)    # port kernel: launches
    gaps: list = field(default_factory=list)      # (seconds, host op)
    counters: dict = field(default_factory=dict)  # counter: launches
    notes: list = field(default_factory=list)
    extra: dict = field(default_factory=dict)     # what the driver adds

    def kernel_s(self, kind: str) -> float:
        """Seconds of one class: "port" (the hand-written kernels),
        "nccl" or "torch"."""
        if kind == "port":
            return sum(v for k, v in self.by_kernel.items()
                       if k not in ("nccl", "torch"))
        return self.by_kernel.get(kind, 0.0)


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


SPIN = "spin_kernel"


def _short(name: str, n: int = 90) -> str:
    name = name[5:] if name.startswith("void ") else name
    return name[:n]


def reduce_events(events, reading: Reading, gaps: int = 10) -> Reading:
    """Fill ``reading`` from a finished profile's events
    (``prof.events()``: each with ``name``, ``device_type`` and
    ``time_range`` in microseconds).  Where the trace holds spin kernels,
    ``window_s`` becomes the sum of the spans from each spin's end to
    the last device event before the next spin, and the device events
    before the first spin are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host, spins = [], [], []
    for ev in events:
        a, b = ev.time_range.start, ev.time_range.end
        if ev.device_type == cuda:
            if ev.name == "Activity Buffer Request":
                continue
            if SPIN in ev.name:
                spins.append((a, b))
                continue
            dev.append((a, b, ev.name))
        elif b > a:
            host.append((a, b, ev.name))
    if spins:
        spins.sort()
        dev = [d for d in dev if d[0] >= spins[0][1]]
        bounds = [s[1] for s in spins]
        last = [None] * len(bounds)
        for a, b, _ in dev:
            i = bisect.bisect_right(bounds, a) - 1
            last[i] = b if last[i] is None else max(last[i], b)
        reading.window_s = sum(e - s for s, e in zip(bounds, last)
                               if e is not None) * 1e-6
        late = max((min(d[0] for d in dev if d[0] >= s) - s
                    for s in bounds if any(d[0] >= s for d in dev)),
                   default=0.0)
        if late > 100.0:
            reading.notes.append(f"trace: a replay began {late:.1f} us after "
                                 f"its spin ended")
    for a, b, name in dev:
        s = (b - a) * 1e-6
        reading.by_name[name] = reading.by_name.get(name, 0.0) + s
        kernel, first = classify(name)
        reading.by_kernel[kernel] = reading.by_kernel.get(kernel, 0.0) + s
        if first:
            reading.stage1[kernel] = reading.stage1.get(kernel, 0) + 1
    busy = _union([(a, b) for a, b, _ in dev])
    reading.busy_s = sum(b - a for a, b in busy) * 1e-6
    ends = sorted((b, name) for _, b, name in dev)
    starts = sorted((a, name) for a, _, name in dev)
    end_t, start_t = [e[0] for e in ends], [e[0] for e in starts]
    spin_ends = sorted(s[1] for s in spins)
    idle = []
    for i in range(len(busy) - 1):
        a, b = busy[i][1], busy[i + 1][0]
        # a gap that holds a spin is the harness's, not the card's
        j = bisect.bisect_right(spin_ends, b)
        if j and spin_ends[j - 1] > a:
            continue
        idle.append((b - a, a, b))
    idle.sort(reverse=True)
    for length, a, b in idle[:gaps]:
        mid = 0.5 * (a + b)
        inside = [(e - s, n) for s, e, n in host if s <= mid <= e]
        what = min(inside)[1] if inside else "no host op"
        i, j = bisect.bisect_right(end_t, a), bisect.bisect_left(start_t, b)
        before = ends[i - 1][1] if i else "?"
        after = starts[j][1] if j < len(starts) else "?"
        reading.gaps.append((length * 1e-6, f"host {what[:40]}: "
                             f"{_short(before, 75)} -> {_short(after, 75)}"))
    return reading


def check_launches(reading: Reading) -> list:
    """Lines naming each port kernel whose stage-1 launches in the trace
    differ from what the launch counters booked for the same replays
    (a replay trace that lost kernels)."""
    booked: dict = {}
    for name, n in reading.counters.items():
        kernel = COUNTER_KERNEL.get(name.split(".")[0])
        if kernel is not None:
            booked[kernel] = booked.get(kernel, 0) + n
    out = []
    for kernel in sorted(set(booked) | set(reading.stage1)):
        seen, want = reading.stage1.get(kernel, 0), booked.get(kernel, 0)
        if seen != want:
            out.append(f"trace: {kernel} launched {seen} times in the trace, "
                       f"the counters booked {want}")
    return out


def breakdown(reading: Reading, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps, in seconds."""
    ops = sorted(reading.by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[w[:200], s] for s, w in reading.gaps[:top]]}
