"""Tracing and profiling hooks: the port of ``mmvae_tpu/utils/profiling.py``
on ``torch.profiler``.

Named annotations around the training phases, an on-demand trace of a
block written as a Chrome trace (``MMVAE_TRACE_DIR=/path``, or
:func:`trace` with a directory), a host-side phase timer, and the one
reader of a profile's time by kernel that ``chip_smoke.py`` and
``mmvae_tpu_torch.benchmarks.trace_step`` share.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import time

import torch

from .logging import TLOG


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    first card); raises when ``nvidia-smi`` fails."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def annotate(name: str):
    """Named region in a running torch profiler's trace, on the clock of
    the trace's device events; a null context, which costs nothing, when
    no profiler runs.

    The region is a host op (a record function of function scope, as an
    operator's), not a ``record_function`` user annotation: for a user
    annotation the profiler also writes a device event over the device
    work launched inside it, which a reader of the trace's device events
    would count as the card's work."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return contextlib.nullcontext()
    return torch._C._profiler._RecordFunctionFast(name)


@contextlib.contextmanager
def trace(out_dir: str | None = None):
    """Profile the enclosed block and write it as a Chrome trace
    (``<host>_<pid>_<ns>.trace.json``) under ``out_dir``.

    Uses ``MMVAE_TRACE_DIR`` when *out_dir* is None and yields None
    without tracing if neither is set; otherwise yields the running
    ``torch.profiler.profile`` (CPU activity, and CUDA activity when a
    card is present), whose events :func:`kernel_times` reads once the
    block has ended.
    """
    out_dir = out_dir or os.environ.get("MMVAE_TRACE_DIR")
    if not out_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = profile(activities=acts)
    try:
        with prof:
            yield prof
    finally:
        path = os.path.join(out_dir, f"{socket.gethostname()}_{os.getpid()}"
                                     f"_{time.time_ns()}.trace.json")
        prof.export_chrome_trace(path)
        TLOG("Wrote profiler trace to", path)


def kernel_times(prof) -> dict[str, tuple[float, int]]:
    """{kernel name: (device microseconds, launches)} of a finished
    profile: its CUDA device events summed by name (kernels and copies;
    the profiler's own "Activity Buffer Request" row is left out)."""
    out: dict[str, tuple[float, int]] = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.name != "Activity Buffer Request"):
            us, n = out.get(ev.name, (0.0, 0))
            out[ev.name] = (us + ev.device_time_total, n + 1)
    return out


def host_times(prof) -> dict[str, tuple[float, int]]:
    """{op name: (host self microseconds, calls)} of a finished profile:
    the time each host op spent outside the ops it called, so nested ops
    are not counted twice.  Host time, never a device's."""
    return {ev.key: (ev.self_cpu_time_total, ev.count)
            for ev in prof.key_averages() if ev.self_cpu_time_total > 0}


class StepTimer:
    """Host-side phase timer: accumulates wall time per named phase and
    reports a breakdown (input vs compute vs record)."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt

    def summary(self) -> dict[str, float]:
        return dict(self.totals)

    def reset(self) -> None:
        self.totals.clear()
