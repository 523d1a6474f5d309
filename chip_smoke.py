#!/usr/bin/env python3
"""Drive the PyTorch port (``mmvae_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, and the script
exits non-zero without the final line):

0. device: require CUDA; print the card's name and power limit
   (``nvidia-smi``), which tag every number printed after it;
1. build: compile every kernel of the port from ``mmvae_tpu_torch/csrc``
   with nvcc for sm_90a;
2. kernel against plain: ``count_encode`` on the card against its plain
   PyTorch version at the serving shapes, with times;
3. chunk invariance: one launch over 1600 rows equals 16 launches of 100
   rows, bitwise;
4. the serving CLI end to end (the main path) on a synthetic
   4000 x 20000 matrix and a random D=20000 NB-VAE checkpoint, resident
   and streaming;
5. full-size serving sweep: 100,000 x 20,000 int8 counts on the card.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
D_GENES = 20000
TOL = "|kernel - plain| <= 1e-5 * S + 1e-6, S = |log1p x| @ |WL|^T (|x| @ |WX|^T)"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, reps: int = 200) -> float:
    """Milliseconds per call: CUDA events around ``reps`` back-to-back
    calls after warm-ups (what a loop of such calls pays; equals the
    device time when the device, not the host, is the bottleneck)."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_profile(fn, reps: int = 1):
    """(device ms per call, {kernel name: device ms per call}) of the
    kernels ``fn`` runs on the card, from torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.name != "Activity Buffer Request"):
            per[ev.name] = per.get(ev.name, 0.0) + ev.device_time_total
    per = {k: v / reps / 1e3 for k, v in per.items()}
    return sum(per.values()), per


def make_counts(g: torch.Generator, M: int, D: int, dtype) -> torch.Tensor:
    """Seeded counts on the card: Poisson around a log-normal gene
    profile (~1.5 mean), clipped to the dtype; float32 gets non-integer
    values."""
    if dtype == torch.float32:
        u = torch.rand((M, D), generator=g, device="cuda")
        return -torch.log1p(-u) * 3.0
    prof = torch.exp(torch.randn((1, D), generator=g, device="cuda"))
    rate = (prof / prof.mean() * 1.5).expand(M, D).contiguous()
    x = torch.poisson(rate, generator=g)
    hi = 127 if dtype == torch.int8 else 32767
    return x.clamp_(max=hi).to(dtype)


def scaled_err(got, want, S):
    """(max |got - want|, max ratio to the tolerance)."""
    err = (got.double() - want.double()).abs()
    return err.max().item(), (err / (1e-5 * S + 1e-6)).max().item()


def phase_kernels(enc, card):
    cases = [(100, 20000, 2, 2, torch.int8), (100, 20000, 2, 2, torch.int16),
             (100, 20000, 2, 2, torch.float32), (37, 1003, 5, 0, torch.int8),
             (1600, 20000, 2, 0, torch.int8),
             (100, 20000, 24, 2, torch.int16)]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    times = {}
    log(f"[phase 2] count_encode kernel vs plain (f32, TF32 off); {TOL}")
    for M, D, r1, r2, dt in cases:
        x = make_counts(g, M, D, dt)
        WL = torch.randn((r1, D), generator=g, device="cuda") * 0.1
        WX = (torch.randn((r2, D), generator=g, device="cuda") * 0.01
              if r2 else None)
        hL, hX = enc.count_encode(x, WL, WX)
        eL, eX = enc.count_encode_ref(x, WL, WX)
        torch.cuda.synchronize()
        xf = x.double()
        e1, q1 = scaled_err(hL, eL, xf.log1p().abs() @ WL.double().abs().T)
        e2, q2 = (scaled_err(hX, eX, xf.abs() @ WX.double().abs().T)
                  if r2 else (0.0, 0.0))
        if not (q1 <= 1.0 and q2 <= 1.0):
            raise AssertionError(f"kernel disagrees at {(M, D, r1, r2, dt)}: "
                                 f"err/tol {q1:.3g}, {q2:.3g}")
        worst = max(worst, e1, e2)
        k_ms = cuda_ms(lambda: enc.count_encode(x, WL, WX))
        p_ms = cuda_ms(lambda: enc.count_encode_ref(x, WL, WX))
        k_dev, _ = device_profile(lambda: enc.count_encode(x, WL, WX), 20)
        p_dev, _ = device_profile(lambda: enc.count_encode_ref(x, WL, WX),
                                  20)
        times[(M, D, r1, r2, dt)] = (k_dev, p_dev)
        log(f"[phase 2] [{card}] M={M} D={D} r1={r1} r2={r2} "
            f"{str(dt).replace('torch.', '')}: max_abs_err hL {e1:.3g} "
            f"hX {e2:.3g} (err/tol {max(q1, q2):.3g}); per call "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; device time "
            f"kernel {k_dev:.4f} ms, plain {p_dev:.4f} ms")
    main_shape = (1600, 20000, 2, 0, torch.int8)  # the serving sweep's launch
    return worst, times[main_shape]


def phase_chunks(enc):
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = make_counts(g, 1600, D_GENES, torch.int8)
    W = torch.randn((2, D_GENES), generator=g, device="cuda") * 0.1
    one, _ = enc.count_encode(x, W)
    parts = torch.cat([enc.count_encode(x[i:i + 100], W)[0]
                       for i in range(0, 1600, 100)])
    f32, _ = enc.count_encode(x.float(), W)
    torch.cuda.synchronize()
    if not torch.equal(one, parts):
        raise AssertionError("1 launch x 1600 rows != 16 launches x 100 rows")
    if not torch.equal(one, f32):
        raise AssertionError("int8 and float32 storage of the same counts "
                             "differ")
    log("[phase 3] 1 launch x 1600 rows == 16 launches x 100 rows, bitwise; "
        "int8 == float32 storage, bitwise")


def plain_encode(params, x):
    """Independent plain reference of NBVAE.encode_mu (default
    architecture): the unfolded standardization, as the JAX model
    writes it."""
    sd = torch.nn.functional.softplus(params["ln_x_sd"]) + 1e-4
    xn = (torch.log1p(x.float()) - params["x_mean"]) / sd
    h = xn @ params["mu_encoding"]["weight"] + params["mu_encoding"]["bias"]
    lin = lambda n: h @ params[n]["weight"] + params[n]["bias"]  # noqa: E731
    S = ((torch.log1p(x.double()) + params["x_mean"].double().abs())
         @ (params["mu_encoding"]["weight"].double().abs() / sd.double().T)
         + params["mu_encoding"]["bias"].double().abs())
    bound = {n: S @ params[n]["weight"].double().abs()
             + params[n]["bias"].double().abs()
             for n in ("mu_representation_mean",
                       "mu_representation_logvariance")}
    return (lin("mu_representation_mean"),
            lin("mu_representation_logvariance").clamp(-4.0, 4.0), bound)


def random_params(model, device):
    """Seeded params with non-trivial learned standardization."""
    params = model.init(torch.Generator().manual_seed(SEED), device=device)
    g = torch.Generator().manual_seed(SEED + 1)
    D = model.data_dim
    params["x_mean"] = torch.rand((1, D), generator=g).to(device) * 1.5
    params["ln_x_sd"] = (torch.randn((1, D), generator=g) * 0.5).to(device)
    return params


class _Tee(io.TextIOBase):
    def __init__(self, sink):
        self.sink, self.buf = sink, io.StringIO()

    def write(self, s):
        self.sink.write(s)
        return self.buf.write(s)

    def flush(self):
        self.sink.flush()


def run_cli(encode, args):
    tee = _Tee(sys.stderr)
    with contextlib.redirect_stderr(tee):
        rc = encode.main(args)
    if rc != 0:
        raise AssertionError(f"encode CLI exited {rc}")
    return tee.buf.getvalue()


def read_mtx_dense(path: str) -> np.ndarray:
    """(cells, genes) float32 counts from a coordinate MatrixMarket file,
    parsed with plain numpy: a reference independent of the port's
    reader."""
    with gzip.open(path, "rt") as f:
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        D, N, nnz = map(int, line.split())
        trip = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if len(trip) != nnz:
        raise AssertionError(f"{path}: {len(trip)} triplets, header {nnz}")
    x = np.zeros((N, D), np.float32)
    x[trip[:, 1].astype(np.int64) - 1, trip[:, 0].astype(np.int64) - 1] = (
        trip[:, 2])
    return x


def phase_cli(card):
    from mmvae_tpu_torch.cli import encode, make_synthetic
    from mmvae_tpu_torch.models.nb import NBVAE
    from mmvae_tpu_torch.ops import enc_kernel
    from mmvae_tpu_torch.train.checkpoint import save_checkpoint

    N = 4000
    with tempfile.TemporaryDirectory() as tmp:
        mtx = os.path.join(tmp, "syn.mtx.gz")
        t0 = time.time()
        make_synthetic.main(["--out", mtx, "--genes", str(D_GENES),
                             "--cells", str(N), "--depth_mean", "1000",
                             "--seed", str(SEED), "--index"])
        log(f"[phase 4] synthetic {N} x {D_GENES} matrix in "
            f"{time.time() - t0:.1f}s (host)")
        model = NBVAE(data_dim=D_GENES)
        params = random_params(model, "cuda")
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, params, epoch=0, seed=SEED)
        args = ["--model", "nb", "--mtx", mtx, "--checkpoint", ckpt,
                "--batch_size", "100", "--device", "cuda"]

        enc_kernel.count_encode.launches = 0
        t0 = time.time()
        err = run_cli(encode, args + ["--out", os.path.join(tmp, "res")])
        wall = time.time() - t0
        launches = enc_kernel.count_encode.launches
        if "dense-resident" not in err:
            raise AssertionError("resident sweep did not run")
        if launches < 1:
            raise AssertionError("main path launched no count_encode kernel")
        fill = [ln for ln in err.splitlines() if "dense fill:" in ln][-1]
        rate = [ln for ln in err.splitlines() if "cells/sec" in ln][-1]
        log(f"[phase 4] host reader: {fill.split('] ', 1)[-1]}")
        log(f"[phase 4] [{card}] resident CLI: {launches} count_encode "
            f"launches; {rate.split('] ', 1)[-1]}; CLI wall {wall:.2f}s")

        res = [np.loadtxt(os.path.join(tmp, f"res.mu_{k}.gz"), ndmin=2)
               for k in ("mean", "lnvar")]
        for a in res:
            if a.shape != (N, 2) or not np.isfinite(a).all():
                raise AssertionError(f"bad output {a.shape}")
        # plain-version reference on the card from the same counts
        with torch.inference_mode():
            x = torch.from_numpy(read_mtx_dense(mtx)).to("cuda")
            rm, rl, bound = plain_encode(params, x)
        worst = 0.0
        for got, want, n in ((res[0], rm, "mu_representation_mean"),
                             (res[1], rl, "mu_representation_logvariance")):
            want = want.double().cpu().numpy()
            lim = (1e-5 * bound[n].cpu().numpy() + 1e-6
                   + 1e-5 * np.abs(want))  # + %g text rounding (6 digits)
            ratio = np.max(np.abs(got - want) / lim)
            worst = max(worst, ratio)
            if not ratio <= 1.0:
                raise AssertionError(f"{n}: CLI output vs plain err/tol "
                                     f"{ratio:.3g}")
        log(f"[phase 4] outputs ({N}, 2), finite, match the plain encode "
            f"(err/tol {worst:.3g}; tol 1e-5*S + 1e-6 + 1e-5*|ref|)")

        os.environ["MMVAE_DENSE_BYTES"] = "1"
        try:
            t0 = time.time()
            err = run_cli(encode, args + ["--out", os.path.join(tmp, "str")])
        finally:
            del os.environ["MMVAE_DENSE_BYTES"]
        if "resident fast path skipped" not in err:
            raise AssertionError("streaming sweep did not run")
        for k, a in zip(("mean", "lnvar"), res):
            b = np.loadtxt(os.path.join(tmp, f"str.mu_{k}.gz"), ndmin=2)
            if not np.array_equal(a, b):
                raise AssertionError(f"streaming mu_{k} != resident")
        log(f"[phase 4] [{card}] streaming CLI equals resident bitwise "
            f"(CLI wall {time.time() - t0:.2f}s)")
    return launches


def phase_full(card):
    from mmvae_tpu_torch.models.nb import NBVAE
    from mmvae_tpu_torch.train.loop import encode_resident

    N, B, chunk = 100_000, 100, 16
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    prof = torch.exp(torch.randn((1, D_GENES), generator=g, device="cuda"))
    rate = prof / prof.sum() * 1000.0  # ~1000 counts per cell
    data = torch.empty((N, D_GENES), dtype=torch.int8, device="cuda")
    for lo in range(0, N, 10_000):
        r = rate.expand(10_000, D_GENES).contiguous()
        data[lo:lo + 10_000] = torch.poisson(r, generator=g).clamp_(
            max=127).to(torch.int8)
    model = NBVAE(data_dim=D_GENES)
    params = random_params(model, "cuda")
    with torch.inference_mode():
        encode_resident(model, params, data, B, chunk)  # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, lnvar = encode_resident(model, params, data, B, chunk)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        busy, per = device_profile(
            lambda: encode_resident(model, params, data, B, chunk))
        rm, rl, bound = plain_encode(params, data[:1000])
    for got, want, n in ((mean[:1000], rm, "mu_representation_mean"),
                         (lnvar[:1000], rl,
                          "mu_representation_logvariance")):
        _, q = scaled_err(got, want, bound[n])
        if not q <= 1.0:
            raise AssertionError(f"full sweep {n}: err/tol {q:.3g}")
    if not (mean.shape == (N, 2) and torch.isfinite(mean).all()
            and torch.isfinite(lnvar).all()):
        raise AssertionError("full sweep output not finite (N, 2)")
    dt = statistics.median(times)
    log(f"[phase 5] [{card}] resident sweep {N} x {D_GENES} int8, B={B}, "
        f"chunk {chunk}: {N / dt:,.1f} cells/sec (median of 3: "
        f"{', '.join(f'{t * 1e3:.3f}' for t in times)} ms); first 1000 "
        f"rows match the plain encode")
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    log(f"[phase 5] [{card}] one sweep: device busy {busy:.3f} ms of "
        f"{dt * 1e3:.3f} ms wall (idle share {1 - busy / (dt * 1e3):.1%}); "
        + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from mmvae_tpu_torch.ops import _cuda
    from mmvae_tpu_torch.ops import enc_kernel as enc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[phase 0] card: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    t0 = time.time()
    _cuda.build(force=True)
    _cuda.lib()
    log(f"[phase 1] built {', '.join(os.path.relpath(s) for s in _cuda.sources())}"
        f" -> {os.path.relpath(_cuda.LIB_PATH)} in {time.time() - t0:.1f}s")
    with open(_cuda.BUILD_LOG) as f:
        for ln in f.read().splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                log(f"[phase 1] ptxas: {ln.strip()}")

    worst, (k_dev, p_dev) = phase_kernels(enc, card)
    phase_chunks(enc)
    launches = phase_cli(card)
    phase_full(card)

    log(card)
    print(json.dumps({"kernels": [{
        "name": "count_encode", "route": "cuda",
        "source": "mmvae_tpu_torch/csrc/count_encode.cu",
        "replaces": "mmvae_tpu/ops/enc_kernel.py:183",
        "launches": launches, "max_abs_err": worst,
        "ms": k_dev, "plain_ms": p_dev}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
