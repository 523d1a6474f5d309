"""Roofline of the NB valgrad kernel K2 on the card: the port of
``benchmarks/valgrad_roofline.py``.

K2 (``csrc/nb_valgrad.cu``, the grad-only NB instance every packed boot
step runs) is measured against "f32 operations / 67 TFLOP/s", which
counts an ``expf``, a ``logf`` or a divide like one FMA; each is a
multi-instruction sequence around one special-function op.  This script
turns the bound into arithmetic:

1. measures the achieved per-element cost of each op class K2 uses
   (fma, exp, log, div, select) with the probe kernel P1
   (``csrc/roofline_probe.cu``) at K2's own geometry, by the slope of
   its time between two repetition counts (fixed cost cancels), for one
   dependency chain (latency-bound) and four independent ones
   (issue-bound);
2. multiplies those costs by K2's op mix, counted per source line below;
3. compares the bracket with K2's measured time, alone (one K1 gives its
   normaliser).

    python -m mmvae_tpu_torch.benchmarks.valgrad_roofline

Requires a CUDA card; every number it prints is that card's, tagged with
its name and power limit.  :func:`elementwise` is P1's wrapper: a CPU
tensor takes the plain PyTorch version :func:`elementwise_ref`, a CUDA
tensor the kernel (or it raises); ``elementwise.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import os
import re
import shutil
import statistics
import subprocess

import numpy as np
import torch

from ..utils.profiling import card_line, kernel_times

B, D = 100, 20000                    # K2's main-path shape
REPS = (8, 40)                       # the repetition counts of the slope
LAUNCHES = 200                       # back-to-back launches per timing
OPS = ("fma", "exp", "log", "div", "select")
_OP_CODE = {name: i for i, name in enumerate(OPS)}
# the kernel's compiled (nrep, chains) instances
_INSTANCES = {(n, c) for n in (2, 8, 40) for c in (1, 4)}

# the JAX probe's five op classes (benchmarks/valgrad_roofline.py:169-175)
_PLAIN = {
    "fma": lambda y: y * 0.9999 + 1e-4,
    "exp": lambda y: torch.exp(-y) * 0.5 + 0.25,
    "log": lambda y: torch.log1p(y) * 0.8 + 0.1,
    "div": lambda y: 1.0 / (1.0 + y),
    "select": lambda y: torch.where(y > 0.5, y * 0.9, y),
}


def elementwise_ref(x: torch.Tensor, op: str, nrep: int,
                    chains: int = 1) -> torch.Tensor:
    """P1's plain version: ``chains`` copies ``x * (1 + 0.01 i)``, ``op``
    applied ``nrep`` times to each, the chains interleaved, summed."""
    f = _PLAIN[op]
    ys = [x * (1.0 + 0.01 * i) for i in range(chains)]
    for _ in range(nrep):
        ys = [f(y) for y in ys]
    acc = ys[0]
    for y in ys[1:]:
        acc = acc + y
    return acc


def elementwise(x: torch.Tensor, op: str, nrep: int, chains: int = 1,
                reps: int = 1) -> torch.Tensor:
    """P1: :func:`elementwise_ref` of a (B, D) float32 ``x``.  On the card
    the kernel runs ``reps`` times back to back into one output (a
    timing loop with no host time between launches); each launch
    counts."""
    if op not in _OP_CODE:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if x.device.type == "cpu":
        return elementwise_ref(x, op, nrep, chains)
    if x.device.type != "cuda":
        raise ValueError(f"elementwise: no kernel for device {x.device}")
    if (nrep, chains) not in _INSTANCES:
        raise ValueError(f"elementwise: (nrep, chains) = {(nrep, chains)} "
                         f"is not a compiled instance {sorted(_INSTANCES)}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("elementwise: x must be a contiguous 2-D float32 "
                         "tensor")
    out = torch.empty_like(x)
    from ..ops import _cuda

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _cuda.check(_cuda.lib().mmvae_roofline_elementwise(
            x.data_ptr(), x.shape[0], x.shape[1], _OP_CODE[op], nrep, chains,
            reps, out.data_ptr(), stream), "roofline_probe.elementwise")
    elementwise.launches += reps
    return out


elementwise.launches = 0


def probe_input(device, shape=(B, D)) -> torch.Tensor:
    """The probe's input: uniform in [0.1, 0.9) from numpy seed 0."""
    x = np.random.default_rng(0).uniform(0.1, 0.9, shape)
    return torch.from_numpy(x.astype(np.float32)).to(device)


def _events_s(fn) -> float:
    """Seconds of one call of ``fn`` as CUDA events see it."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def measure_op(x: torch.Tensor, op: str,
               chains: int = 1) -> tuple[float, float, float]:
    """(seconds per element per op, seconds per launch at REPS[0] and at
    REPS[1]): CUDA events over LAUNCHES back-to-back launches after
    warm-up, the median of three; the per-op cost is the slope over the
    repetition count divided by ``chains`` (the launch, the read of x and
    the write of the output cancel)."""
    def timed(nrep):
        elementwise(x, op, nrep, chains, reps=10)
        return statistics.median(
            _events_s(lambda: elementwise(x, op, nrep, chains,
                                          reps=LAUNCHES)) / LAUNCHES
            for _ in range(3))

    t_lo, t_hi = timed(REPS[0]), timed(REPS[1])
    per_op = (t_hi - t_lo) / (REPS[1] - REPS[0]) / x.numel() / chains
    return per_op, t_lo, t_hi


# Op mix of K2's NB grad-only instance (csrc/nb_valgrad.cu valgrad_kernel
# with JOINT = VALUE = false: int8 counts, softplus nu, R = 2, C = 1,
# Rn = 1, so NT = 8) in the counts <= 7 regime, per (row, column)
# element.  An arithmetic operator, comparison, select, fminf / fmaxf /
# fabsf or conversion is 1; a * b + c, which nvcc contracts into one
# FFMA, is 1; a negation is an operand modifier, 0; loads are not priced.
# Lines of nb_valgrad.cu unless named (cuh = nb_step_common.cuh):
#   cvt x -> f32 (106): 1;  compute_h (108, cuh 70): 3 FFMA + bias add 4;
#   h - lse (109): 1;  mu FFMA (111): 1;  compute_nupre (112, cuh 83): 2;
#   fabsf (115): 1;  fmaxf + add (116): 2;  nu clip + EPS (117-118): 3;
#   dg_term (119, cuh 187) -> fast_products<true, false> (cuh 144):
#     7 x (compare, nu + k, FFMA + select of dP, multiply + select of P) 42;
#   the shared divide (121-132): mn, v, u, u * v 4, r 1, sig compare +
#     multiply + select 3, rec * u 1 = 9;  inv_mn, inv_mu (133-134): 2;
#   nu * inv_mn (135): 1;  t (136): 2;  dmu FFMA (137): 1;  dls (138): 2;
#   dnu (139): 3;  dnp compares + and + multiply + select (145-146): 5;
#   the per-column accumulators (150-157): 3 FFMA + add + FFMA + add 6;
#   the per-row sums over the warp (161-173, cuh 218 warp_sum): rsum,
#     u1 (R = 2) and dzn (Rn = 1), each 5 shuffles + 5 adds, and 3
#     multiplies by w: 43 (20 of them SHFL, priced here as ALU ops);
#   block_regime (cuh 201), once per element: cvt, 2 compares, the two
#     flag updates 6;  the row loop's counter, test and branch and the
#     per-row addresses (x, depth, lse, zc, zn, the partials): ~10, an
#     estimate
ALU_OPS = (1 + 4 + 1 + 1 + 2 + 1 + 2 + 3 + 42 + 9 + 2 + 1 + 2 + 1 + 2 + 3
           + 5 + 6 + 43 + 6 + 10)           # = 147
EXP_OPS = 2      # expf(h - lse) (109), expf(-|nupre|) (115)
LOG_OPS = 2      # log1pf (116); logf (135), priced at the log1p rate
DIV_OPS = 2      # 1 / (u * v) (128), dP / P (cuh 191)


def op_mix_prediction(rates: dict, n_elem: int) -> tuple[float, dict]:
    """(seconds, {class: seconds}) of K2's op mix at the per-element
    costs ``rates``: the exp / log / div probes carry one FMA each (the
    bounded-value FMA or add), which is subtracted; the ALU rate is the
    better of the fma probe and half the select probe (a select op is a
    compare and a select)."""
    r = dict(rates)
    for k in ("exp", "log", "div"):
        r[k] = max(r[k] - r["fma"], 0.0)
    alu_eff = min(r["fma"], r["select"] / 2)
    parts = {"ALU": ALU_OPS * alu_eff, "exp": EXP_OPS * r["exp"],
             "log": LOG_OPS * r["log"], "div": DIV_OPS * r["div"]}
    parts = {k: v * n_elem for k, v in parts.items()}
    return sum(parts.values()), parts


def valgrad_inputs(device):
    """K2's isolated inputs at the main-path shape (numpy seed 0): int8
    Poisson(1.0) counts, latents, covariate ones, depth, weight rows."""
    from ..ops import nb_step as ns

    rng = np.random.default_rng(0)
    R, C, Rn = 2, 1, 1
    f32 = np.float32
    x = rng.poisson(1.0, (B, D)).astype(np.int8)
    zm = rng.normal(size=(B, R)).astype(f32)
    zn = rng.normal(size=(B, Rn)).astype(f32)
    depth = rng.uniform(100, 1000, (B, 1)).astype(f32)
    wd = (rng.normal(size=(R, D)) * 0.01).astype(f32)
    wc = (rng.normal(size=(C, D)) * 0.01).astype(f32)
    wn = (rng.normal(size=(Rn, D)) * 0.01).astype(f32)
    t = {k: torch.from_numpy(v).to(device) for k, v in dict(
        x=x, zn=zn, depth=depth,
        zc=np.concatenate([zm, np.ones((B, C), f32)], axis=1)).items()}
    W = ns.stack_rows(*(torch.from_numpy(v).to(device) for v in (
        wd, wc, np.zeros(D, f32), wn, np.zeros(D, f32))))
    t["W"], t["R"], t["C"], t["Rn"] = W, R, C, Rn
    return t, x


def block_regimes(x: np.ndarray) -> dict:
    """Share of K2's blocks (64 columns x all rows of integer counts) in
    each lgamma regime: every count <= 7, all integer, or general."""
    n = -(-x.shape[1] // 64)
    fast = sum(int(x[:, j * 64:(j + 1) * 64].max() <= 7) for j in range(n))
    return {"counts <= 7": fast / n, "integer": (n - fast) / n,
            "general": 0.0, "blocks": n}


def measure_valgrad() -> dict:
    """K2 alone, grad-only, through ``ops.nb_step.valgrad`` with ``lse``
    from one K1: profiler device ms of ``valgrad_kernel`` and of the
    whole call (with the row-sum second stage), CUDA-event ms per call
    over LAUNCHES back-to-back calls, and the block regime shares."""
    from ..ops import nb_step as ns

    t, x_np = valgrad_inputs("cuda")
    R, C, Rn = t["R"], t["C"], t["Rn"]
    lse = ns.lse(t["zc"], t["W"], R, C)

    def call():
        return ns.valgrad(t["x"], t["zc"], t["zn"], t["depth"], lse,
                          t["W"], R, C, Rn)

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    events_ms = _events_s(lambda: [call() for _ in range(LAUNCHES)]) * 1e3
    from torch.profiler import ProfilerActivity, profile

    n = 50
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    kt = kernel_times(prof)
    main = sum(us for k, (us, _) in kt.items() if "valgrad_kernel" in k)
    return {"kernel_ms": main / n / 1e3,
            "call_ms": sum(us for us, _ in kt.values()) / n / 1e3,
            "events_ms": events_ms / LAUNCHES,
            "regimes": block_regimes(x_np)}


def _cuobjdump() -> str | None:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    return None


def sass_counts() -> str:
    """A cross-check of the op mix: SASS instruction, MUFU and SHFL counts
    of the built K2 instance the probe prices (int8, NT = 8, NB,
    grad-only), whole function, from ``cuobjdump -sass``."""
    from ..ops import _cuda

    tool = _cuobjdump()
    if tool is None:
        return "cuobjdump not found: no SASS cross-check"
    r = subprocess.run([tool, "-sass", _cuda.build()], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        return f"cuobjdump failed ({r.returncode}): {r.stderr[-200:]}"
    sections = re.split(r"\n\s*Function : ", r.stdout)
    body = next((s for s in sections
                 if s.startswith("_ZN") and "valgrad_kernelIaLi8ELb0ELb0E" in
                 s.split("\n", 1)[0]), None)
    if body is None:
        return "cuobjdump: valgrad_kernel<int8, 8, NB, grad-only> not found"
    ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", body)
    mufu = sorted(m for m in re.findall(r"MUFU\.(\w+)", body))
    return (f"SASS of valgrad_kernel<int8, 8, NB, grad-only> (whole "
            f"function, cuobjdump): {len(ins)} instructions, "
            f"{sum(i.startswith('FFMA') for i in ins)} FFMA, "
            f"{sum(i.startswith('SHFL') for i in ins)} SHFL, "
            f"{len(mufu)} MUFU ({', '.join(mufu)})")


def main() -> dict:
    """Print the probe's per-op costs, K2's op-mix bracket and K2's
    measured time on the card; returns them."""
    if not torch.cuda.is_available():
        raise RuntimeError("valgrad_roofline measures the CUDA card: no "
                           "CUDA device is available")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(f"geometry: K2's blocks of 64 columns x 4 row groups over "
          f"({B}, {D}) float32, {-(-D // 64)} blocks")
    x = probe_input("cuda")
    rates, res = {}, {"card": card}
    for ilp in (1, 4):
        print(f"per-op cost (P1 slope over nrep {REPS[0]} -> {REPS[1]}, "
              f"ILP={ilp}, [{card}]):")
        rates[ilp] = {}
        for name in OPS:
            per_op, t_lo, t_hi = measure_op(x, name, chains=ilp)
            rates[ilp][name] = per_op
            print(f"  {name:8s}: {per_op * 1e12:9.4f} ps/elem "
                  f"({t_lo * 1e6:.2f} -> {t_hi * 1e6:.2f} us a launch)")
    res["rates_ps"] = {ilp: {k: v * 1e12 for k, v in r.items()}
                       for ilp, r in rates.items()}

    n_elem = B * D
    print(f"\nK2's op mix per element: ALU {ALU_OPS}, exp {EXP_OPS}, log "
          f"{LOG_OPS} (logf at the log1p rate), div {DIV_OPS}; over "
          f"{B}x{D} elements (latency-bound ILP=1 / issue-bound ILP=4):")
    preds = {}
    for ilp in (1, 4):
        preds[ilp], parts = op_mix_prediction(rates[ilp], n_elem)
        detail = ", ".join(f"{k} {v * 1e6:.2f} us" for k, v in parts.items())
        print(f"  ILP={ilp}: total {preds[ilp] * 1e6:8.2f} us ({detail})")
    res["bracket_us"] = (preds[4] * 1e6, preds[1] * 1e6)

    print(sass_counts())
    k2 = measure_valgrad()
    res["k2"] = k2
    reg = k2["regimes"]
    print(f"\nK2 alone (grad-only, int8 Poisson(1.0), numpy seed 0) "
          f"[{card}]: valgrad_kernel {k2['kernel_ms'] * 1e3:.2f} us device "
          f"(profiler), the call with its row-sum stage "
          f"{k2['call_ms'] * 1e3:.2f} us, {k2['events_ms'] * 1e3:.2f} us of "
          f"wall a call over {LAUNCHES} back-to-back calls (CUDA events: "
          f"the wrapper's host time where above the device's); blocks "
          f"by regime: counts <= 7 {reg['counts <= 7']:.1%}, integer "
          f"{reg['integer']:.1%}, general {reg['general']:.1%} of "
          f"{reg['blocks']}")
    print(f"op-mix prediction [ILP 4, ILP 1]: [{preds[4] * 1e6:.2f}, "
          f"{preds[1] * 1e6:.2f}] us vs valgrad_kernel "
          f"{k2['kernel_ms'] * 1e3:.2f} us measured "
          f"({preds[4] / k2['kernel_ms'] / 1e-3:.1%}, "
          f"{preds[1] / k2['kernel_ms'] / 1e-3:.1%} of it) [{card}]")
    return res


if __name__ == "__main__":
    main()
