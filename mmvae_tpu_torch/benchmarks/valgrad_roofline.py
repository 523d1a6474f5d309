"""Roofline of the NB valgrad kernel K2 on the card: the port of
``benchmarks/valgrad_roofline.py``.

K2 (``csrc/nb_valgrad.cu``, the grad-only NB instance every packed boot
step runs, and its JOINT, VALUE and JOINT VALUE instances) is measured
against "f32 operations / 67 TFLOP/s", which
counts an ``expf``, a ``logf`` or a divide like one FMA; each is a
multi-instruction sequence around one special-function op.  This script
turns the bound into arithmetic:

1. measures the achieved per-element cost of each op class K2 uses
   (fma, exp, log, div, select) with the probe kernel P1
   (``csrc/roofline_probe.cu``) at the earlier K2's geometry, by the slope of
   its time between two repetition counts (fixed cost cancels), for one
   dependency chain (latency-bound) and four independent ones
   (issue-bound);
2. multiplies those costs by each K2 instance's op mix, counted per
   source line below;
3. compares the bracket with K2's measured time, alone (one K1 gives its
   normaliser), its two stages apart.

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


# Op mix of K2's, K6's and K3's compile-time instances (csrc/nb_valgrad.cu
# valgrad_tiles, nb_value.cu value_tiles, nb_finish.cu finish_tiles
# with (R, C, Rn) = (2, 1, 1), int8 counts) and of K7, K7c and K8
# (nb_elbo.cu) in the counts <= 7 regime, per (row, column) element.  An arithmetic operator, comparison, select,
# fminf / fmaxf / fabsf or conversion is 1; a * b + c, which nvcc contracts
# into one FFMA, is 1; a negation is an operand modifier, 0; loads are not
# priced.  Lines of nb_valgrad.cu unless named (cuh = nb_step_common.cuh).
# NB grad-only (JOINT = VALUE = false):
#   the count's conversion (392): 1;  h (396-402): 3 FFMA + the bias add 4;
#   h - lse (241): 1;  mu FFMA (243): 1;  nu_pre (403-408): FFMA + add 2;
#   fabsf (246): 1;  fmaxf + add (247): 2;  nu clip + EPS (248): 3;
#   dg_term (249, cuh 187) -> fast_products<true, false> (cuh 144): 7 x
#   (compare, nu + k, FFMA + select of dP, multiply + select of P) 42;
#   the shared divide (251-261): mn, v, u, u * v 4, r 1, sig compare +
#   multiply + select 3, rec * u 1 = 9;  inv_mn, inv_mu (263-264): 2;
#   nu * inv_mn (265): 1;  t (266): 2;  dmu FFMA (267): 1;  dls (268): 2;
#   dnu (269): 3;  dnp compares + and + multiply + select (275): 5;  the
#   D-edge selects of dls and dnp (412-413): 2;  the column sums
#   (415-422): 3 FFMA + add + FFMA + add 6;  the lane's row sums
#   (423-428): add + 3 FFMA 4;  the row's four sums over the warp
#   (431-445): 6 SHFL + 6 adds + 6 selects + the store's test ~20 a row
#   and lane, for its 2 counts, 10 (SHFL priced here as ALU ops);  the
#   row's loads, addresses and loop (359-389): ~20 a row and lane, 10;
#   the regime scan (338, tile_regime): 16-byte loads and ORs over all B
#   rows in each of the 5 row chunks of B = 100, ~2
#   = 116, with 2 exp (h - lse 241, -|nu_pre| 246), 2 log (log1pf 247;
#   logf 265 at the log1p rate) and 2 divides (258; dP / P, cuh 191).
# JOINT (pb, exp-nu): no fabsf / softplus / sigmoid: pe 1 (242), nu min +
#   EPS 2 (248, cuh exp_nu), the divide mn, v 2 (251-255), dnp compare +
#   multiply + select 3 (273): 104, with 2 exp (241; exp(nu_pre) 247), 1
#   log (265) and 2 divides (255; dP / P).
# VALUE adds lg_terms<false> (271, cuh 163) -> fast_products<false, false>:
#   7 x (compare, multiply + select of P; nu + k shared with dg_term) 21,
#   mu * inv_mn 1, the FFMAs with x and nu 2, the edge select and the add
#   into the thread's value (414) 2: +26 ALU and +2 log (-log P,
#   log(mu * inv_mn)).
#
# K6's compile-time instances (nb_value.cu value_tiles, (2, 1, 1), int8,
# with_const, the reporting pass), counted the same way:
#   the count's conversion (193): 1;  h (180-181): 4;  h - lse (90): 1;
#   mu FFMA (92): 1;  nu_pre (183-184): 2;  softplus fabsf, fmaxf + add
#   (97): 3;  the nu clip + EPS (98): 3;  mu + nu (100): 1;
#   lg_terms<true> (101, cuh 159) -> fast_products<false, true> (cuh
#   134): 7 x (compare, nu + k, multiply + select of P) 28 and 6 x
#   (compare, multiply + select of Pc) 18;  the two log differences and
#   their FFMAs (101-102): 4;  the D-edge test, select and add into the
#   thread's value (194): 3;  the row's loads, addresses and loop
#   (158-176), fewer than K2's (no row outputs): ~8;  the regime scan
#   (155): ~2  = 79, with 2 exp (90; -|nu_pre| 97), 5 log (log1pf 97,
#   mu + nu 100, mu and nu 101-102, Pc / P cuh 159) and 1 divide (Pc / P).
# K6p (JOINT): p * exp(pb) 1 (91); nu = min(exp(nu_pre), NU_HI) + EPS
#   2 (95, cuh exp_nu) in place of the softplus 3 and the clip 3: 76,
#   with 2 exp (90; exp(nu_pre) 95), 4 log and 1 divide.
# K3's compile-time instance (nb_finish.cu finish_tiles, (2, 1)): h
#   (153-154) 4;  h - lse 1;  the D-edge compare + select (155) 2;
#   p * rsum (156) 1;  the column sums (158-159) 3 FFMA + add 4;  u2's
#   terms (161) 2;  the row's two sums over the warp (164-172): 5 SHFL +
#   5 adds + 2 selects + the store's test ~14 a row and lane, for its 2
#   columns, 7;  the row's loads, addresses and loop (137-145): ~4  = 25,
#   with 1 exp (155).
# K7's stage 1 (nb_elbo.cu elbo_fwd_rows, int8, on-chip instance), the
# same way, lines of nb_elbo.cu:
#   pass 0 (180-189): the count's conversion 1, fmaxf 1, the regime scan
#   (184, cuh RegimeScan::add: floorf, the integer compare, the range
#   compares and their ANDs) 8, the loop and the shared-memory addresses
#   ~4  = 14;  the sum of exp (194-195): h - max, the add, the loop ~3
#   = 5;  pass 1 (230-238): the loop and addresses ~4;  count_terms
#   (131-143): h - lse 1;  mu FFMA 1;  softplus fmaxf + add 2;  the nu
#   clip + EPS 3;  mn, mu * mn, inv_mn, inv_mu 4;  t 2;  dmu * p FFMA +
#   multiply 2;  lg_terms<false> (cuh 157) -> fast_products<false,
#   false>: 7 x (compare, nu + k, multiply + select of P) 28;  the two
#   log ratios' multiplies and FFMAs (142-143) 4;  the two sums (237-238)
#   2  = 72, with 3 exp (195; 131; -|nu_pre| 133), 4 log (log1pf 133,
#   -log P cuh 158, mu * inv_mn and nu * inv_mn 142-143) and 1 divide
#   (137).
# K7c (CONST): fast_products' 6 x (compare, multiply + select of Pc)
#   (cuh 147-148) 18 and log(Pc / P)'s divide (cuh 158): 90, 3 exp, 4 log,
#   2 divides.
# K8 (nb_elbo.cu elbo_bwd_groups, int8, 16-byte loads), per count:
#   the count's conversion (354) 1;  the thread's index and addresses
#   (339-343, for its 4 counts) 3;  the regime scan and the two votes
#   (372-378) 9;  the row's scalars (379-382) 1;  count_bwd (298-319):
#   h - lse 1;  mu FFMA 1;  softplus fmaxf + add 2;  the nu clip + EPS 3;
#   the regime test 1;  dg_term (cuh 179) -> fast_products<true, false>:
#   7 x (compare, nu + k, FFMA + select of dP, multiply + select of P)
#   42;  the shared divide (306-312) 9, as K2's;  inv_mn, inv_mu 2;  t
#   2;  dmu FFMA 1;  dh 4;  d: nu * inv_mn and 3 adds 4;  dnu's compares,
#   AND, two multiplies and select 6  = 92, with 2 exp (298, 300), 2 log
#   (log1pf 301, 318) and 2 divides (dP / P cuh 180, 309).
OP_MIX = {                          # (ALU, exp, log, div) an element
    "nb_valgrad": (116, 2, 2, 2),
    "nb_valgrad[pb,nu_exp]": (104, 2, 1, 2),
    "nb_valgrad[value]": (142, 2, 4, 2),
    "nb_valgrad[pb,nu_exp,value]": (130, 2, 3, 2),
    "nb_value": (79, 2, 5, 1),
    "nb_value[pb,nu_exp]": (76, 2, 4, 1),
    "nb_finish": (25, 1, 0, 0),
    "nb_elbo_fwd": (72, 3, 4, 1),
    "nb_elbo_fwd[const]": (90, 3, 4, 2),
    "nb_elbo_bwd": (92, 2, 2, 2),
}
ALU_OPS, EXP_OPS, LOG_OPS, DIV_OPS = OP_MIX["nb_valgrad"]


def op_mix_prediction(rates: dict, n_elem: int,
                      kernel: str = "nb_valgrad") -> tuple[float, dict]:
    """(seconds, {class: seconds}) of the op mix of the step kernel
    instance ``kernel`` (a key of :data:`OP_MIX`: K2's, K6's, K3's, K7's
    or K8's) at the per-element costs
    ``rates``: the exp / log / div probes carry one FMA each (the
    bounded-value FMA or add), which is subtracted; the ALU rate is the
    better of the fma probe and half the select probe (a select op is a
    compare and a select)."""
    alu, n_exp, n_log, n_div = OP_MIX[kernel]
    r = dict(rates)
    for k in ("exp", "log", "div"):
        r[k] = max(r[k] - r["fma"], 0.0)
    alu_eff = min(r["fma"], r["select"] / 2)
    parts = {"ALU": alu * alu_eff, "exp": n_exp * r["exp"],
             "log": n_log * r["log"], "div": n_div * r["div"]}
    parts = {k: v * n_elem for k, v in parts.items()}
    return sum(parts.values()), parts


def valgrad_inputs(device, joint: bool = False):
    """K2's isolated inputs at the main-path shape (numpy seed 0): int8
    Poisson(1.0) counts, latents, covariate ones, depth, weight rows;
    ``joint`` appends a pb row (the JOINT instances' W)."""
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
    pb = (rng.normal(size=D) * 0.01).astype(f32) if joint else None
    W = ns.stack_rows(*(torch.from_numpy(v).to(device) for v in (
        wd, wc, np.zeros(D, f32), wn, np.zeros(D, f32))),
        None if pb is None else torch.from_numpy(pb).to(device))
    t["W"], t["R"], t["C"], t["Rn"] = W, R, C, Rn
    return t, x


def block_regimes(x: np.ndarray) -> dict:
    """Share of K2's regime tiles (64 columns x all rows of integer
    counts) in each lgamma regime: every count <= 7, all integer, or
    general."""
    n = -(-x.shape[1] // 64)
    fast = sum(int(x[:, j * 64:(j + 1) * 64].max() <= 7) for j in range(n))
    return {"counts <= 7": fast / n, "integer": (n - fast) / n,
            "general": 0.0, "blocks": n}


def measure_valgrad(joint: bool = False, need_value: bool = False) -> dict:
    """K2 alone through ``ops.nb_step.valgrad`` (grad-only NB by default;
    ``joint`` / ``need_value`` pick the other instances) with ``lse`` from
    one K1: profiler device ms of stage 1 (``valgrad_tiles``), stage 2
    (``valgrad_sum``) and the whole call, CUDA-event ms per call over
    LAUNCHES back-to-back calls, and the regime shares."""
    from ..ops import nb_step as ns

    t, x_np = valgrad_inputs("cuda", joint)
    R, C, Rn = t["R"], t["C"], t["Rn"]
    lse = ns.lse(t["zc"], t["W"], R, C)

    def call():
        return ns.valgrad(t["x"], t["zc"], t["zn"], t["depth"], lse,
                          t["W"], R, C, Rn, joint, need_value)

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

    def stage(name):
        return sum(us for k, (us, _) in kt.items() if name in k) / n / 1e3

    return {"kernel_ms": stage("valgrad_tiles"),
            "sum_ms": stage("valgrad_sum"),
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
    of the built K2 instance the probe prices (stage 1, int8, (R, C, Rn)
    = (2, 1, 1) at compile time, NB, grad-only), whole function, from
    ``cuobjdump -sass``."""
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
                 if s.startswith("_ZN") and "valgrad_tilesIaLi2ELi1ELi1ELb0ELb0E"
                 in s.split("\n", 1)[0]), None)
    if body is None:
        return "cuobjdump: valgrad_tiles<int8, 2, 1, 1, NB, grad-only> not found"
    ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", body)
    mufu = sorted(m for m in re.findall(r"MUFU\.(\w+)", body))
    return (f"SASS of valgrad_tiles<int8, 2, 1, 1, NB, grad-only> (whole "
            f"function, cuobjdump): {len(ins)} instructions, "
            f"{sum(i.startswith('FFMA') for i in ins)} FFMA, "
            f"{sum(i.startswith('SHFL') for i in ins)} SHFL, "
            f"{len(mufu)} MUFU ({', '.join(mufu)})")


def main() -> dict:
    """Print the probe's per-op costs, the op-mix bracket of every K2, K6,
    K3, K7 and K8 instance of :data:`OP_MIX` and K2's
    measured time on the card; returns them."""
    if not torch.cuda.is_available():
        raise RuntimeError("valgrad_roofline measures the CUDA card: no "
                           "CUDA device is available")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(f"geometry: P1's blocks of 64 columns x 4 row groups over "
          f"({B}, {D}) float32, {-(-D // 64)} blocks (the earlier K2's "
          f"layout)")
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
    print(f"\nThe op mix per element of K2, K6, K3, K7 and K8 (ALU, exp, "
          f"log with logf at the log1p rate, div) over {B}x{D} elements, "
          f"issue-bound ILP=4 / "
          f"latency-bound ILP=1:")
    res["brackets_us"] = {}
    for kernel, mix in OP_MIX.items():
        preds = {}
        for ilp in (4, 1):
            preds[ilp], parts = op_mix_prediction(rates[ilp], n_elem, kernel)
        res["brackets_us"][kernel] = (preds[4] * 1e6, preds[1] * 1e6)
        print(f"  {kernel}: {mix}: {preds[4] * 1e6:.2f} / "
              f"{preds[1] * 1e6:.2f} us ("
              + ", ".join(f"{k} {v * 1e6:.2f}" for k, v in parts.items())
              + " us at ILP 1)")
    res["bracket_us"] = res["brackets_us"]["nb_valgrad"]

    print(sass_counts())
    res["k2_all"] = {}
    for kernel, joint, value in (
            ("nb_valgrad", False, False),
            ("nb_valgrad[pb,nu_exp]", True, False),
            ("nb_valgrad[value]", False, True),
            ("nb_valgrad[pb,nu_exp,value]", True, True)):
        k2 = measure_valgrad(joint, value)
        res["k2_all"][kernel] = k2
        lo, hi = res["brackets_us"][kernel]
        print(f"{kernel} alone (int8 Poisson(1.0), numpy seed 0) [{card}]: "
              f"valgrad_tiles {k2['kernel_ms'] * 1e3:.2f} us + valgrad_sum "
              f"{k2['sum_ms'] * 1e3:.2f} us device (profiler), the call "
              f"{k2['call_ms'] * 1e3:.2f} us, {k2['events_ms'] * 1e3:.2f} "
              f"us of wall a call over {LAUNCHES} back-to-back calls (CUDA "
              f"events: the wrapper's host time where above the device's); "
              f"op mix [ILP 4, ILP 1] [{lo:.2f}, {hi:.2f}] us, "
              f"{lo / k2['kernel_ms'] / 1e3:.1%} / "
              f"{hi / k2['kernel_ms'] / 1e3:.1%} of stage 1")
    res["k2"] = res["k2_all"]["nb_valgrad"]
    reg = res["k2"]["regimes"]
    print(f"regime tiles of the counts: <= 7 {reg['counts <= 7']:.1%}, "
          f"integer {reg['integer']:.1%}, general {reg['general']:.1%} of "
          f"{reg['blocks']}")
    return res


if __name__ == "__main__":
    main()
