"""What feature clustering buys the step kernels on the card: the port of
``benchmarks/perm_probe.py``.

The step kernels K2 (``valgrad``), K6 (``value``) and K3 (``finish``)
walk the genes in 64-column tiles (``nb_step.VALGRAD_TILE``, the tile of
``valgrad_plan``, ``value_plan`` and ``finish_plan``), and K2 and K6
choose one lgamma regime a tile over all B rows of the batch: *fast*
(every count an integer in [0, 7]: exact select-products), *mixed*
(every count a non-negative integer) or *general*.  A few hot genes (a
count > 7) scattered over the genes put every tile they touch on a
slower regime; feature clustering (``train.loop.cluster_features``)
moves them to the tail.  On a count matrix this script prints

1. the hot genes and, per batch of B rows, the share of tiles in each
   regime in input order and in the cold-first order
   (:func:`regime_shares`, a plain function);
2. the device ms a call of K2 (the boot step's grad-only instance), K6
   (the reporting value) and K3 on the same batches in both orders
   (:func:`device_ms`), with random decoder operands from a seed, each
   held against its plain PyTorch version (a sanity check, ``|kernel -
   plain| <= 1e-3 max |plain|`` an output; ``chip_smoke.py`` phase 42
   holds them to phase 6's tolerance).

    python -m mmvae_tpu_torch.benchmarks.perm_probe [data.mtx.gz] \\
        [--batch_size 100] [--batches 8]

Without a matrix it makes the synthetic 4,000 x 20,000 one
(``cli.make_synthetic``, depth 1000, seed 0) in a temporary directory.
Requires a CUDA card; every number it prints is that card's, tagged with
its name and power limit.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from ..data.block import MtxMemoryBlock
from ..data.pipeline import sequential_batches
from ..ops import nb_step as ns
from ..train.loop import build_dense, hot_genes
from ..utils.profiling import card_line

REGIMES = ("fast", "mixed", "general")
WIDTHS = (2, 1, 1)  # (R, C, Rn) of the default NB trainer


def regime_shares(x: torch.Tensor, B: int,
                  tile: int = ns.VALGRAD_TILE) -> dict:
    """{regime: share of the (batch, tile) pairs in it, "pairs": their
    count} of the (N, D) counts ``x`` (any device, genes in the order to
    assess) over the batches of the sequential wrap-around schedule, the
    regime of a tile being the one K2 and K6 choose for it
    (``nbk::tile_regime``)."""
    N, D = x.shape
    nt = -(-D // tile)
    counts = dict.fromkeys(REGIMES, 0)
    for batch in sequential_batches(N, B):
        xb = x.index_select(0, torch.as_tensor(batch, device=x.device))
        xb = torch.nn.functional.pad(xb.float(), (0, nt * tile - D))
        xb = xb.view(len(batch), nt, tile)
        whole = (xb >= 0) & (xb == torch.floor(xb))
        allint = whole.all(dim=2).all(dim=0)
        fast = (whole & (xb <= 7)).all(dim=2).all(dim=0)
        counts["fast"] += int(fast.sum())
        counts["mixed"] += int((allint & ~fast).sum())
        counts["general"] += int((~allint).sum())
    pairs = sum(counts.values())
    return {**{k: v / pairs for k, v in counts.items()}, "pairs": pairs}


def batch_operands(x: torch.Tensor, gen: torch.Generator,
                   widths: tuple = WIDTHS) -> tuple:
    """(zc, zn, depth, W) of a step-kernel call on the (B, D) batch ``x``
    at the trainer's scales: unit latents beside the all-ones covariate,
    library-size depth, decoder rows of a few tenths (``W``: the stacked
    rows ``[wd; wc; bias2; wn; bias_n]``, genes in input order)."""
    R, C, Rn = widths
    B, D = x.shape
    dev = x.device
    zc = torch.randn((B, R + C), generator=gen, device=dev)
    zc[:, R:] = 1.0
    zn = torch.randn((B, Rn), generator=gen, device=dev)
    depth = x.float().sum(1, keepdim=True).contiguous()
    W = torch.randn((R + C + Rn + 2, D), generator=gen, device=dev) * 0.3
    return zc, zn, depth, W.contiguous()


def kernel_calls(x, zc, zn, depth, W, widths: tuple = WIDTHS) -> dict:
    """{kernel: (its wrapper's call, its plain version's call)} of K2
    (grad-only), K6 (with ``lgamma(x + 1)``, the reporting pass) and K3
    (fed the plain K2's row sums) on one batch, the normaliser from the
    plain K1."""
    R, C, Rn = widths
    lr = ns.lse_ref(zc, W, R, C)
    rs = ns.valgrad_ref(x, zc, zn, depth, lr, W, R, C, Rn)[1].contiguous()
    return {
        "nb_valgrad": (lambda: ns.valgrad(x, zc, zn, depth, lr, W, R, C, Rn),
                       lambda: ns.valgrad_ref(x, zc, zn, depth, lr, W, R, C,
                                              Rn)),
        "nb_value": (lambda: ns.value(x, zc, zn, depth, lr, W, R, C, Rn),
                     lambda: ns.value_ref(x, zc, zn, depth, lr, W, R, C, Rn,
                                          True)),
        "nb_finish": (lambda: ns.finish(zc, lr, rs, W, R, C),
                      lambda: ns.finish_ref(zc, lr, rs, W, R, C)),
    }


def device_ms(fn, n: int = 20, replays: int = 5) -> float:
    """Device ms a call: CUDA events around ``replays`` replays of a CUDA
    graph of ``n`` calls, so no host time lies between the launches (at
    these sizes a call's host time exceeds its device time: events around
    plain calls would time the host, and a profiler trace late in a long
    process has been seen to lose kernels)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (replays * n)


def _synthetic(tmp: str) -> str:
    from ..cli import make_synthetic

    mtx = os.path.join(tmp, "syn.mtx.gz")
    make_synthetic.main(["--out", mtx, "--genes", "20000", "--cells", "4000",
                         "--depth_mean", "1000", "--seed", "0", "--index"])
    return mtx


def main(argv=None) -> dict:
    """Print the hot genes, the regime shares in both orders and K2's,
    K6's and K3's times on the first ``--batches`` batches in both
    orders; returns them."""
    if not torch.cuda.is_available():
        raise RuntimeError("perm_probe measures the CUDA card: no CUDA "
                           "device is available")
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mtx", nargs="?", help="count matrix (.mtx.gz); default "
                   "a synthetic 4,000 x 20,000 one")
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--batches", type=int, default=8)
    ns_ = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    B = ns_.batch_size
    with tempfile.TemporaryDirectory() as tmp:
        mtx = ns_.mtx or _synthetic(tmp)
        idx = mtx + ".index"
        blk = MtxMemoryBlock(mtx, idx if os.path.exists(idx) else "", B,
                             count_dtype="auto")
        x = build_dense(blk, "cuda")
    N, D = x.shape
    hot = hot_genes(x)
    order = np.argsort(hot, kind="stable")
    print(f"[{card}] {N} x {D} {str(x.dtype).replace('torch.', '')}: "
          f"{int(hot.sum())} hot genes (max count > 7), "
          f"{100 * hot.mean():.2f}%")
    res = {"card": card, "hot": int(hot.sum()), "D": D, "N": N}
    nb = min(ns_.batches, N // B)
    for name, o in (("input", np.arange(D)), ("cold-first", order)):
        xo = x.index_select(1, torch.from_numpy(o).cuda())
        shares = regime_shares(xo, B)
        gen = torch.Generator(device="cuda").manual_seed(0)
        ms = dict.fromkeys(("nb_valgrad", "nb_value", "nb_finish"), 0.0)
        worst = dict.fromkeys(ms, 0.0)
        for b in range(nb):
            xb = xo[b * B:(b + 1) * B]
            zc, zn, depth, W = batch_operands(x[b * B:(b + 1) * B], gen)
            W = W.index_select(1, torch.from_numpy(o).cuda()).contiguous()
            for k, (kern, plain) in kernel_calls(xb, zc, zn, depth,
                                                 W).items():
                got, want = kern(), plain()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                for g, w in zip(got, want):
                    e = float((g - w).abs().max() / (w.abs().max() + 1e-30))
                    worst[k] = max(worst[k], e)
                    if not e <= 1e-3:
                        raise AssertionError(f"{k} in {name} order, batch "
                                             f"{b}: |kernel - plain| = {e:.3g}"
                                             f" max|plain|")
                ms[k] += device_ms(kern) / nb
        res[name] = {"shares": shares, "ms": ms, "err": worst}
        print(f"[{card}] {name} order: tiles of {ns.VALGRAD_TILE} columns "
              f"x {B} rows over {shares['pairs']} (batch, tile) pairs: "
              + ", ".join(f"{r} {100 * shares[r]:.2f}%" for r in REGIMES))
        print(f"[{card}] {name} order, {nb} batches of {B}, kernel device "
              f"ms a call (CUDA graph replays): "
              + "; ".join(f"{k} {v:.4f} (|err| {worst[k]:.2g} max|plain|)"
                          for k, v in ms.items()))
    return res


if __name__ == "__main__":
    main()
