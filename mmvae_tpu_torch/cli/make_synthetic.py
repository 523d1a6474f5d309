"""``make_synthetic`` — generate synthetic count matrices for testing
and benchmarking.

The reference ships no data tooling (its orphan ``rpois_t`` sampler,
include/utils/stat.hh:9-64, hints at the intent).  This CLI writes a
column-sorted bgzipped MatrixMarket count matrix with a negative-binomial
generative process (per-gene mean profile x per-cell depth), plus
optional row/column name files — enough to exercise every driver config.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io.index import build_mmutil_index
from ..io.writers import write_matrix_market_file, write_vector_file
from ..utils.logging import TLOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True, help="output .mtx.gz path")
    p.add_argument("--genes", type=int, default=2000)
    p.add_argument("--cells", type=int, default=3000)
    p.add_argument("--depth_mean", type=float, default=2000.0,
                   help="mean reads per cell")
    p.add_argument("--overdisp", type=float, default=1.0,
                   help="NB overdispersion (smaller = noisier)")
    p.add_argument("--n_types", type=int, default=4,
                   help="number of latent cell types")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--index", action="store_true", help="also build .index")
    p.add_argument("--names", action="store_true",
                   help="write .rows.gz / .cols.gz name files")
    ns = p.parse_args(argv)

    rng = np.random.default_rng(ns.seed)
    D, N = ns.genes, ns.cells

    # latent cell types with distinct log-normal expression profiles
    profiles = rng.lognormal(0.0, 1.0, size=(ns.n_types, D))
    profiles /= profiles.sum(axis=1, keepdims=True)
    types = rng.integers(0, ns.n_types, size=N)
    depth = rng.lognormal(np.log(ns.depth_mean), 0.3, size=N)

    rows_all, cols_all, vals_all = [], [], []
    chunk = max(1, min(N, 512))
    for lo in range(0, N, chunk):
        hi = min(N, lo + chunk)
        mu = profiles[types[lo:hi]] * depth[lo:hi, None]  # (chunk, D)
        # NB sampling: gamma-poisson mixture
        lam = rng.gamma(ns.overdisp, mu / ns.overdisp)
        counts = rng.poisson(lam)
        # guarantee no empty columns (the indexer requires every column)
        empty = ~(counts > 0).any(axis=1)
        counts[empty, 0] = 1
        cc, rr = np.nonzero(counts)
        rows_all.append(rr)
        cols_all.append(cc + lo)
        vals_all.append(counts[cc, rr])

    rows = np.concatenate(rows_all)
    cols = np.concatenate(cols_all)
    vals = np.concatenate(vals_all).astype(np.float32)
    TLOG(f"Synthesized {D} x {N} with {len(vals)} nonzeros "
         f"({len(vals) / (D * N):.1%} dense)")

    write_matrix_market_file(ns.out, rows, cols, vals, (D, N))
    TLOG("Wrote", ns.out)
    if ns.index:
        build_mmutil_index(ns.out)
    if ns.names:
        base = ns.out[:-len(".mtx.gz")] if ns.out.endswith(".mtx.gz") else ns.out
        write_vector_file(base + ".rows.gz", [f"g{i}" for i in range(D)])
        write_vector_file(base + ".cols.gz", [f"c{j}" for j in range(N)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
