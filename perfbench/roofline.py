"""The least time the card could take for each hand-written kernel's
work, from the launch's shape.

``least_s(kernel, shape) = max(bytes / PEAK_BYTES, ops / PEAK_F32)``.

Bytes follow each op's contract: every input read once and every output
written once, whatever the kernel reads again (the arithmetic of
``chip_smoke.py``'s ``bound_ms``).  Operations count, per (row, column)
element, what the op computes, not what the current source executes: an
add, a multiply, a compare or a select is 1, a fused multiply-add 2, and
a transcendental function (exp, log, log1p, lgamma, digamma) or a divide
is priced at ``TRANSCENDENTAL`` = 1.  That price is the least such a
function can cost, so the operation bound stays a lower bound.  A cheaper
implementation of the same op leaves its count alone.  Each count's
derivation is written beside it.

Shapes: ``M`` rows, ``D`` columns, ``xb`` bytes a count; ``r1`` log1p
rows and ``r2`` raw-count rows of the encoder (``stats``: the row
statistics too); the step kernels' widths ``R`` (latent), ``C``
(covariate), ``Rn`` (overdispersion latent), ``joint`` (the post-softmax
log-bias row and the exp-clamp overdispersion of the joint model), and
the reporting NLL's ``const`` (``lgamma(x + 1)``).
"""

from __future__ import annotations

# H100 SXM, NVIDIA's data sheet (700 W): HBM3 bytes/s and float32
# FLOP/s outside the tensor cores (chip_smoke.py's PEAK_BYTES, PEAK_F32)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
TRANSCENDENTAL = 1


def _logits(s) -> int:
    # h = zc . W[:R+C] + W[R+C]: R + C FMAs, the bias their start
    return 2 * (s["R"] + s["C"])


def _mu(s) -> int:
    # ls = h - lse (1); joint: + pb (1); mu = exp(ls) * depth + 1e-4:
    # exp and an FMA
    return 1 + (1 if s["joint"] else 0) + TRANSCENDENTAL + 2


def _nu(s) -> int:
    # nu_pre = zn . wn + bn: Rn FMAs; then
    #   NB:    clamp(softplus(nu_pre), 1e-4, 1e4) + 1e-4: softplus as
    #          log1p(exp(.)) (2 functions), two compares, an add
    #   joint: clamp(exp(nu_pre), 0, 1e4) + 1e-4: exp, two compares, add
    pre = 2 * s["Rn"]
    return pre + (2 * TRANSCENDENTAL + 3 if not s["joint"]
                  else TRANSCENDENTAL + 3)


def _nll(s) -> int:
    # s = mu + nu (1); log s, log mu, log nu (3 functions); nu + x (1);
    # lgamma(nu), lgamma(nu + x) (2 functions); t = lg(nu) - lg(nu + x)
    # (1); (log s - log mu) and (log s - log nu) (2); t += x (..) and
    # t += nu (..) (2 FMAs); the sum over the batch (1)
    return 1 + 3 * TRANSCENDENTAL + 1 + 2 * TRANSCENDENTAL + 1 + 2 + 4 + 1


def _nll_grad(s) -> int:
    # with s = mu + nu (1) and 1 / s (1 function):
    #   df/dmu = (x + nu) / s - x / mu: add, multiply, a divide, subtract
    #   df/dnu = digamma(nu) - digamma(nu + x) + log s - log nu
    #            + (x + nu) / s - 1: nu + x (1), 2 digammas, 2 logs, 5
    #            adds and subtracts (the quotient shared with df/dmu)
    #   dls = df/dmu * (mu - 1e-4): a subtract and a multiply
    #   dnu_pre: NB, df/dnu * sigmoid(nu_pre) inside the clamp: the
    #            sigmoid (exp and a divide), a select, a multiply;
    #            joint, df/dnu * exp(nu_pre) inside the clamp: a select
    #            and a multiply (exp(nu_pre) is nu's)
    d_mu = 1 + TRANSCENDENTAL + 1 + 1 + TRANSCENDENTAL + 1
    d_nu = 1 + 4 * TRANSCENDENTAL + 5
    d_pre = (2 * TRANSCENDENTAL + 2) if not s["joint"] else 2
    return d_mu + d_nu + 2 + d_pre


def _rows_in(s) -> int:
    # the per-row operands: zc (R + C), zn (Rn), depth, lse
    return s["R"] + s["C"] + s["Rn"] + 2


def _stacked(s) -> int:
    # the stacked weight rows [wd; wc; bias2; wn; bias_n(; pb)]
    return s["R"] + s["C"] + s["Rn"] + 2 + (1 if s["joint"] else 0)


def work(kernel: str, s: dict) -> tuple[float, float]:
    """(operations, bytes) of one call of ``kernel`` at shape ``s``."""
    M, D = s["M"], s["D"]
    if kernel == "count_encode":
        # K4: hL = log1p(x) WL^T, hX = x WX^T (+ row stats of log1p x).
        # log1p (1 function), r1 + r2 FMAs; the stats: sum L (1) and
        # sum L^2 (an FMA); the unfiltered pair repeats them, no work
        r1, r2 = s["r1"], s["r2"]
        ops = TRANSCENDENTAL + 2 * (r1 + r2) + (3 if s["stats"] else 0)
        nbytes = (M * D * s["xb"] + (r1 + r2) * D * 4 + M * (r1 + r2) * 4
                  + (M * 16 if s["stats"] else 0))
        return M * D * ops, nbytes
    if kernel == "count_encode_bwd":
        # K5: dWL = g1^T log1p(x), dWX = g2^T x: log1p (1 function) and
        # r1 + r2 FMAs an element
        r = s["r1"] + s["r2"]
        ops = TRANSCENDENTAL + 2 * r
        return M * D * ops, M * D * s["xb"] + M * r * 4 + r * D * 4
    if kernel == "nb_lse":
        # K1: row logsumexp of h: the logits, then a running max (1
        # compare), h - max (1), exp (1 function), the sum (1)
        ops = _logits(s) + 3 + TRANSCENDENTAL
        RC = s["R"] + s["C"]
        return M * D * ops, M * RC * 4 + (RC + 1) * D * 4 + M * 4
    if kernel == "nb_value":
        # K6: the NB NLL of every element, summed: logits, mu, nu, the
        # NLL terms; with the data constant lgamma(x + 1): x + 1, the
        # function, the add
        ops = (_logits(s) + _mu(s) + _nu(s) + _nll(s)
               + ((2 + TRANSCENDENTAL) if s["const"] else 0))
        nbytes = (M * D * s["xb"] + _stacked(s) * D * 4 + _rows_in(s) * M * 4
                  + 4)
        return M * D * ops, nbytes
    if kernel == "nb_valgrad":
        # K2: logits, mu, nu, the NLL's derivatives in mu and nu, then the
        # sums: the stacked gradient rows (zc . dls: R + C FMAs, colsum
        # dls 1, zn . dnu_pre: Rn FMAs, colsum dnu_pre 1; joint: the pb
        # row is colsum dls again, no work) and the row sums (rsum 1,
        # u1 = dls wd^T: R FMAs, dzn = dnu_pre wn^T: Rn FMAs)
        R, C, Rn = s["R"], s["C"], s["Rn"]
        sums = 2 * (R + C) + 1 + 2 * Rn + 1 + 1 + 2 * R + 2 * Rn
        ops = _logits(s) + _mu(s) + _nu(s) + _nll_grad(s) + sums
        T = _stacked(s)
        nbytes = (M * D * s["xb"] + T * D * 4 + _rows_in(s) * M * 4
                  + T * D * 4 + M * (1 + R + Rn) * 4)
        return M * D * ops, nbytes
    if kernel == "nb_finish":
        # K3: p = exp(h - lse) (a subtract, the function), pr = p rsum
        # (1); fout = [zc^T pr; colsum pr] (R + C FMAs and an add);
        # u2 = p wd^T (R FMAs)
        R, C = s["R"], s["C"]
        ops = _logits(s) + 1 + TRANSCENDENTAL + 1 + 2 * (R + C) + 1 + 2 * R
        nbytes = (M * (R + C + 2) * 4 + 2 * (R + C + 1) * D * 4 + M * R * 4)
        return M * D * ops, nbytes
    raise KeyError(kernel)


def least_s(kernel: str, s: dict) -> tuple[float, str]:
    """The least seconds of one call, and what bounds it."""
    ops, nbytes = work(kernel, s)
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")
