"""The comparison that decides ``correct`` for a training cell.

Two superbatch replays of the program, through the window's own call,
are each held against the plain reference following the same batch
steps from the same state, counts and draws: the first replay of
epoch 0 from the benchmark's parameters, and a replay in the middle of
the last epoch before the window (its KL weight, its superbatch staged
into the graph's inputs) from the program's own state before it.  Each
number below is the larger of its two readings:

- ``loss_gap``: the worst step's ``|report - reference| / |reference|``;
- ``grad_gap``: the optimizer's first moment after those steps (the
  gradients as the optimizer got them, after the clip and the weight
  decay), by the worst leaf: ``| |m_prog| - |m_ref| |`` over the larger
  of the reference's norm of that leaf and of the median leaf;
- ``change_gap``: the parameters' change over those steps, by the worst
  leaf, measured the same way.  A leaf whose reference gradient (first
  moment) is under a thousandth of the median leaf's moves by round-off
  alone (weight decay and Adam's normalisation on a zero gradient), and
  is left out of the change;
- ``change_median``: the same gap of the median leaf, steady where a few
  leaves behind hard gates (a ReLU'd or clamped head whose few live rows
  flip under rounding) make the worst leaf swing from seed to seed;
- ``encoder_angle``: the angle, in radians, between the program's and
  the reference's first moment of the encoder's first-layer weight (the
  leaf the model's reference names ``ENCODER_LEAF``): its gradient is a
  product over the batch of the standardized counts and the rows'
  cotangents, so a product computed in TF32 (10-bit mantissas) moves it
  by ~1e-3 while float32 rounding moves it by ~1e-5.  The norms above,
  sums over many elements, do not separate the two.

A cell's limits name the numbers it compares; every number is printed.

The norms are invariant to the order of the genes, so the program's
clustered order and the reference's input order compare as they are;
a program that reordered the counts but not the weights shows in the
losses.
"""

from __future__ import annotations

import math

import torch


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tree.items()}


def worst_leaf(prog: dict, ref: dict, skip=()) -> tuple[float, str]:
    """The worst leaf's gap of norms and its name."""
    if set(prog) != set(ref):
        raise ValueError(f"leaves differ: program {sorted(set(prog) - set(ref))}"
                         f", reference {sorted(set(ref) - set(prog))}")
    np_, nr = _norms(prog), _norms(ref)
    med = sorted(nr.values())[len(nr) // 2]
    worst, name = 0.0, ""
    for k in nr:
        if k in skip:
            continue
        gap = abs(np_[k] - nr[k]) / max(nr[k], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, name = gap, k
    return worst, name


def readings(prog: dict, ref: dict, encoder_leaf: str) -> dict:
    """The compared numbers.  ``prog`` and ``ref`` each hold
    ``reports`` (list), ``params``, ``mu`` (named leaves after the
    steps) and ``params0`` (before them); ``encoder_leaf`` names the
    encoder's first-layer weight."""
    rp, rr = prog["reports"], ref["reports"]
    if len(rp) != len(rr):
        raise ValueError(f"{len(rp)} program reports, {len(rr)} reference")
    loss = max((abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a)
                else math.inf) for a, b in zip(rp, rr))
    grad, grad_leaf = worst_leaf(prog["mu"], ref["mu"])
    nmu = _norms(ref["mu"])
    med = sorted(nmu.values())[len(nmu) // 2]
    still = {k for k, v in nmu.items() if v < 1e-3 * med}
    dprog = {k: prog["params"][k] - prog["params0"][k]
             for k in prog["params"]}
    dref = {k: ref["params"][k] - ref["params0"][k] for k in ref["params"]}
    change, change_leaf = worst_leaf(dprog, dref, skip=still)
    out = {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
           "change_median": median_leaf(dprog, dref, skip=still),
           "encoder_angle": angle({encoder_leaf: prog["mu"][encoder_leaf]},
                                  {encoder_leaf: ref["mu"][encoder_leaf]})}
    out["_leaves"] = {"grad_gap": grad_leaf, "change_gap": change_leaf,
                      "left_out": sorted(still),
                      "angles": {k: float("%.3g" % angle(
                          {k: prog["mu"][k]}, {k: ref["mu"][k]}))
                          for k in sorted(ref["mu"])}}
    return out


def median_leaf(prog: dict, ref: dict, skip=()) -> float:
    """The median over the leaves (``skip`` left out) of the gap of
    norms, each measured as in :func:`worst_leaf`."""
    np_, nr = _norms(prog), _norms(ref)
    med = sorted(nr.values())[len(nr) // 2]
    gaps = sorted(abs(np_[k] - nr[k]) / max(nr[k], med, 1e-30)
                  for k in nr if k not in skip)
    return gaps[len(gaps) // 2]


def angle(prog: dict, ref: dict) -> float:
    """The angle between two trees taken as one vector each (their
    leaves in one order), in float64: ``2 asin(|a/|a| - b/|b|| / 2)``,
    exact for small angles."""
    a = torch.cat([prog[k].double().reshape(-1) for k in sorted(ref)])
    b = torch.cat([ref[k].double().reshape(-1) for k in sorted(ref)])
    na, nb = torch.linalg.vector_norm(a), torch.linalg.vector_norm(b)
    if not (na > 0 and nb > 0 and torch.isfinite(na)):
        return math.inf
    d = float(torch.linalg.vector_norm(a / na - b / nb))
    return 2.0 * math.asin(min(1.0, d / 2.0))


def worst_of(readings: list) -> dict:
    """Each number's largest reading over ``readings`` (a list of what
    :func:`readings` returns, less ``_leaves``); a NaN reads as
    infinite."""
    return {k: max(r[k] if r[k] == r[k] else math.inf for r in readings)
            for k in readings[0]}


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) of the numbers the cell's
    limits name: each at or under its limit, and finite."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = nums[name]
        out[name] = {"value": v, "limit": lim}
        ok = ok and math.isfinite(v) and v <= lim
    return ok, out
