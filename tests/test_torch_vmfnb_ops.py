"""The joint vMF+NB model's ops in the port against the JAX package's:
the fast-math constants, ``lbessel`` with its custom gradient, the count
encoder's row stats (``want_stats``), and the NB step's ``pb`` / exp-nu
variant (``nb_step_report(pb=, nu_exp=True)``,
``nb_step_boot_joint_gradonly``) — against the XLA specifications and
the Pallas kernels in interpret mode.

On the CPU every wrapper runs its plain version; ``chip_smoke.py`` holds
the CUDA kernels against the same plain versions on the card.

Tolerances and why:

- ``fasterlog`` / ``fasterlgamma``: bitwise (the same float32 steps);
- ``lbessel``: value and Baricz-midpoint gradient ``rtol=1e-6`` (the
  same float32 formulas, evaluated by two libraries);
- count encoder: ``|port - jax| <= 1e-5 * S + 1e-6``, S the sum of the
  terms' magnitudes (float32 reassociation over D), the stats against
  themselves (all terms are non-negative);
- step NLL values ``rtol=3e-5`` and gradients ``rtol=5e-4, atol=5e-6 *
  max|ref|``, the JAX suite's own (tests/test_nb_step.py): the Pallas
  kernels use the shift-into-Stirling lgamma / digamma and one shared
  reciprocal, the plain version exact float32 ``lgamma`` / ``digamma``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmvae_tpu.ops.enc_kernel as jek
from mmvae_tpu.ops import fastmath as jfm
from mmvae_tpu.ops import nb_step as jns
from mmvae_tpu.ops.lbessel import lbessel as jlbessel
from mmvae_tpu_torch.ops import enc_kernel as tek
from mmvae_tpu_torch.ops import fastmath as tfm
from mmvae_tpu_torch.ops import nb_step as tns
from mmvae_tpu_torch.ops.lbessel import lbessel

# ----------------------------------------------------------------------
# fast-math constants and lbessel
# ----------------------------------------------------------------------

SCALARS = [0.1, 0.5, 1.0, 2.0 * math.pi, 10.0, 99.0, 9999.0, 10001.0,
           12345.678]


@pytest.mark.parametrize("fn", ["fasterlog", "fasterlgamma"])
def test_fastmath_bitwise(fn):
    for v in SCALARS:
        assert getattr(tfm, fn)(v) == getattr(jfm, fn)(v), v


@pytest.mark.parametrize("df", [0.0, 4.0, 319.0, 9999.0])
def test_lbessel_value_and_gradient_match_jax(df):
    """Both regimes (kappa <= df and kappa > df) and the Baricz-midpoint
    gradient, not the analytic one."""
    kappa = np.array([0.1, 0.7, 3.0, 4.0, 9.5, 10.0, 50.0, 400.0],
                     np.float32)
    jv, jvjp = jax.vjp(lambda k: jlbessel(k, df), jnp.asarray(kappa))
    g = np.linspace(0.5, 2.0, len(kappa)).astype(np.float32)
    (jg,) = jvjp(jnp.asarray(g))
    k = torch.from_numpy(kappa).requires_grad_()
    v = lbessel(k, df)
    v.backward(torch.from_numpy(g))
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(k.grad.numpy(), np.asarray(jg), rtol=1e-6)


# ----------------------------------------------------------------------
# count encoder with row stats
# ----------------------------------------------------------------------

DTYPES = {"int8": np.int8, "int16": np.int16, "float32": np.float32}


def _enc_inputs(M, D, r1, r2, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        x = rng.gamma(1.0, 2.0, size=(M, D)).astype(np.float32)
    else:
        hi = 127 if dtype == "int8" else 3000
        x = rng.poisson(1.5, size=(M, D))
        spikes = rng.random((M, D)) < 0.01
        x[spikes] = rng.integers(0, hi + 1, size=int(spikes.sum()))
        x = x.astype(DTYPES[dtype])
    WL = (rng.normal(size=(r1, D)) * 0.1).astype(np.float32)
    WX = (rng.normal(size=(r2, D)) * 0.01).astype(np.float32)
    return x, WL, WX


def _assert_scaled(got, want, S):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    lim = 1e-5 * S + 1e-6
    err = np.abs(got - want)
    assert np.all(err <= lim), f"max err/limit {np.max(err / lim):.3g}"


def _check_stats_outputs(got, want, x, WL, WX):
    xf = x.astype(np.float64)
    _assert_scaled(got[0], want[0], np.abs(np.log1p(xf)) @ np.abs(WL.T))
    if WX.shape[0]:
        _assert_scaled(got[1], want[1], np.abs(xf) @ np.abs(WX.T))
    st = np.asarray(want[2], np.float64)
    _assert_scaled(got[2], st, np.abs(st))


@pytest.mark.parametrize("dtype", list(DTYPES))
# D = 255, 256, 257: either side of the forward kernel's 256-column tile
@pytest.mark.parametrize("D,r2", [(640, 3), (1003, 3), (1003, 0), (255, 3),
                                  (256, 3), (257, 0)])
@pytest.mark.parametrize("interpret", [False, True])
def test_count_encode_stats_matches_jax(monkeypatch, dtype, D, r2,
                                        interpret):
    """``count_encode(want_stats=True)`` at the joint step's widths
    (r1 = 2R + 1 = 5 log1p rows, r2 = H + 2 = 3 raw rows, and the
    serving case r2 = 0) against ``_xla_encode`` and interpret-mode K4,
    at ragged D and at the kernel's tile edges."""
    monkeypatch.setattr(jek, "_INTERPRET", interpret)
    x, WL, WX = _enc_inputs(8, D, 5, r2, dtype, seed=D + r2)
    want = jek.count_encode(jnp.asarray(x), jnp.asarray(WL), jnp.asarray(WX),
                            None, True)
    got = tek.count_encode(torch.from_numpy(x), torch.from_numpy(WL),
                           torch.from_numpy(WX) if r2 else None,
                           want_stats=True)
    assert len(got) == 3 and got[2].shape == (8, 4)
    _check_stats_outputs([t.numpy() for t in got],
                         [np.asarray(w) for w in want], x, WL, WX)


def test_count_encode_stats_carry_no_gradient():
    """The stats are data: the weight VJP with stats on equals the one
    without, and the stats need no gradient."""
    x, WL, WX = _enc_inputs(6, 300, 5, 3, "int16", seed=4)
    g = np.random.default_rng(0)
    g1 = torch.from_numpy(g.normal(size=(6, 5)).astype(np.float32))
    g2 = torch.from_numpy(g.normal(size=(6, 3)).astype(np.float32))
    grads = []
    for stats in (False, True):
        wl = torch.from_numpy(WL).requires_grad_()
        wx = torch.from_numpy(WX).requires_grad_()
        out = tek.count_encode(torch.from_numpy(x), wl, wx,
                               want_stats=stats)
        if stats:
            assert not out[2].requires_grad
        ((out[0] * g1).sum() + (out[1] * g2).sum()).backward()
        grads.append((wl.grad, wx.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


def test_count_encode_stats_cpu_launches_nothing_and_route_refuses_cpu():
    x, WL, WX = (torch.from_numpy(a) for a in _enc_inputs(4, 64, 2, 0,
                                                          "int8"))
    before = (tek.count_encode.launches, tek.count_encode.stats_launches)
    tek.count_encode(x, WL, want_stats=True)
    assert (tek.count_encode.launches,
            tek.count_encode.stats_launches) == before
    with pytest.raises(ValueError, match="no kernel"):
        tek._kernel_route(x, WL, None, True)


# ----------------------------------------------------------------------
# the NB step's joint variant (pb after the softmax, exp-nu)
# ----------------------------------------------------------------------

CASES = [("le7", np.float32), ("integer", np.float32),
         ("nonint", np.float32), ("le7", np.int8), ("integer", np.int16)]
DIFF = (1, 3, 4, 5, 7, 8, 9, 10)  # zm, zn, depth, wd, bias2, wn, bias_n, pb
NAMES = ["zm", "zn", "depth", "wd", "bias2", "wn", "bias_n", "pb"]


def _inputs(regime, dtype, B=8, D=1003, seed=0):
    """The joint step's operands: a zero covariate and covariate row (as
    the joint step hands the kernels), a pb row, and a nu bias that puts
    exp(nu_pre) far above NU_HI in 1% of the columns (the clamp's mask;
    near the clamp float32 loses the digamma and lgamma differences of
    nu ~ 1e4 in both frameworks, which is not what these tests hold)."""
    rng = np.random.default_rng(seed)
    if regime == "le7":
        x = rng.poisson(0.8, size=(B, D)).clip(0, 6).astype(np.float32)
    elif regime == "integer":
        x = rng.poisson(9.0, size=(B, D)).clip(0, 40).astype(np.float32)
    else:
        x = rng.poisson(0.8, size=(B, D)).astype(np.float32)
        x[0, :7] += 0.5
    x = x.astype(dtype)
    zm = rng.normal(size=(B, 2)).astype(np.float32)
    c = np.zeros((B, 1), np.float32)
    zn = rng.normal(size=(B, 1)).astype(np.float32)
    depth = (np.abs(rng.normal(size=(B, 1))) * 50 + 0.3).astype(np.float32)
    wd, bias2, wn, bias_n, pb = [
        (rng.normal(size=s) * 0.3).astype(np.float32)
        for s in ((2, D), (D,), (1, D), (D,), (D,))]
    bias_n[:max(1, D // 100)] += 12.0  # exp(nu_pre) ~ 1.6e5 > NU_HI
    wc = np.zeros((1, D), np.float32)
    return [x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n, pb]


def _jax(args):
    return [jnp.asarray(a) for a in args]


def _torch(args, grad=False):
    out = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    if grad:
        for i in DIFF:
            out[i].requires_grad_()
    return out


def _jax_grads(fn, args):
    def loss(*d):
        a = list(_jax(args))
        for i, v in zip(DIFF, d):
            a[i] = v
        return fn(*a)

    d = tuple(jnp.asarray(args[i]) for i in DIFF)
    return jax.value_and_grad(loss, argnums=tuple(range(len(DIFF))))(*d)


def _assert_grads(got, want):
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b)
        scale = max(1e-3, float(np.abs(b).max()))
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=5e-4,
                                   atol=5e-6 * scale,
                                   err_msg=f"grad mismatch: {name}")


def _clamped(args):
    x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n, pb = args
    return int((np.exp(zn @ wn + bias_n) >= jns.NU_HI).sum())


@pytest.mark.parametrize("include_const", [False, True])
@pytest.mark.parametrize("regime,dtype", CASES)
def test_joint_step_nll_matches_xla_spec(regime, dtype, include_const):
    args = _inputs(regime, dtype)
    assert _clamped(args) > 0
    v, g = _jax_grads(lambda *a: jns.xla_step_nll(
        *a[:10], pb=a[10], include_const=include_const, nu_exp=True), args)
    targs = _torch(args, grad=True)
    got = tns.step_nll_ref(*targs[:10], pb=targs[10],
                           include_const=include_const, nu_exp=True)
    np.testing.assert_allclose(float(got.detach()), float(v), rtol=3e-5)
    got.backward()
    _assert_grads([targs[i].grad for i in DIFF], g)


@pytest.mark.parametrize("joint", [False, True])
def test_plain_versions_joint_flag(joint):
    """The plain K6 / K2 with the one ``joint`` flag (pb row and exp-nu
    together, as the kernels' JOINT instance) against the XLA spec; the
    kernel entry refuses a CPU tensor rather than fall back."""
    args = _inputs("integer", np.int16, seed=5)
    x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n, pb = _torch(args)
    want = jns.xla_step_nll(*_jax(args[:10]),
                            pb=jnp.asarray(args[10]) if joint else None,
                            include_const=True, nu_exp=joint)
    zc = torch.cat([zm, c], 1)
    W = tns.stack_rows(wd, wc, bias2, wn, bias_n, pb if joint else None)
    got = tns.value(x, zc, zn, depth, tns.lse(zc, W, 2, 1), W, 2, 1, 1, True,
                    joint)
    np.testing.assert_allclose(float(got), float(want), rtol=3e-5)
    gout = tns.valgrad(x, zc, zn, depth, tns.lse(zc, W, 2, 1), W, 2, 1, 1,
                       joint)[0]
    assert gout.shape == (6 + joint, x.shape[1])
    with pytest.raises(ValueError, match="no kernel for device"):
        tns._value_kernel(x, zc, zn, depth, tns.lse(zc, W, 2, 1), W, 2, 1, 1,
                          True, joint)


PALLAS = [("le7", np.float32), ("integer", np.int16), ("nonint", np.float32),
          ("le7", np.int8)]


@pytest.mark.parametrize("regime,dtype", PALLAS)
def test_joint_report_matches_pallas_interpret(monkeypatch, regime, dtype):
    monkeypatch.setattr(jns, "_INTERPRET", True)
    args = _inputs(regime, dtype, seed=1)
    want = jns.nb_step_report(*_jax(args[:10]), include_const=True,
                              pb=jnp.asarray(args[10]), nu_exp=True)
    t = _torch(args)
    got = tns.nb_step_report(*t[:10], include_const=True, pb=t[10])
    np.testing.assert_allclose(float(got), float(want), rtol=3e-5)


@pytest.mark.parametrize("regime,dtype", PALLAS)
def test_joint_boot_gradonly_matches_pallas_interpret(monkeypatch, regime,
                                                      dtype):
    monkeypatch.setattr(jns, "_INTERPRET", True)
    args = _inputs(regime, dtype, seed=2)
    v, g = _jax_grads(jns.nb_step_boot_joint_gradonly, args)
    targs = _torch(args, grad=True)
    got = tns.nb_step_boot_joint_gradonly(*targs)
    assert float(got.detach()) == 0.0 == float(v)  # the grad-only primal
    (got * 1.5).backward()  # the backward scales by the cotangent
    _assert_grads([targs[i].grad / 1.5 for i in DIFF], g)


@pytest.mark.parametrize("regime,dtype", CASES)
def test_joint_boot_gradonly_matches_xla_grad(regime, dtype):
    """Every gradient of the grad-only joint boot step, pb included,
    against ``jax.grad`` of the XLA spec."""
    args = _inputs(regime, dtype, seed=3)
    _, g = _jax_grads(lambda *a: jns.xla_step_nll(
        *a[:10], pb=a[10], nu_exp=True), args)
    targs = _torch(args, grad=True)
    tns.nb_step_boot_joint_gradonly(*targs).backward()
    _assert_grads([targs[i].grad for i in DIFF], g)


def test_joint_raw_kernel_outputs_match_pallas_interpret(monkeypatch):
    """The plain K2 with pb / exp-nu against its Pallas kernel: gout
    (with the pb gradient row last), rsum, u1, dzn; K1 and K3 on the
    7-row W."""
    monkeypatch.setattr(jns, "_INTERPRET", True)
    args = _inputs("integer", np.int16, B=9, D=1100, seed=6)
    x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n, pb = _jax(args)
    xp, zmp, cp, znp, dpp, W, dims = jns._prep(
        x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n, pb)
    B, D, R, C, Rn = (dims[k] for k in ("B", "D", "R", "C", "Rn"))
    l = jns._lse_call(zmp, cp, W, dims["bp"], dims["Dp"],
                      jns._tile_for(dims["bp"]), D, R, C)
    _, gout, rsum, u1, dzn = jns._valgrad_call(
        xp, zmp, cp, znp, dpp, l, W, D=D, B=B, has_pb=True, nu_exp=True,
        need_value=False)
    fout, u2 = jns._finish_call(zmp, cp, l, rsum, W, D=D)

    t = _torch(args)
    zc = torch.cat([t[1], t[2]], 1)
    Wt = tns.stack_rows(*t[5:])
    assert Wt.shape == (R + C + Rn + 3, D)
    lt = tns.lse(zc, Wt, R, C)
    np.testing.assert_allclose(lt.numpy(), np.asarray(l)[:B], rtol=1e-6)
    got = tns.valgrad(t[0], zc, t[3], t[4], lt, Wt, R, C, Rn, True)
    fin = tns.finish(zc, lt, got[1].contiguous(), Wt, R, C)
    T = R + C + Rn + 3
    want = [np.asarray(gout)[:T, :D], np.asarray(rsum)[:B],
            np.asarray(u1)[:B], np.asarray(dzn)[:B],
            np.asarray(fout)[:R + C + 1, :D], np.asarray(u2)[:B]]
    for name, a, b in zip(["gout", "rsum", "u1", "dzn", "fout", "u2"],
                          [*got, *fin], want):
        scale = max(1e-3, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, rtol=5e-4,
                                   atol=5e-6 * scale, err_msg=name)


def test_joint_cpu_wrappers_launch_no_kernel():
    args = _torch(_inputs("le7", np.int8, B=4, D=64))
    fns = (tns.lse, tns.value, tns.valgrad, tns.finish)
    before = [(f.launches, getattr(f, "joint_launches", 0)) for f in fns]
    tns.nb_step_report(*args[:10], pb=args[10])
    tns.nb_step_boot_joint_gradonly(*args)
    assert [(f.launches, getattr(f, "joint_launches", 0))
            for f in fns] == before


def test_stacked_rows_limit_counts_the_pb_row():
    """The joint model's R + C + Rn + 3 stacked rows with pb: 17 of them,
    which the step kernels once refused, take the general instances; the
    card's limit counts the rows a general instance holds in shared
    memory, R + C + Rn + 2, since K2 and K6 read the pb row's exp(pb)
    from W apart."""
    B, D = 2, 8
    zc = torch.zeros((B, 13))
    W = torch.zeros((17, D))
    assert tns._dims(zc, W, 12, 1) == (B, D)
    assert tns.valgrad_plan(B, D, 12, 1, 1, joint=True).instance == "general"
    assert tns.value_plan(B, D, 12, 1, 1, joint=True).instance == "general"
    most = tns.MAX_STACKED_ROWS["valgrad"]
    plan = tns.valgrad_plan(B, D, 12, 1, most - 15, joint=True)
    assert plan.smem == most * tns.SMEM_ROW_BYTES["valgrad"]
    with pytest.raises(ValueError, match="stacked rows"):
        tns.valgrad_plan(B, D, 12, 1, most - 14, joint=True)
