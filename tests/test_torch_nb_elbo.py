"""The port's v1 fused NB ELBO (mmvae_tpu_torch/ops/nb_elbo.py: K7 / K8's
plain versions, ``nb_nllik_fused``, ``_reference_impl``) and the
value-bearing boot step (K2v's plain version, ``nb_step_boot``) against
the JAX package's: the XLA spec with ``jax.grad``, and the Pallas kernels
in interpret mode (``_INTERPRET`` monkeypatched, as tests/test_nb_elbo.py
does).

On the CPU every wrapper runs its plain version; the CUDA kernels are
held against the same plain versions on the card by ``chip_smoke.py``.

Tolerances: values ``rtol=2e-5`` (the JAX suite's kernel-vs-reference
bound, tests/test_nb_elbo.py: float32 sums over B x D terms, and the
shift-into-Stirling lgamma against ``lgamma``); the (B, 1) residuals
``rtol=2e-5, atol=1e-6 * max|ref|``; gradients ``rtol=5e-4,
atol=5e-6 * max|ref|`` (tests/test_nb_step.py's gradient bound: the
shift-into-Stirling digamma against ``digamma``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.ops import nb_elbo as jne
from mmvae_tpu.ops import nb_step as jns
from mmvae_tpu_torch.ops import nb_elbo as tne
from mmvae_tpu_torch.ops import nb_step as tns

def _inputs(B=12, D=256, seed=0, dtype=np.float32):
    """JAX's test inputs (tests/test_nb_elbo.py), with a few nu_pre at
    both clamp edges: softplus below NU_LO and above NU_HI."""
    rng = np.random.default_rng(seed)
    x = rng.poisson(1.0, size=(B, D)).astype(np.float32)
    x[0, :4] = 60.0
    h = rng.normal(0, 2.0, size=(B, D)).astype(np.float32)
    nu_pre = rng.normal(0, 2.0, size=(B, D)).astype(np.float32)
    nu_pre[1, :3] = -12.0      # softplus ~6e-6 < NU_LO
    nu_pre[2, :3] = 2.0e4      # softplus > NU_HI
    depth = rng.uniform(0.5, 30.0, size=(B, 1)).astype(np.float32)
    return x.astype(dtype), h, nu_pre, depth


def _t(args, grad=False):
    out = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    if grad:
        for t in out[1:]:
            t.requires_grad_()
    return out


def _close(got, want, rtol, atol_scale, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol_scale * max(1e-3, float(np.abs(want).max())), err_msg=what)


@pytest.mark.parametrize("const", [False, True])
@pytest.mark.parametrize("D", [256, 700])  # one tile / a masked last tile
def test_fwd_ref_matches_pallas_interpret(monkeypatch, D, const):
    """K7's plain version against the Pallas forward's four outputs."""
    monkeypatch.setattr(jne, "_INTERPRET", True)
    args = _inputs(D=D, seed=D)
    td = jne._tile_d(D)
    out, lse, rowsum, ddepth, _ = jne._fwd_call(
        *(jnp.asarray(a) for a in args), td, const)
    B = args[0].shape[0]
    got = tne.elbo_fwd_ref(*_t(args), const)
    np.testing.assert_allclose(float(got[0]), float(out), rtol=2e-5)
    for name, g, w in zip(("lse", "rowsum", "ddepth"), got[1:],
                          (lse, rowsum, ddepth)):
        _close(g, np.asarray(w)[:B], 2e-5, 1e-6, name)


@pytest.mark.parametrize("D", [256, 700])
def test_bwd_ref_matches_pallas_interpret(monkeypatch, D):
    """K8's plain version against the Pallas backward from the same
    residuals, clamp edges included (dnu zero there in both)."""
    monkeypatch.setattr(jne, "_INTERPRET", True)
    args = _inputs(D=D, seed=D + 1, dtype=np.int16)
    td = jne._tile_d(D)
    _, lse, rowsum, _, padded = jne._fwd_call(
        *(jnp.asarray(a, jnp.float32) for a in args), td)
    B = args[0].shape[0]
    g = 1.7
    dh, dnu = jne._bwd_call(jnp.float32(g), *padded, lse, rowsum, td, B)
    lt = torch.from_numpy(np.array(lse)[:B])
    rt = torch.from_numpy(np.array(rowsum)[:B])
    gdh, gdnu = tne.elbo_bwd_ref(torch.tensor(g), *_t(args), lt, rt)
    _close(gdh, dh, 5e-4, 5e-6, "dh")
    _close(gdnu, dnu, 5e-4, 5e-6, "dnu")
    edges = np.zeros_like(args[0], bool)
    edges[1, :3] = edges[2, :3] = True
    assert (gdnu.numpy()[edges] == 0).all() and (np.asarray(dnu)[edges]
                                                 == 0).all()


def _jax_value_and_grad(fn, args):
    x = jnp.asarray(args[0], jnp.float32)
    return jax.value_and_grad(lambda h, n, d: fn(x, h, n, d),
                              argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in args[1:]))


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("const", [False, True])
@pytest.mark.parametrize("D", [256, 700])
def test_nllik_fused_matches_jax(monkeypatch, D, const, interpret):
    """``nb_nllik_fused`` (K7's and K8's plain versions on the CPU) value
    and gradients in (h, nu_pre, depth), with a cotangent of 1.5, against
    JAX's ``nb_nllik_fused`` — its XLA spec, or its Pallas kernels in
    interpret mode."""
    monkeypatch.setattr(jne, "_INTERPRET", interpret)
    args = _inputs(D=D, seed=3 * D, dtype=np.int8)
    v, g = _jax_value_and_grad(
        lambda *a: jne.nb_nllik_fused(*a, const), args)
    targs = _t(args, grad=True)
    got = tne.nb_nllik_fused(*targs, const)
    np.testing.assert_allclose(float(got.detach()), float(v), rtol=2e-5)
    (got * 1.5).backward()
    for name, t, w in zip(("dh", "dnu", "ddepth"), targs[1:], g):
        _close(t.grad / 1.5, w, 5e-4, 5e-6, name)
    assert targs[0].grad is None  # the counts are data


@pytest.mark.parametrize("const", [False, True])
def test_reference_impl_matches_jax(const):
    """The port's ``_reference_impl`` (torch.lgamma, autograd) against
    JAX's (``lax.lgamma``, ``jax.grad``)."""
    args = _inputs(D=700, seed=11)
    v, g = _jax_value_and_grad(
        lambda *a: jne._reference_impl(*a, include_data_const=const), args)
    targs = _t(args, grad=True)
    got = tne._reference_impl(*targs, include_data_const=const)
    np.testing.assert_allclose(float(got.detach()), float(v), rtol=2e-5)
    got.backward()
    for name, t, w in zip(("dh", "dnu", "ddepth"), targs[1:], g):
        _close(t.grad, w, 5e-4, 5e-6, name)


def test_cpu_wrappers_launch_no_kernel():
    args = _t(_inputs(B=3, D=64, seed=5))
    before = (tne.elbo_fwd.launches, tne.elbo_fwd.const_launches,
              tne.elbo_bwd.launches)
    nll, lse, rs, _ = tne.elbo_fwd(*args, True)
    tne.elbo_bwd(torch.tensor(1.0), *args, lse, rs)
    assert (tne.elbo_fwd.launches, tne.elbo_fwd.const_launches,
            tne.elbo_bwd.launches) == before
    with pytest.raises(ValueError, match="no kernel"):
        tne._check("nb_elbo.fwd", args[0], {})


# ----------------------------------------------------------------------
# K7's and K8's launch plan, the C entry's check of it, and a float32
# mirror of the count-regime arithmetic the kernels use
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B,D,cluster,slice_,instance", [
    (100, 20000, 8, 2528, "onchip"),    # the CLI's batch
    (1, 20000, 8, 2528, "onchip"),
    (300, 20000, 8, 2528, "onchip"),
    (100, 1003, 1, 1024, "onchip"),
    (37, 5001, 4, 1280, "onchip"),
    (2, 160000, 8, 20000, "reread"),   # a slice past a block's shared memory
])
def test_elbo_plan(B, D, cluster, slice_, instance):
    """The plan depends on (B, D) alone: a power-of-two cluster of at most
    8 blocks a row, each block a non-empty slice of whole warps of
    columns, the on-chip instance exactly when the slice's 12 bytes a
    column fit; K8's grid covers D in blocks of 1,024 columns."""
    plan = tne.elbo_plan(B, D)
    assert (plan.cluster, plan.slice, plan.instance) == (cluster, slice_,
                                                          instance)
    assert plan.threads == 256 and plan.grid == cluster * B
    assert plan.workspace == 4 * B
    assert plan.slice % 32 == 0
    assert plan.slice * plan.cluster >= D > plan.slice * (plan.cluster - 1)
    onchip = plan.slice * 12 <= tne.ELBO_SLICE_SMEM
    assert (plan.instance == "onchip") == onchip
    assert plan.smem == (plan.slice * 12 if onchip else 0)
    assert plan.bwd_block_cols == 1024
    assert plan.bwd_grid == (-(-D // 1024), B)


def test_elbo_plan_refusals_and_instance_edge():
    for B, D in ((0, 10), (3, 0), (65536, 10)):
        with pytest.raises(ValueError):
            tne.elbo_plan(B, D)
    assert tne.elbo_plan(2, 154112).instance == "onchip"
    assert tne.elbo_plan(2, 154113).instance == "reread"
    assert tne.elbo_plan(65535, 1).cluster == 1


def _c_body(name):
    import os
    src = open(os.path.join(os.path.dirname(tne.__file__), "..", "csrc",
                            "nb_elbo.cu")).read()
    i = src.index(f"inline bool {name}(")
    return src[i:src.index("\n}\n", i)]


def _c_accepts(D, cluster, threads, slice_, onchip):
    """``fwd_plan_ok`` of csrc/nb_elbo.cu, condition by condition (the
    test below reads each one in the source)."""
    return (threads == 256 and 1 <= cluster <= 8
            and cluster & (cluster - 1) == 0 and slice_ >= 1
            and slice_ % 32 == 0 and slice_ * cluster >= D
            and slice_ * (cluster - 1) < D
            and onchip == (1 if slice_ * 12 <= 232448 - 1024 else 0))


def test_c_entry_refuses_a_plan_that_does_not_match():
    """The C entry's check (``fwd_plan_ok``) holds every condition the
    mirror holds; it takes every plan ``elbo_plan`` gives and refuses each
    kind of mismatch: another thread count, a cluster that is no power of
    two or past 8, a slice of partial warps, slices that leave columns
    out or a block empty, the other instance."""
    body = _c_body("fwd_plan_ok")
    for cond in ("threads == kFwdThreads", "cluster >= 1",
                 "cluster <= kMaxCluster", "(cluster & (cluster - 1)) == 0",
                 "slice >= 1", "slice % kSliceAlign == 0",
                 "slice * cluster >= D", "slice * (cluster - 1) < D",
                 "onchip == (slice * kColBytes <= kSliceSmem ? 1 : 0)"):
        assert cond in body, cond
    for B, D in ((1, 1), (100, 257), (100, 1003), (100, 20000), (5, 2049),
                 (2, 154112), (2, 154113), (2, 160000)):
        p = tne.elbo_plan(B, D)
        args = (D, p.cluster, p.threads, p.slice, int(p.instance == "onchip"))
        assert _c_accepts(*args)
        D_, cl, th, sl, oc = args
        short = 32 * ((D_ - 1) // cl // 32)    # leaves columns out
        bads = [(D_, cl, 512, sl, oc), (D_, 3, th, sl, oc),
                (D_, 16, th, sl, oc), (D_, cl, th, sl + 1, oc),
                (D_, cl, th, short, int(short * 12 <= 232448 - 1024)),
                (D_, cl, th, sl, 1 - oc)]
        if cl > 1:                              # leaves the last block empty
            bads.append((D_, cl, th, 2 * sl, int(2 * sl * 12 <= 231424)))
        for bad in bads:
            assert not _c_accepts(*bad), (args, bad)
    dims = _c_body("elbo_dims_ok")
    assert "B <= 65535" in dims and "D >= 1" in dims


def _f(v):
    return torch.as_tensor(v, dtype=torch.float32)


def _fast_products(x, nu, dg, const):
    """nbk::fast_products in float32: P = prod_{k<min(x,7)} (nu + k),
    dP = dP/dnu, Pc = min(x, 7)!, by selects."""
    P, dP = torch.ones_like(nu), torch.zeros_like(nu)
    for k in range(7):
        sel = x > k
        m = nu + _f(k)
        if dg:
            dP = torch.where(sel, dP * m + P, dP)
        P = torch.where(sel, P * m, P)
    Pc = torch.ones_like(nu)
    if const:
        for k in range(2, 8):
            Pc = torch.where(x >= k, Pc * _f(k), Pc)
    return P, dP, Pc


def _stirling_lgamma32(w):
    iw = 1.0 / w
    iw2 = iw * iw
    corr = iw * (_f(1 / 12) - iw2 * (_f(1 / 360) - iw2 * _f(1 / 1260)))
    return (w - 0.5) * torch.log(w) - w + _f(0.9189385332046727) + corr


def _stirling_digamma32(w):
    iw = 1.0 / w
    iw2 = iw * iw
    return torch.log(w) - 0.5 * iw - iw2 * (
        _f(1 / 12) - iw2 * (_f(1 / 120) - iw2 * _f(1 / 252)))


def _lg_terms32(fast, x, nu, const):
    """nbk::lg_terms<CONST> in the all <= 7 (fast) or all-integer (mixed)
    regime: lgamma(nu) - lgamma(nu + x) [+ lgamma(x + 1)]."""
    P, _, Pc = _fast_products(x, nu, False, const)
    if fast:
        return torch.log(Pc / P) if const else -torch.log(P)
    small = x <= 7
    lg = -torch.log(P) + torch.where(
        small, torch.zeros_like(nu),
        _stirling_lgamma32(nu + 7) - _stirling_lgamma32(
            torch.clamp_min(nu + x, 8.0)))
    if const:
        lg = lg + torch.where(small, torch.log(Pc), _stirling_lgamma32(
            torch.clamp_min(x, 8.0) + 1))
    return lg


def _dg_term32(x, nu):
    """nbk::dg_term in the integer regimes (both give the same bits for
    counts <= 7): digamma(nu) - digamma(nu + x)."""
    P, dP, _ = _fast_products(x, nu, True, False)
    return -dP / P + torch.where(
        x > 7, _stirling_digamma32(nu + 7) - _stirling_digamma32(
            torch.clamp_min(nu + x, 8.0)), torch.zeros_like(nu))


def _digamma_q32(z):
    """nb_elbo.cu's digamma_q: the eight shift reciprocals as dP / P, and
    Stirling's 1/w, from one divide 1/(P w)."""
    P, dP = torch.ones_like(z), torch.zeros_like(z)
    for k in range(8):
        m = z + _f(k)
        dP = dP * m + P
        P = P * m
    shift = z < 8
    P = torch.where(shift, P, torch.ones_like(z))
    dP = torch.where(shift, dP, torch.zeros_like(z))
    w = torch.where(shift, z + 8, z)
    r = 1.0 / (P * w)
    iw = P * r
    iw2 = iw * iw
    return (torch.log(w) - 0.5 * iw - iw2 * (
        _f(1 / 12) - iw2 * (_f(1 / 120) - iw2 * _f(1 / 252))) - dP * (w * r))


# nu on both clamps (NU_LO + EPS, NU_HI + EPS) and between
_NUS = (tne.NU_LO + tne.EPS, 1e-3, 0.37, 3.7, 42.0, tne.NU_HI + tne.EPS)
_COUNTS = {"0-7": np.arange(8.0), "8-255": np.arange(8.0, 256.0),
           "non-integer": np.array([0.37, 1.5, 6.99, 7.25, 12.6, 254.5])}


def _grid(counts):
    x, nu = np.meshgrid(_COUNTS[counts], np.array(_NUS))
    return _f(x.ravel()), _f(nu.ravel())


@pytest.mark.parametrize("const", [False, True])
@pytest.mark.parametrize("counts", ["0-7", "8-255", "non-integer"])
def test_lgamma_regimes_against_float64(counts, const):
    """K7's lgamma terms in float32 in the regime its block takes for
    such counts (select-products at 0-7, saturated products plus Stirling
    at 8-255, the shift-into-Stirling lgamma_pos otherwise) against
    float64 ``torch.lgamma``, within 3e-6 of the pieces' magnitudes."""
    x, nu = _grid(counts)
    if counts == "non-integer":
        got = tne._lgamma_pos(nu) - tne._lgamma_pos(nu + x)
        if const:
            got = got + tne._lgamma_pos(x + 1)
    else:
        got = _lg_terms32(counts == "0-7", x, nu, const)
    assert got.dtype == torch.float32
    xd, nd = x.double(), nu.double()
    pieces = [torch.lgamma(nd), -torch.lgamma(nd + xd)]
    if const:
        pieces.append(torch.lgamma(xd + 1))
    want = sum(pieces)
    tol = 3e-6 * sum(p.abs() for p in pieces) + 1e-6
    assert ((got.double() - want).abs() <= tol).all()
    if counts != "non-integer":   # the mixed regime agrees with the fast one
        mixed = _lg_terms32(False, x, nu, const)
        assert ((mixed.double() - want).abs() <= tol).all()


@pytest.mark.parametrize("counts", ["0-7", "8-255", "non-integer"])
def test_digamma_regimes_against_float64(counts):
    """K8's digamma difference in float32: the integer regimes' dg_term
    and the general regime's dP / P quotient (digamma_q, also at integer
    counts) against float64 ``torch.digamma``, within 3e-6 of the pieces'
    magnitudes; the quotient against the eight reciprocals of the plain
    ``_digamma_pos``."""
    x, nu = _grid(counts)
    want = torch.digamma(nu.double()) - torch.digamma((nu + x).double())
    tol = 3e-6 * (torch.digamma(nu.double()).abs()
                  + torch.digamma((nu + x).double()).abs()) + 1e-6
    quot = _digamma_q32(nu) - _digamma_q32(nu + x)
    assert ((quot.double() - want).abs() <= tol).all()
    if counts != "non-integer":
        assert ((_dg_term32(x, nu).double() - want).abs() <= tol).all()
    z = torch.cat([nu, nu + x])
    assert torch.allclose(_digamma_q32(z), tne._digamma_pos(z), rtol=2e-6,
                          atol=2e-6)


# ----------------------------------------------------------------------
# K2v: the value-bearing boot step
# ----------------------------------------------------------------------

def _step_inputs(dtype, B=10, D=700, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.poisson(3.0, size=(B, D)).clip(0, 40).astype(np.float32)
    x[:, :64] = x[:, :64].clip(0, 6)  # a block of the select-product regime
    if dtype == np.float32:
        x[0, 100:107] += 0.5          # and one of the Stirling regime
    zm = rng.normal(size=(B, 2)).astype(np.float32)
    c = np.ones((B, 1), np.float32)
    zn = rng.normal(size=(B, 1)).astype(np.float32)
    depth = (np.abs(rng.normal(size=(B, 1))) * 20 + 0.3).astype(np.float32)
    w = [(rng.normal(size=s) * 0.2).astype(np.float32)
         for s in ((2, D), (1, D), (D,), (1, D), (D,))]
    return [x.astype(dtype), zm, c, zn, depth, *w]


DIFF = (1, 3, 4, 5, 6, 7, 8, 9)


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_nb_step_boot_matches_jax(monkeypatch, dtype, interpret):
    """``nb_step_boot``'s value (K2v's plain version) and gradients, with
    a cotangent of 1.5, against JAX's ``nb_step_boot`` in XLA and in
    Pallas interpret mode."""
    monkeypatch.setattr(jns, "_INTERPRET", interpret)
    args = _step_inputs(dtype, seed=int(interpret))
    ja = [jnp.asarray(a) for a in args]

    def loss(*d):
        a = list(ja)
        for i, v in zip(DIFF, d):
            a[i] = v
        return jns.nb_step_boot(*a)

    v, g = jax.value_and_grad(loss, argnums=tuple(range(len(DIFF))))(
        *(ja[i] for i in DIFF))
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    for i in DIFF:
        targs[i].requires_grad_()
    got = tns.nb_step_boot(*targs)
    np.testing.assert_allclose(float(got.detach()), float(v), rtol=2e-5)
    (got * 1.5).backward()
    for i, w in zip(DIFF, g):
        _close(targs[i].grad / 1.5, w, 5e-4, 5e-6, f"arg {i}")


def test_valgrad_value_equals_value_ref():
    """K2v's plain value is the reporting value without lgamma(x + 1),
    and its gradient outputs are the grad-only ones, exactly; so are
    K2pv's (``joint``: a pb row last, exp-nu) against the joint
    variants."""
    args = _step_inputs(np.int16, B=6, D=300, seed=4)
    x, zm, c, zn, depth, *w = [torch.from_numpy(np.ascontiguousarray(a))
                               for a in args]
    zc = torch.cat([zm, c], 1)
    W = tns.stack_rows(*w)
    norm = tns.lse(zc, W, 2, 1)
    *grads, nll = tns.valgrad(x, zc, zn, depth, norm, W, 2, 1, 1,
                              need_value=True)
    assert torch.equal(nll, tns.value_ref(x, zc, zn, depth, norm, W, 2, 1,
                                          1, with_const=False))
    for a, b in zip(grads, tns.valgrad(x, zc, zn, depth, norm, W, 2, 1, 1)):
        assert torch.equal(a, b)
    pb = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, x.shape[1])).astype(np.float32) * 0.3)
    Wj = torch.cat([W, pb])
    *grads, nll = tns.valgrad(x, zc, zn, depth, norm, Wj, 2, 1, 1,
                              joint=True, need_value=True)
    assert torch.equal(nll, tns.value_ref(x, zc, zn, depth, norm, Wj, 2, 1,
                                          1, with_const=False, joint=True))
    for a, b in zip(grads, tns.valgrad(x, zc, zn, depth, norm, Wj, 2, 1, 1,
                                       joint=True)):
        assert torch.equal(a, b)
