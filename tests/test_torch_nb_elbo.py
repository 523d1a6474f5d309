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
