"""The vMF+NB models' generic step in the port against the JAX package:
the value-bearing joint boot step (K2pv's plain version,
``nb_step_boot_joint``), ``forward`` and the composite losses of the
joint model and the labeled mixture with hidden layers and a vMF
decoder, and their ``fused_step_report`` / ``fused_step_boot`` with the
first gradient per leaf, on both of the port's routes (``plain=False``:
the folded count-encoder call and the step kernels' plain versions on
the CPU; ``plain=True``: JAX's unfolded spec).

The noise is JAX's: the keys ``forward`` splits, drawn with JAX and fed
to the port as ``eps`` (and, at eval, the mixture's Gumbel uniforms).

Tolerances and why:

- K2pv: value ``rtol=3e-5`` and cotangents ``rtol=5e-4, atol=5e-6 *
  max|ref|`` (tests/test_torch_vmfnb_ops.py's joint-step bounds: the
  Pallas kernels use the shift-into-Stirling lgamma / digamma and one
  shared reciprocal, the plain version ``lgamma`` / ``digamma``);
- forward outputs ``rtol=1e-5, atol=1e-5 * max|ref|`` (float32 sums over
  D in another order; the folded encoder moves the row norm and the
  standardization through the contraction), losses ``rtol=1e-5``;
- first gradients per leaf ``rtol=1e-4, atol=1e-4 * max|ref|``, and on
  the ``ln_kappa`` leaves 8 ulp of ``df`` per count on top: that
  gradient is the small difference of ``df / kappa`` and the Baricz
  midpoint, both ~ ``df / kappa`` (``df = D / 2 - 1``, the mixture's
  ``dd / 2 - 1``), in float32 in either package (the PR 3 tests' rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.models.vmfnb import VMFNBVAE as JVAE
from mmvae_tpu.models.vmfnb import vmfnb_composite_loss as j_vmfnb_loss
from mmvae_tpu.models.vmfnb_mixture import VMFNBMixtureVAE as JMix
from mmvae_tpu.models.vmfnb_mixture import mixture_composite_loss as j_mix_loss
from mmvae_tpu.ops import nb_step as jns
from mmvae_tpu_torch.models.nb import params_from_numpy
from mmvae_tpu_torch.models.vmfnb import VMFNBVAE, vmfnb_composite_loss
from mmvae_tpu_torch.models.vmfnb_mixture import (VMFNBMixtureVAE,
                                                  mixture_composite_loss)
from mmvae_tpu_torch.ops import nb_step as tns
from tests.test_torch_vmfnb_ops import (DIFF, _assert_grads, _inputs,
                                        _jax_grads, _torch)

D, B, K = 200, 12, 4
ULP = 1.19e-7

# ----------------------------------------------------------------------
# K2pv: the value-bearing joint boot step
# ----------------------------------------------------------------------

K2PV_CASES = [("le7", np.int8), ("integer", np.int16), ("nonint", np.float32)]


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("regime,dtype", K2PV_CASES)
def test_nb_step_boot_joint_matches_jax(monkeypatch, regime, dtype,
                                        interpret):
    """``nb_step_boot_joint``'s value (K2pv's plain version) and the
    cotangent of every argument, ``pb`` included, scaled by 1.5, against
    JAX's ``nb_step_boot_joint`` on its XLA spec and in Pallas interpret
    mode, with exp(nu_pre) beyond NU_HI in 1% of the columns."""
    monkeypatch.setattr(jns, "_INTERPRET", interpret)
    args = _inputs(regime, dtype, B=8, D=D, seed=20 + int(interpret))
    v, g = _jax_grads(jns.nb_step_boot_joint, args)
    targs = _torch(args, grad=True)
    got = tns.nb_step_boot_joint(*targs)
    np.testing.assert_allclose(float(got.detach()), float(v), rtol=3e-5)
    (got * 1.5).backward()
    _assert_grads([targs[i].grad / 1.5 for i in DIFF], g)


# ----------------------------------------------------------------------
# the models
# ----------------------------------------------------------------------

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        lambda t: t.detach().numpy() if isinstance(t, torch.Tensor) else
        np.asarray(t), tree)))


def _label(Dm=D, Km=K, seed=11):
    """Each feature in each component with p = 0.25, component k holds
    feature k (every component non-empty, some features uncovered)."""
    rng = np.random.default_rng(seed)
    L = (rng.random((Dm, Km)) < 0.25).astype(np.float32)
    L[:Km] = np.eye(Km, dtype=np.float32)
    return L


def _counts(seed=3, dtype=np.int16, rows=B):
    rng = np.random.default_rng(seed)
    x = rng.poisson(0.7, size=(rows, D)).astype(dtype)
    x[0, :5] = 30  # a few tiles of the mixed lgamma regime
    return x


def _jax_params(jmodel, seed=1):
    """Init plus a learned standardization that is not the identity, a
    mu bias, and (mixture) component directions that are not uniform."""
    p = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 10)
    p["x_mean"] = jnp.asarray(rng.random((1, D)).astype(np.float32) * 0.06)
    p["ln_x_sd"] = jnp.asarray(rng.normal(size=(1, D)).astype(np.float32)
                               * 0.5)
    p["mu_bias"] = jnp.asarray(rng.normal(size=(1, D)).astype(np.float32)
                               * 0.2)
    if "ln_vmf_mu" in p:
        p["ln_vmf_mu"] = jnp.asarray(
            rng.normal(size=p["ln_vmf_mu"].shape).astype(np.float32))
    return p


def joint_eps(key, R=2, Rn=1, rows=B):
    """The draws of JAX ``VMFNBVAE.forward``'s key: (nb, nu, vmf)."""
    k_nb, k_nu, k_vmf = jax.random.split(key, 3)
    return tuple(np.array(jax.random.normal(k, (rows, w))) for k, w in
                 ((k_nb, R), (k_nu, Rn), (k_vmf, R)))


def mixture_eps(key, R=2, Rn=1, rows=B, Km=K):
    """The draws of JAX ``VMFNBMixtureVAE.forward``'s key: (mu, nu), and
    the eval-mode Gumbel uniforms."""
    k_g, k_mu, k_nu = jax.random.split(key, 3)
    return (tuple(np.array(jax.random.normal(k, (rows, w)))
                  for k, w in ((k_mu, R), (k_nu, Rn))),
            np.array(jax.random.uniform(k_g, (rows, Km), minval=1e-20,
                                        maxval=1.0)))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), want, rtol=rtol,
        atol=rtol * float(np.abs(want).max()))


JOINT_ARCHS = {
    "hidden_encoder": dict(mean_encoding=(8,)),
    "hidden_decoder": dict(mean_decoding=(6,)),
    "vmf_decoding": dict(vmf_decoding=(5,), mean_encoding=(7, 4),
                         do_relu=True),
}


@pytest.fixture(scope="module", params=list(JOINT_ARCHS))
def joint(request):
    arch = JOINT_ARCHS[request.param]
    jmodel = JVAE(data_dim=D, **arch)
    jparams = _jax_params(jmodel)
    return request.param, jmodel, jparams, VMFNBVAE(data_dim=D, **arch)


@pytest.mark.parametrize("plain", [False, True])
def test_joint_forward_and_loss_match_jax(joint, plain):
    """Every output field of ``forward`` (training mode, the same draws)
    and ``vmfnb_composite_loss``; eval mode's posterior means."""
    _, jmodel, jparams, model = joint
    x = _counts()
    key = jax.random.PRNGKey(5)
    jout = jmodel.forward(jparams, jnp.asarray(x, jnp.float32), key, True)
    jloss = j_vmfnb_loss(jnp.asarray(x, jnp.float32), jout, 0.37)
    params = params_from_numpy(_np(jparams))
    eps = tuple(map(torch.from_numpy, joint_eps(key)))
    out = model.forward(params, torch.from_numpy(x), eps, True, plain=plain)
    assert out._fields == jout._fields
    for name, g, w in zip(out._fields, out, jout):
        _close(g, w)
    loss = vmfnb_composite_loss(torch.from_numpy(x), out, torch.tensor(0.37))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jev = jmodel.forward(jparams, jnp.asarray(x, jnp.float32), key, False)
    ev = model.forward(params, torch.from_numpy(x), None, False, plain=plain)
    for g, w in zip(ev, jev):
        _close(g, w)


def _kappa_tol(x_rows, df, rows):
    """8 ulp of df per count, per ln_kappa weight row (D, 1) and bias."""
    xs = np.abs(x_rows.astype(np.float64))
    return {"weight": 8 * ULP * df * xs.sum(0)[:, None] / rows,
            "bias": np.full((1,), 8 * ULP * df)}


def _assert_grads_by_leaf(got: dict, want: dict, kappa_tol, what):
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        tol = 1e-4 * np.abs(w) + 1e-4 * float(np.abs(w).max()) + 1e-12
        if "ln_kappa" in str(k):
            tol = tol + kappa_tol["weight" if "weight" in str(k) else
                                  "bias"]
        err = np.abs(got[k] - w)
        assert np.all(err <= tol), (f"{what} {k}: max err/tol "
                                    f"{np.max(err / tol):.3g}")


def _port_grad(fn, params):
    leaves = {k: v.requires_grad_() for k, v in
              jax.tree_util.tree_leaves_with_path(params)}
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), list(leaves.values()))
    loss = fn(tree)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.numpy()
                                  for k, g in zip(leaves, grads)}


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("need_value", [True, False])
def test_joint_fused_losses_match_jax(joint, need_value, plain):
    """``fused_step_report`` and ``fused_step_boot(need_value)``: the
    report, the boot loss (its value where the port's route returns one)
    and its first gradient per leaf; a hidden mu decoder takes
    ``forward`` + the composite loss in both packages."""
    name, jmodel, jparams, model = joint
    x = _counts(seed=4, dtype=np.int8)
    jx = jnp.asarray(x)
    key = jax.random.PRNGKey(9)
    beta = 0.37
    jrep = jmodel.fused_step_report(jparams, jx, None, key, beta)
    jv, jg = jax.value_and_grad(lambda p: jmodel.fused_step_boot(
        p, jx, None, key, beta, need_value=need_value))(jparams)
    params = params_from_numpy(_np(jparams))
    eps = tuple(map(torch.from_numpy, joint_eps(key)))
    tx, tb = torch.from_numpy(x), torch.tensor(beta)
    with torch.no_grad():
        rep = model.fused_step_report(params, tx, None, eps, tb, plain=plain)
    np.testing.assert_allclose(float(rep), float(jrep), rtol=1e-5)
    v, g = _port_grad(lambda p: model.fused_step_boot(
        p, tx, None, eps, tb, need_value=need_value, plain=plain), params)
    if need_value or plain or not model._can_fuse_step():
        np.testing.assert_allclose(v, float(jv), rtol=1e-5)
    _assert_grads_by_leaf(g, _leaves(jg),
                          _kappa_tol(x, D / 2 - 1, B), name)


MIXTURE_ARCHS = {
    "hidden_encoder": dict(mean_encoding=(8,)),
    "hidden_decoder": dict(mean_decoding=(6,), mean_encoding=(5,),
                           do_relu=True),
}


@pytest.fixture(scope="module", params=list(MIXTURE_ARCHS))
def mixture(request):
    arch = MIXTURE_ARCHS[request.param]
    label = _label()
    jmodel = JMix(label=label, **arch)
    jparams = _jax_params(jmodel, seed=2)
    return (request.param, jmodel, jparams,
            VMFNBMixtureVAE(label=label, **arch))


def _margin(logits, u):
    """Top-two gap of logits + g per row (float64)."""
    g = -np.log(-np.log(u.astype(np.float64)))
    z = np.sort(np.asarray(logits, np.float64) + g, axis=1)
    return z[:, -1] - z[:, -2]


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("training", [True, False])
def test_mixture_forward_and_loss_match_jax(mixture, training, plain):
    """Every output field of ``forward`` (training: the soft E-step and
    the same draws; eval: the hard Gumbel assignment with JAX's
    uniforms, rows whose top two logits + g lie within 1e-4 excepted)
    and ``mixture_composite_loss``."""
    _, jmodel, jparams, model = mixture
    x = _counts(seed=6)
    key = jax.random.PRNGKey(13)
    jx = jnp.asarray(x, jnp.float32)
    jout = jmodel.forward(jparams, jx, key, training)
    jloss = j_mix_loss(jx, jout, 0.37, jmodel.dd)
    params = params_from_numpy(_np(jparams))
    eps, u = mixture_eps(key)
    out = model.forward(params, torch.from_numpy(x),
                        tuple(map(torch.from_numpy, eps)), training,
                        gumbel_u=torch.from_numpy(u), plain=plain)
    assert out._fields == jout._fields
    sure = (np.ones(B, bool) if training
            else _margin(jout.vmf_logits, u) > 1e-4)
    assert sure.sum() >= B - 1
    for name, g, w in zip(out._fields, out, jout):
        g, w = g.detach().numpy(), np.asarray(w)
        if name in ("vmf_logits", "vmf_kappa", "nb_mu_lnvar", "nb_nu_mean",
                    "nb_nu_lnvar", "nb_recon_nu", "nb_recon_depth"):
            _close(g, w)  # not moved by the assignment
        else:
            _close(g[sure], w[sure])
    if sure.all():
        loss = mixture_composite_loss(torch.from_numpy(x), out,
                                      torch.tensor(0.37), model.dd)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("need_value", [True, False])
def test_mixture_fused_losses_match_jax(mixture, need_value, plain):
    """The mixture's ``fused_step_report`` / ``fused_step_boot`` as the
    joint model's test holds them (``df = dd / 2 - 1`` on ln_kappa)."""
    name, jmodel, jparams, model = mixture
    x = _counts(seed=7, dtype=np.int8)
    jx = jnp.asarray(x)
    key = jax.random.PRNGKey(17)
    beta = 0.37
    jrep = jmodel.fused_step_report(jparams, jx, None, key, beta)
    jv, jg = jax.value_and_grad(lambda p: jmodel.fused_step_boot(
        p, jx, None, key, beta, need_value=need_value))(jparams)
    params = params_from_numpy(_np(jparams))
    eps = tuple(map(torch.from_numpy, mixture_eps(key)[0]))
    tx, tb = torch.from_numpy(x), torch.tensor(beta)
    with torch.no_grad():
        rep = model.fused_step_report(params, tx, None, eps, tb, plain=plain)
    np.testing.assert_allclose(float(rep), float(jrep), rtol=1e-5)
    v, g = _port_grad(lambda p: model.fused_step_boot(
        p, tx, None, eps, tb, need_value=need_value, plain=plain), params)
    if need_value or plain or not model._can_fuse_step():
        np.testing.assert_allclose(v, float(jv), rtol=1e-5)
    _assert_grads_by_leaf(g, _leaves(jg),
                          _kappa_tol(x, model.dd / 2 - 1, B), name)


def test_generic_cpu_losses_launch_no_kernel(joint):
    """On CPU tensors the kernel route runs the plain versions: no launch
    counter moves."""
    _, jmodel, jparams, model = joint
    counters = [(tns.valgrad, a) for a in ("launches", "joint_launches",
                                           "value_launches",
                                           "joint_value_launches")]
    before = [getattr(f, a) for f, a in counters]
    params = params_from_numpy(_np(jparams))
    x = torch.from_numpy(_counts(dtype=np.int8))
    eps = tuple(map(torch.from_numpy, joint_eps(jax.random.PRNGKey(1))))
    model.fused_step_boot(params, x, None, eps, torch.tensor(0.5))
    assert [getattr(f, a) for f, a in counters] == before


def test_count_encode_backward_in_cotangent_dtype():
    """The count encoder's plain backward computes in the cotangent's
    dtype, as its forward does in WL's: a float64 step through the
    kernel route's plain versions (the card's float64 reference step)
    differentiates, and equals autograd of the float64 plain forward."""
    from mmvae_tpu_torch.ops.enc_kernel import count_encode, count_encode_ref

    x = torch.from_numpy(_counts(dtype=np.int8))
    rng = np.random.default_rng(4)
    WL, WX = (torch.from_numpy(rng.normal(size=(r, D))).requires_grad_()
              for r in (3, 2))
    hL, hX, _ = count_encode(x, WL, WX, want_stats=True)
    got = torch.autograd.grad((hL.sum() + 2.0 * hX.sum()), (WL, WX))
    hL, hX = count_encode_ref(x, WL, WX)
    want = torch.autograd.grad((hL.sum() + 2.0 * hX.sum()), (WL, WX))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
