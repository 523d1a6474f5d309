"""The port's vMF-VAE model (mmvae_tpu_torch/models/vmf.py, the Angular
layer of models/modules.py, ops/losses.vmf_loss) against the JAX
package's ``VMFVAE``: the parameter tree, ``angular_apply``, ``encode``,
``decode``, ``forward`` with JAX's noise, ``vmf_loss``, the folded
serving encoder, the model summary, and the kappa clamp's gradient at a
tie.  Parameters and inputs are numpy draws from a seed, handed to both
packages.

Tolerances and why:

- init layout: exact (names, insertion order, shapes);
- ``angular_apply``, ``encode``, ``decode``, ``forward``, ``vmf_loss``:
  ``rtol=1e-5`` with ``atol=1e-5 * max|ref|`` (the same float32 formulas
  in two libraries; sums over D in another order);
- the folded encoder against the unfolded one: ``rtol=1e-5, atol=1e-5 *
  max|ref|`` (the fold moves the standardization through the product);
- the kappa clamp at a tie (``kappa_min`` 0.5 and 1.0, where
  ``exp(log kappa_min)`` is exactly ``kappa_min`` in float32): the clamp's
  own derivative exactly (JAX's 0.25 / 0.5, half of ``exp(ln_kappa)``),
  and the loss's gradient in ``ln_kappa`` at ``rtol=1e-4`` plus 8 ulp of
  ``df`` (``df = D / 2 - 1``): that gradient is the small difference of
  ``df / kappa`` and the Baricz midpoint, both ~ ``df / kappa``, in
  float32 either way (the rule of tests/test_torch_vmfnb_fast.py).
  ``kappa_min`` 0.1 is not a tie (``exp`` gives 0.09999999, below the
  clamp): both libraries give 0 there.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.models import modules as jmodules
from mmvae_tpu.models.vmf import VMFVAE as JVAE, VMFVAEOutput as JOut
from mmvae_tpu.ops.losses import vmf_loss as jvmf_loss
from mmvae_tpu.utils.summary import pretty_print as jpretty_print
from mmvae_tpu_torch.models import modules
from mmvae_tpu_torch.models.nb import params_from_numpy
from mmvae_tpu_torch.models.vmf import VMFVAE, VMFVAEOutput, clip_kappa
from mmvae_tpu_torch.ops.losses import vmf_loss
from mmvae_tpu_torch.utils.summary import pretty_print

D, B = 640, 8
ARCHS = [{}, {"encoding": (6,)}, {"decoding": (5,)},
         {"encoding": (6, 4), "decoding": (5, 3)}]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _setup(arch, do_relu=False, kappa_min=0.1, seed=1):
    """JAX model and params with a learned standardization that is not
    the identity, the port's model, and the same params as numpy."""
    jmodel = JVAE(data_dim=D, covar_dim=2, kappa_min=kappa_min,
                  do_relu=do_relu, **arch)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 10)
    jparams["x_mean"] = jnp.asarray(
        rng.random((1, D)).astype(np.float32) * 1.5 / D ** 0.5)
    jparams["ln_x_sd"] = jnp.asarray(
        rng.normal(size=(1, D)).astype(np.float32) * 0.5)
    model = VMFVAE(data_dim=D, covar_dim=2, kappa_min=kappa_min,
                   do_relu=do_relu, **arch)
    return jmodel, jparams, model, _np(jparams)


def _data(seed=3, rows=B):
    rng = np.random.default_rng(seed)
    x = rng.poisson(0.7, size=(rows, D)).astype(np.float32)
    x[0, :5] = 30
    c = rng.normal(size=(rows, 2)).astype(np.float32)
    return x, c


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_matches_jax(arch):
    """Names, insertion order and shapes of the parameter tree; the
    Angular layers hold a weight and no bias; ln_kappa = log(kappa_min)."""
    want = JVAE(data_dim=33, covar_dim=2, kappa_min=0.5,
                **arch).init(jax.random.PRNGKey(0))
    got = VMFVAE(data_dim=33, covar_dim=2, kappa_min=0.5,
                 **arch).init(torch.Generator().manual_seed(0))
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], dict):
            assert list(got[k]) == list(want[k])
            for leaf in want[k]:
                assert tuple(got[k][leaf].shape) == want[k][leaf].shape
        else:
            assert tuple(got[k].shape) == want[k].shape
    first = "encoding_1" if arch.get("encoding") else "encoding"
    assert list(got[first]) == ["weight"]
    np.testing.assert_array_equal(got["ln_kappa"].numpy(),
                                  np.asarray(want["ln_kappa"]))


def test_angular_apply_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(50, 7)).astype(np.float32)
    w[:, 3] = -1.0  # a unit whose weight is all clipped by the ReLU
    x = rng.normal(size=(9, 50)).astype(np.float32)
    want = jmodules.angular_apply({"weight": jnp.asarray(w)}, jnp.asarray(x))
    got = modules.angular_apply({"weight": torch.from_numpy(w)},
                                torch.from_numpy(x))
    _close(got, want)
    # the Angular stack through init_linear_stack / apply_stack
    params, names, d = modules.init_linear_stack(
        torch.Generator().manual_seed(0), "enc", 50, [7], 3, angular=True)
    assert names == ["enc_1", "enc"] and d == 3
    assert all(list(params[n]) == ["weight"] for n in names)
    jp = {n: {"weight": jnp.asarray(params[n]["weight"].numpy())}
          for n in names}
    _close(modules.apply_stack(params, names, torch.from_numpy(x), True,
                               True, angular=True),
           jmodules.apply_stack(jp, names, jnp.asarray(x), True, True,
                                angular=True))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("do_relu", [False, True])
def test_encode_decode_match_jax(arch, do_relu):
    jmodel, jparams, model, pnp = _setup(arch, do_relu)
    x, c = _data()
    params = params_from_numpy(pnp)
    for cc in (c, None):
        want = jmodel.encode(jparams, jnp.asarray(x),
                             None if cc is None else jnp.asarray(cc))
        got = model.encode(params, torch.from_numpy(x),
                           None if cc is None else torch.from_numpy(cc))
        for g, w in zip(got, want):
            _close(g, w)
    z = np.random.default_rng(5).normal(size=(B, 2)).astype(np.float32)
    _close(model.decode(params, torch.from_numpy(z), torch.from_numpy(c)),
           jmodel.decode(jparams, jnp.asarray(z), jnp.asarray(c)))


@pytest.mark.parametrize("arch", ARCHS[:2])
@pytest.mark.parametrize("training", [True, False])
def test_forward_and_loss_match_jax(arch, training):
    """``forward`` with JAX's noise (the normal draw ``reparameterize``
    makes from the key) and ``vmf_loss`` on its output."""
    jmodel, jparams, model, pnp = _setup(arch, kappa_min=0.5)
    x, c = _data(seed=4)
    key = jax.random.PRNGKey(9)
    jout = jmodel.forward(jparams, jnp.asarray(x), jnp.asarray(c), key,
                          training)
    eps = np.array(jax.random.normal(key, (B, 2)))
    out = model.forward(params_from_numpy(pnp), torch.from_numpy(x),
                        torch.from_numpy(c), (torch.from_numpy(eps),),
                        training)
    assert isinstance(out, VMFVAEOutput)
    for g, w in zip(out, jout):
        _close(g, w)
    _close(vmf_loss(torch.from_numpy(x), out, 0.37),
           jvmf_loss(jnp.asarray(x), jout, 0.37))


def test_vmf_loss_matches_jax_on_integer_counts():
    """int16 counts, unit recon rows, a kappa inside the clamp."""
    rng = np.random.default_rng(8)
    x = rng.poisson(1.1, size=(B, D)).astype(np.int16)
    recon = rng.random((B, D)).astype(np.float32)
    recon /= np.linalg.norm(recon, axis=1, keepdims=True)
    mean = rng.normal(size=(B, 2)).astype(np.float32)
    lnvar = rng.normal(size=(B, 2)).astype(np.float32)
    kappa = np.asarray([3.7], np.float32)
    want = jvmf_loss(jnp.asarray(x), JOut(*map(jnp.asarray, (
        recon, mean, lnvar, kappa))), 0.2)
    got = vmf_loss(torch.from_numpy(x), VMFVAEOutput(*map(
        torch.from_numpy, (recon, mean, lnvar, kappa))), 0.2)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS[:2])
@pytest.mark.parametrize("do_relu", [False, True])
def test_folded_encoder_matches_unfolded(arch, do_relu):
    """The serving encoder (the standardization folded through the
    Angular first layer) against the unfolded ``encode`` with no
    covariate, and against JAX's ``encode``."""
    jmodel, jparams, model, pnp = _setup(arch, do_relu)
    x, _ = _data(seed=6, rows=12)
    params = params_from_numpy(pnp)
    got = model.encode_mu(params, torch.from_numpy(x))
    for g, u, w in zip(got, model.encode(params, torch.from_numpy(x)),
                       jmodel.encode(jparams, jnp.asarray(x))):
        _close(g, u.numpy())
        _close(g, w)
    fn, extra = model.record_encoder(0, B)
    assert extra is None and model.latent_names == ("latent_mean",
                                                   "latent_lnvar")
    for g, r in zip(got, fn(params, torch.from_numpy(x))):
        np.testing.assert_array_equal(g.numpy(), r.numpy())


@pytest.mark.parametrize("kappa_min", [0.1, 0.5, 1.0])
def test_kappa_tie_gradient_matches_jax(kappa_min):
    """At ``ln_kappa = log(kappa_min)`` (the init) the clamp's derivative
    is JAX's ``jnp.clip`` rule, and so is the loss's gradient in
    ``ln_kappa``."""
    ln = jnp.full((1,), np.log(kappa_min), jnp.float32)
    jclip = jax.grad(lambda v: jnp.sum(jnp.clip(jnp.exp(v), kappa_min,
                                                10.0)))(ln)
    t = torch.tensor(np.asarray(ln), requires_grad=True)
    clip_kappa(torch.exp(t), kappa_min, 10.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jclip))
    tie = float(np.float32(np.exp(np.float32(np.log(kappa_min))))) \
        == kappa_min
    assert tie == (kappa_min != 0.1)
    assert float(jclip[0]) == (0.5 * kappa_min if tie else 0.0)

    jmodel, jparams, model, pnp = _setup({}, kappa_min=kappa_min)
    x, c = _data(seed=7)
    key = jax.random.PRNGKey(2)
    jg = jax.grad(lambda p: jvmf_loss(jnp.asarray(x), jmodel.forward(
        p, jnp.asarray(x), jnp.asarray(c), key, True), 0.37))(jparams)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (B, 2))))
    params = params_from_numpy(pnp)
    params["ln_kappa"].requires_grad_()
    loss = vmf_loss(torch.from_numpy(x), model.forward(
        params, torch.from_numpy(x), torch.from_numpy(c), (eps,)), 0.37)
    (g,) = torch.autograd.grad(loss, params["ln_kappa"])
    want = np.asarray(jg["ln_kappa"])
    df = D / 2 - 1
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                               atol=8 * 1.19e-7 * df)
    if tie:
        # torch.clamp would pass the whole derivative: twice JAX's
        assert abs(float(want[0])) > 8 * 1.19e-7 * df
    else:
        assert float(g[0]) == float(want[0]) == 0.0


@pytest.mark.parametrize("arch", ARCHS[::3])
def test_pretty_print_matches_jax(arch):
    """The train-start model summary: the JAX CLI's text for the same
    configuration and parameters."""
    jmodel, jparams, model, pnp = _setup(arch)
    want, got = io.StringIO(), io.StringIO()
    jpretty_print(jmodel, pnp, file=want)
    pretty_print(model, params_from_numpy(pnp), file=got)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().startswith("VMFVAE(data_dim=640, covar_dim=2, ")
