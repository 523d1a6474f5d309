"""The port's NB encoder and checkpoints against the JAX package.

``encode_mu`` folds the learned standardization into the first layer
(``log1p(x) @ Wt^T - x_mean @ Wt^T``), so the port and JAX differ by
float32 reassociation and that folding.  The bound scales with the
magnitudes summed, propagated through the layers:
``S_1 = (|log1p x| + |x_mean|) @ |Wt|^T + |b_1|``,
``S_k = S_(k-1) @ |W_k| + |b_k|``, and ``|port - jax| <= 1e-5 S + 1e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmvae_tpu.models.nb import NBVAE as JaxNBVAE
from mmvae_tpu.train import checkpoint as jax_ckpt
from mmvae_tpu_torch.models.nb import NBVAE, params_from_numpy, params_to_numpy
from mmvae_tpu_torch.train import checkpoint as port_ckpt

D, B = 300, 20


def _jax_params(model, seed=0):
    """JAX init, with seeded non-trivial x_mean / ln_x_sd, as numpy."""
    params = jax.tree_util.tree_map(np.asarray,
                                    model.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    params["x_mean"] = rng.normal(0.5, 0.5, (1, D)).astype(np.float32)
    params["ln_x_sd"] = rng.normal(0.0, 0.5, (1, D)).astype(np.float32)
    return params


def _counts(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.poisson(2.0, size=(B, D))
    x[rng.random((B, D)) < 0.02] = 100
    return x.astype(np.int8)


def _bound(params, names, x):
    sd = np.log1p(np.exp(params["ln_x_sd"].astype(np.float64))) + 1e-4
    L = np.log1p(x.astype(np.float64))
    first = params[names[0]]
    S = ((L + np.abs(params["x_mean"])) @ (np.abs(first["weight"]) / sd.T)
         + np.abs(first["bias"]))
    for name in names[1:]:
        S = S @ np.abs(params[name]["weight"]) + np.abs(params[name]["bias"])
    out = {}
    for head in ("mu_representation_mean", "mu_representation_logvariance"):
        out[head] = (S @ np.abs(params[head]["weight"])
                     + np.abs(params[head]["bias"]))
    return out


@pytest.mark.parametrize("mean_encoding", [(), (16,)])
@pytest.mark.parametrize("do_relu", [False, True])
def test_encode_mu_matches_jax(mean_encoding, do_relu):
    kw = dict(data_dim=D, covar_dim=1, mean_encoding=mean_encoding,
              do_relu=do_relu)
    jmodel, pmodel = JaxNBVAE(**kw), NBVAE(**kw)
    params = _jax_params(jmodel)
    x = _counts()
    jmean, jlnvar = jmodel.encode_mu(
        jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(x, jnp.float32))
    with torch.inference_mode():
        mean, lnvar = pmodel.encode_mu(params_from_numpy(params),
                                       torch.from_numpy(x))
    S = _bound(params, pmodel._enc_names(), x)
    for got, want, head in ((mean, jmean, "mu_representation_mean"),
                            (lnvar, jlnvar,
                             "mu_representation_logvariance")):
        err = np.abs(got.numpy().astype(np.float64) - np.asarray(want))
        lim = 1e-5 * S[head] + 1e-6
        assert np.all(err <= lim), f"{head}: err/limit {np.max(err / lim)}"
    assert np.all(np.abs(lnvar.numpy()) <= 4.0)


@pytest.mark.parametrize("mean_encoding", [(), (16,)])
def test_port_init_has_jax_tree(mean_encoding):
    """Same names, nesting and shapes as the JAX init."""
    kw = dict(data_dim=D, covar_dim=1, mean_encoding=mean_encoding)
    want = jax.tree_util.tree_map(
        np.shape, JaxNBVAE(**kw).init(jax.random.PRNGKey(0)))
    got = params_to_numpy(NBVAE(**kw).init(torch.Generator().manual_seed(0)))
    assert jax.tree_util.tree_map(np.shape, got) == want


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_jax_checkpoint_loads_in_port(tmp_path):
    jmodel = JaxNBVAE(data_dim=D, covar_dim=1)
    params = _jax_params(jmodel)
    opt_state = optax.adam(1e-3).init(params)
    jax_ckpt.save_checkpoint(str(tmp_path), params, opt_state, 4, 11,
                             [3.0, 2.5])
    got, next_epoch, loss_vec = port_ckpt.load_checkpoint(
        str(tmp_path), NBVAE(data_dim=D))
    _assert_trees_equal(got, params)
    assert next_epoch == 5 and loss_vec == [3.0, 2.5]


def test_port_checkpoint_loads_in_jax(tmp_path):
    pmodel = NBVAE(data_dim=D, mean_encoding=(16,))
    params = pmodel.init(torch.Generator().manual_seed(7))
    port_ckpt.save_checkpoint(str(tmp_path), params, epoch=2, seed=7,
                              loss_vec=[1.25])
    jmodel = JaxNBVAE(data_dim=D, covar_dim=1, mean_encoding=(16,))
    got, opt, next_epoch, loss_vec = jax_ckpt.load_checkpoint(
        str(tmp_path), jmodel.init(jax.random.PRNGKey(0)), None)
    _assert_trees_equal(got, params_to_numpy(params))
    assert opt is None and next_epoch == 3 and loss_vec == [1.25]
    # and back: the port reads its own file
    back, _, _ = port_ckpt.load_checkpoint(str(tmp_path), pmodel)
    _assert_trees_equal(back, params_to_numpy(params))


def test_load_checkpoint_rejects_wrong_shape(tmp_path):
    port_ckpt.save_checkpoint(str(tmp_path),
                              NBVAE(data_dim=D).init(
                                  torch.Generator().manual_seed(0)), 0, 0)
    with pytest.raises(ValueError, match="shape mismatch"):
        port_ckpt.load_checkpoint(str(tmp_path), NBVAE(data_dim=D + 1))
