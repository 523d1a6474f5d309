"""The port's generic batch step (mmvae_tpu_torch.train.loop.Trainer with
the NB model's losses) against the JAX package's ``Trainer._batch_step``:
one batch step per route the CLI chooses, the first boot gradient of
each, the 4-epoch ``GOLDEN`` trajectory of tests/test_regression.py, and
the optimizer over a nested tree against optax.

The noise is JAX's: ``_draw_batch``'s key chain (``mmvae_tpu/ops/
nb_fast.py:533-560``), documented there as bitwise equal to the draws
``_batch_step`` makes in the step, is fed to the port's step.

Tolerances:

- first boot gradient: ``rtol=5e-4, atol=5e-6 * max|ref|`` per leaf
  (tests/test_nb_step.py's gradient bound; the kernel routes use the
  shift-into-Stirling lgamma / digamma, JAX's XLA spec ``lgamma``);
- one batch step: the JAX suite's trajectory yardstick
  (tests/test_nb_fast.py) — report ``rtol=2e-4``, params
  ``rtol=3e-3, atol=2e-5``, Adam moments ``rtol=3e-3`` with
  ``atol=1e-8`` (mu) / ``1e-10`` (nu);
- ``GOLDEN``: its own ``rtol=1e-3``;
- the optimizer against optax: ``rtol=1e-6`` (the global norm is summed
  in another order); the moments also ``atol`` 1e-7 of the size of
  ``g + wd * p``'s terms, which cancel in a few elements.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmvae_tpu.models.nb import NBVAE as JNBVAE
from mmvae_tpu.ops.losses import nb_loss as jnb_loss
from mmvae_tpu.ops.nb_fast import NBFastStep as JFast
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import Trainer as JTrainer, make_optimizer
from mmvae_tpu_torch.cli.nb_vae import make_step
from mmvae_tpu_torch.models.nb import NBVAE, params_from_numpy
from mmvae_tpu_torch.ops.nb_fast import (PackedAdam, batch_rand,
                                         rand_from_numpy)
from mmvae_tpu_torch.train.config import TrainingOptions
from mmvae_tpu_torch.train.loop import Trainer
from mmvae_tpu_torch.ops.losses import nb_loss
from tests.test_regression import GOLDEN, _superbatch

D, B = 200, 16

# route -> (architecture, fused, fused_step, boot need_value); the v1
# route at the default architecture (--no_fused_step) is held to GOLDEN
ROUTES = {
    "v2_hidden_encoder": (dict(mean_encoding=(8,)), True, True, False),
    "v1_hidden_decoder": (dict(mean_decoding=(8,)), True, True, False),
    "plain_no_fused": (dict(mean_encoding=(8,), mean_decoding=(6,)), False,
                       True, False),
    "readme_value_boot": (dict(), True, True, True),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_trainer(jmodel, topt, fused, fused_step, need_value):
    """The JAX CLI's generic-step choice (mmvae_tpu/cli/nb_vae.py:149-192)
    without the packed step; ``need_value`` is the README's library
    trainer (fused_step_report / fused_step_boot with their defaults)."""
    kw = {}
    if need_value:
        kw = dict(report_loss_override=jmodel.fused_step_report,
                  boot_loss_override=jmodel.fused_step_boot)
    elif fused and fused_step and jmodel._can_fuse_step():
        kw = dict(
            report_loss_override=lambda p, x, c, k, b: (
                jmodel.fused_step_report(p, x, c, k, b,
                                         include_data_const=True)),
            boot_loss_override=lambda p, x, c, k, b: (
                jmodel.fused_step_boot(p, x, c, k, b, need_value=False)))
    elif fused:
        kw = dict(
            report_loss_override=lambda p, x, c, k, b: jmodel.fused_loss(
                p, x, c, k, b, True, include_data_const=True),
            boot_loss_override=lambda p, x, c, k, b: jmodel.fused_loss(
                p, x, c, k, b, True, include_data_const=False))
    return JTrainer(lambda p, x, c, k, t: jmodel.forward(p, x, c, k, t),
                    lambda x, o, b: jnb_loss(x, o, b), topt,
                    boot_loss_fn=lambda x, o, b: jnb_loss(
                        x, o, b, include_data_const=False), **kw)


def _port_trainer(model, route, plain=False):
    arch, fused, fused_step, need_value = ROUTES[route]
    topt = TrainingOptions(nboot=3, fused=fused, fused_step=fused_step)
    if not need_value:
        step, _ = make_step(model, topt, plain=plain)
        assert isinstance(step, Trainer)
        return step
    return Trainer(
        lambda p, x, c, e, t: model.forward(p, x, c, e, t),
        lambda x, out, b: nb_loss(x, *out, b), topt, eps_widths=(2, 1),
        report_loss_override=lambda p, x, c, e, b: model.fused_step_report(
            p, x, c, e, b, plain=plain),
        boot_loss_override=lambda p, x, c, e, b: model.fused_step_boot(
            p, x, c, e, b, plain=plain))


def _draws(key, R, Rn, batch=B, nboot=3):
    """JAX's ``_draw_batch`` for one batch key."""
    fake = types.SimpleNamespace(rows=types.SimpleNamespace(R=R, Rn=Rn),
                                 opt=types.SimpleNamespace(nboot=nboot))
    return _np(JFast._draw_batch(fake, key, batch))


def _batch(seed=3, dtype=np.int16):
    rng = np.random.default_rng(seed)
    x = rng.poisson(0.7, size=(B, D)).astype(dtype)
    x[0, :5] = 30  # a few blocks of the mixed lgamma regime
    return x, np.ones((B, 1), np.float32)


def _boot_key(key):
    """(k_idx, k_fwd) of boot step 0 in ``_batch_step``'s key chain."""
    k_boot = jax.random.split(key)[1]
    return jax.random.split(jax.random.fold_in(k_boot, 0))


@pytest.fixture(scope="module", params=list(ROUTES))
def route(request):
    """A route's models, initial params, and the JAX results both tests
    compare with: the first boot loss's gradient (batch 3, key 7) and one
    ``_batch_step`` (batch 5, key 11)."""
    name = request.param
    arch, fused, fused_step, need_value = ROUTES[name]
    jmodel = JNBVAE(data_dim=D, covar_dim=1, **arch)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    jtr = _jax_trainer(jmodel, JOptions(nboot=3), fused, fused_step,
                       need_value)
    beta = 0.37

    @jax.jit
    def boot_grad(p, x, c, key):
        k_idx, k_fwd = _boot_key(key)
        ridx = jax.random.randint(k_idx, (B,), 0, B)
        xb, cb = jnp.take(x, ridx, 0), jnp.take(c, ridx, 0)
        if jtr._boot_override is not None:
            return jax.grad(lambda q: jtr._boot_override(
                q, xb, cb, k_fwd, beta))(p)
        return jax.grad(lambda q: jtr.boot_loss_fn(
            xb, jtr.forward(q, xb, cb, k_fwd, True), beta))(p)

    x, c = _batch()
    jgrad = boot_grad(jparams, jnp.asarray(x, jnp.float32), jnp.asarray(c),
                      jax.random.PRNGKey(7))
    x, c = _batch(seed=5)
    jstep = jax.jit(jtr._batch_step)(
        jparams, jtr.optimizer.init(jparams), jnp.asarray(x, jnp.float32),
        jnp.asarray(c), jnp.float32(1.0), jax.random.PRNGKey(11))
    return (name, NBVAE(data_dim=D, **arch), jparams, beta, _np(jgrad),
            _np(jstep))


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        lambda t: t.detach().numpy() if isinstance(t, torch.Tensor) else
        np.asarray(t), tree)))


def _assert_tree(got, want, **tol):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=str(k), **tol)


@pytest.mark.parametrize("plain", [False, True])
def test_first_boot_gradient_matches_jax(route, plain):
    """The named-tree gradient of the first boot loss, before any update,
    on the same resampled rows and noise."""
    name, model, jparams, beta, jgrad, _ = route
    x, c = _batch()
    rnd = rand_from_numpy(_draws(jax.random.PRNGKey(7), model.mean_latent,
                                 model.overdisp_latent))
    tr = _port_trainer(model, name, plain)
    leaves = {k: v.requires_grad_() for k, v in
              jax.tree_util.tree_leaves_with_path(params_from_numpy(
                  _np(jparams)))}
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jparams), list(leaves.values()))
    r = rnd["ridx"][0]
    loss = tr._boot(params, torch.from_numpy(x).index_select(0, r),
                    torch.from_numpy(c).index_select(0, r),
                    tuple(e[0] for e in rnd["boot_eps"]), torch.tensor(beta))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    want = _leaves(jgrad)
    for (k, _), g in zip(leaves.items(), grads):
        w = want[k]
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-4,
                                   atol=5e-6 * float(np.abs(w).max()),
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("plain", [False, True])
def test_batch_step_matches_jax(route, plain):
    """One ``_batch_step`` (report + 3 bootstrap Adam steps) from the same
    params and the same JAX-drawn noise."""
    name, model, jparams, _, _, (jp2, jst, jrep) = route
    x, c = _batch(seed=5)
    tr = _port_trainer(model, name, plain)
    rnd = rand_from_numpy(jax.tree_util.tree_map(
        lambda a: a[None], _draws(jax.random.PRNGKey(11), model.mean_latent,
                                  model.overdisp_latent)))
    params = params_from_numpy(_np(jparams))
    p2, st, rep = tr.batch_step(params, tr.optimizer.init(params),
                                torch.from_numpy(x), torch.from_numpy(c),
                                1.0, batch_rand(rnd, 0))
    np.testing.assert_allclose(float(rep), float(jrep), rtol=2e-4)
    _assert_tree(p2, jp2, rtol=3e-3, atol=2e-5)
    _assert_tree(st["mu"], jst[2].mu, rtol=3e-3, atol=1e-8)
    _assert_tree(st["nu"], jst[2].nu, rtol=3e-3, atol=1e-10)
    assert int(st["count"]) == int(jst[2].count) == 3


@pytest.mark.parametrize("route_name", ["v1_no_fused_step",
                                        "plain_no_fused"])
def test_golden_trajectory(route_name):
    """tests/test_regression.py's 4-epoch ``GOLDEN`` (D = 40, 5 batches of
    24, nboot 3, seed 0) with the port's Trainer fed JAX's draws:
    ``--no_fused_step`` (K7 / K8's plain versions) and ``--no_fused``
    (forward + nb_loss) at the default architecture."""
    x_sb, c_sb = _superbatch()
    S, Bs = x_sb.shape[:2]
    jmodel = JNBVAE(data_dim=40, covar_dim=1)
    params = params_from_numpy(_np(jmodel.init(jax.random.PRNGKey(0))))
    model = NBVAE(data_dim=40)
    fused = route_name == "v1_no_fused_step"
    tr, _ = make_step(model, TrainingOptions(nboot=3, fused=fused,
                                             fused_step=False))
    st = tr.optimizer.init(params)
    losses = []
    for epoch in range(4):
        ekey = jax.random.fold_in(jax.random.PRNGKey(0), epoch)
        reps = []
        for b in range(S):
            rnd = rand_from_numpy(jax.tree_util.tree_map(
                lambda a: a[None], _draws(jax.random.fold_in(ekey, b), 2, 1,
                                          batch=Bs)))
            params, st, rep = tr.batch_step(
                params, st, torch.from_numpy(x_sb[b]),
                torch.from_numpy(c_sb[b]), float(epoch), batch_rand(rnd, 0))
            reps.append(float(rep))
        losses.append(float(np.mean(reps)))
    np.testing.assert_allclose(losses, GOLDEN, rtol=1e-3)


@pytest.mark.parametrize("clip_active", [True, False])
def test_optimizer_on_named_tree_matches_optax(clip_active):
    """The generalised Adam over the named hidden-layer tree against the
    JAX trainer's optax chain (leaves summed in pytree order)."""
    jmodel = JNBVAE(data_dim=50, covar_dim=1, mean_encoding=(8, 4),
                    mean_decoding=(6,))
    jparams = jmodel.init(jax.random.PRNGKey(3))
    topt = JOptions()
    opt = make_optimizer(topt)
    jstate = opt.init(jparams)
    port = PackedAdam(topt.lr, topt.grad_clip, topt.weight_decay)
    q = params_from_numpy(_np(jparams))
    state = port.init(q)
    rng = np.random.default_rng(4)
    scale = 1.0 if clip_active else 1e-4
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32),
            _np(jparams))
        upd, jstate = jax.jit(opt.update)(
            jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        q, state = port.update(params_from_numpy(g), state, q)
    _assert_tree(q, jparams, rtol=1e-6, atol=1e-9)
    # the moments round g + wd * p, whose terms are ~scale and ~wd (p ~ 1)
    # and cancel in a few elements: 1e-7 of their size
    size = scale + topt.weight_decay
    _assert_tree(state["mu"], jstate[2].mu, rtol=1e-6, atol=1e-7 * size)
    _assert_tree(state["nu"], jstate[2].nu, rtol=1e-6,
                 atol=1e-7 * size * size)
    assert int(state["count"]) == int(jstate[2].count) == 3
