"""The vMF+NB models on the port's generic batch step
(mmvae_tpu_torch.train.loop.Trainer with the models' losses, as
``cli.vmfnb_vae.make_step`` builds it) against the JAX package's
``Trainer._batch_step``: one batch step per route the JAX CLI takes,
and the library trainer of the JAX README (``fused_step_report`` /
``fused_step_boot`` with their defaults: the value-bearing boot, K2pv),
for the joint model and the labeled mixture, on both of the port's
routes; and the 4-epoch ``GOLDEN_VMFNB`` / ``GOLDEN_MIXTURE``
trajectories of tests/test_regression.py.

The noise is JAX's: ``VMFNBFastStep._draw_batch`` /
``VMFNBMixtureFastStep._draw_batch`` (``mmvae_tpu/ops/vmfnb_fast.py:
337-360, 632-657``), documented there as equal to the draws the generic
path makes in the step, is fed to the port's step.

Tolerances: the JAX suite's trajectory yardstick (tests/test_nb_fast.py,
as tests/test_torch_generic_step.py holds the NB model) — report
``rtol=2e-4``, Adam moments ``rtol=3e-3`` with ``atol=1e-8`` (mu) /
``1e-10`` (nu), params ``rtol=3e-3, atol=2e-5``.  Adam moves a
parameter by about +-lr in the direction of its first moment; where that
moment is below 2% of its row's scale the float32 differences can turn
it, and the ``ln_kappa`` gradient is mostly the float32 cancellation of
``df / kappa`` against the Baricz midpoint: no parameter bound holds
those elements (a turn moves one by up to 2 x nboot x lr, which no route
can exceed), so they rest on the moment checks (tests/
test_torch_vmfnb_fast.py's rule).  ``GOLDEN_*``: their own ``rtol=1e-3``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.models.vmfnb import VMFNBVAE as JVAE
from mmvae_tpu.models.vmfnb import vmfnb_composite_loss as j_vmfnb_loss
from mmvae_tpu.models.vmfnb_mixture import VMFNBMixtureVAE as JMix
from mmvae_tpu.models.vmfnb_mixture import mixture_composite_loss as j_mix_loss
from mmvae_tpu.ops.vmfnb_fast import VMFNBFastStep as JFast
from mmvae_tpu.ops.vmfnb_fast import VMFNBMixtureFastStep as JMixFast
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import Trainer as JTrainer
from mmvae_tpu_torch.cli.vmfnb_vae import make_step
from mmvae_tpu_torch.models.nb import params_from_numpy
from mmvae_tpu_torch.models.vmfnb import VMFNBVAE, vmfnb_composite_loss
from mmvae_tpu_torch.models.vmfnb_mixture import (VMFNBMixtureVAE,
                                                  mixture_composite_loss)
from mmvae_tpu_torch.ops.nb_fast import batch_rand, rand_from_numpy
from mmvae_tpu_torch.train.config import TrainingOptions
from mmvae_tpu_torch.train.loop import Trainer
from tests.test_regression import GOLDEN_MIXTURE, GOLDEN_VMFNB, _superbatch
from tests.test_torch_vmfnb_generic import _jax_params, _label

D, B = 200, 12

# route -> (model, architecture, fused, fused_step, library trainer, the
# route the port's make_step logs)
ROUTES = {
    "joint --mean_encoding": ("joint", dict(mean_encoding=(8,)), True, True,
                              False, "v2 step kernels"),
    "joint --vmf_decoding": ("joint", dict(vmf_decoding=(5,)), True, True,
                             False, "v2 step kernels"),
    "joint --mean_decoding": ("joint", dict(mean_decoding=(6,)), True, True,
                              False, "forward + composite loss"),
    "joint --no_fused_step": ("joint", {}, True, False, False,
                              "forward + composite loss"),
    "joint --no_fused": ("joint", dict(mean_encoding=(8,)), False, True,
                         False, "forward + composite loss"),
    "joint library": ("joint", {}, True, True, True, None),
    "mixture --mean_encoding": ("mixture", dict(mean_encoding=(8,)), True,
                                True, False, "v2 step kernels"),
    "mixture --no_fused_step": ("mixture", {}, True, False, False,
                                "forward + composite loss"),
    "mixture library": ("mixture", {}, True, True, True, None),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(kind, arch, Dm=D, label=None):
    if kind == "joint":
        return JVAE(data_dim=Dm, **arch), VMFNBVAE(data_dim=Dm, **arch)
    return JMix(label=label, **arch), VMFNBMixtureVAE(label=label, **arch)


def _jax_trainer(kind, jmodel, topt, fused, fused_step, library):
    """The JAX CLI's generic-step choice (mmvae_tpu/cli/vmfnb_vae.py:
    252-290) without the packed step; ``library`` is the README's library
    trainer (fused_step_report / fused_step_boot with their defaults)."""
    kw = {}
    if library:
        kw = dict(report_loss_override=jmodel.fused_step_report,
                  boot_loss_override=jmodel.fused_step_boot)
    elif fused and fused_step and jmodel._can_fuse_step():
        kw = dict(
            report_loss_override=lambda p, x, c, k, b: (
                jmodel.fused_step_report(p, x, c, k, b,
                                         include_data_const=True)),
            boot_loss_override=lambda p, x, c, k, b: (
                jmodel.fused_step_boot(p, x, c, k, b, need_value=False)))
    if kind == "joint":
        loss = j_vmfnb_loss
    else:
        loss = lambda x, o, b: j_mix_loss(x, o, b, jmodel.dd)  # noqa: E731
    return JTrainer(lambda p, x, c, k, t: jmodel.forward(p, x, k, t), loss,
                    topt, **kw)


def _port_trainer(kind, model, topt, library, plain):
    if not library:
        return make_step(model, topt, plain=plain)
    widths = ((2, 1, 2) if kind == "joint" else (2, 1))
    if kind == "joint":
        loss = vmfnb_composite_loss
    else:
        loss = lambda x, o, b: mixture_composite_loss(  # noqa: E731
            x, o, b, model.dd)
    return Trainer(
        lambda p, x, c, e, t: model.forward(p, x, e, t, plain=plain), loss,
        topt, eps_widths=widths,
        report_loss_override=lambda p, x, c, e, b: model.fused_step_report(
            p, x, c, e, b, plain=plain),
        boot_loss_override=lambda p, x, c, e, b: model.fused_step_boot(
            p, x, c, e, b, plain=plain)), None


def draws(kind, key, batch=B, nboot=3):
    """JAX's ``_draw_batch`` for one batch key (through a stand-in
    ``self``, as tests/test_torch_generic_step.py does)."""
    fake = types.SimpleNamespace(rows=types.SimpleNamespace(R=2, Rn=1),
                                 opt=types.SimpleNamespace(nboot=nboot))
    cls = JFast if kind == "joint" else JMixFast
    return _np(cls._draw_batch(fake, key, batch))


def _batch(seed=5, dtype=np.int16):
    rng = np.random.default_rng(seed)
    x = rng.poisson(0.7, size=(B, D)).astype(dtype)
    x[0, :5] = 30  # a few blocks of the mixed lgamma regime
    return x, np.ones((B, 1), np.float32)


@pytest.fixture(scope="module", params=list(ROUTES))
def route(request):
    """A route's models, initial params and JAX's ``_batch_step``
    (batch seed 5, key 11)."""
    name = request.param
    kind, arch, fused, fused_step, library, _ = ROUTES[name]
    label = _label() if kind == "mixture" else None
    jmodel, model = _models(kind, arch, label=label)
    jparams = _jax_params(jmodel, seed=3)
    jtr = _jax_trainer(kind, jmodel, JOptions(nboot=3), fused, fused_step,
                       library)
    x, c = _batch()
    jstep = jax.jit(jtr._batch_step)(
        jparams, jtr.optimizer.init(jparams), jnp.asarray(x, jnp.float32),
        jnp.asarray(c), jnp.float32(1.0), jax.random.PRNGKey(11))
    return name, model, _np(jparams), _np(jstep)


def _rows(a):
    """A leaf as rows over its D-sized axis (weights are (in, out), so
    the (D, H) first layers turn over)."""
    a = np.asarray(a)
    if a.ndim <= 1:
        return a.reshape(1, -1)
    if a.ndim == 3:
        return a.reshape(-1, a.shape[-1])
    return a.T if a.shape[0] == D else a


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        lambda t: t.detach().numpy() if isinstance(t, torch.Tensor) else
        np.asarray(t), tree)))


@pytest.mark.parametrize("plain", [False, True])
def test_batch_step_matches_jax(route, plain):
    """One ``_batch_step`` (report + 3 bootstrap Adam steps) from the same
    params and JAX's draws; the port's CLI logs the JAX CLI's route."""
    name, model, jparams, (jp2, jst, jrep) = route
    kind, _, fused, fused_step, library, want_route = ROUTES[name]
    tr, logged = _port_trainer(
        kind, model, TrainingOptions(nboot=3, fused=fused,
                                     fused_step=fused_step), library, plain)
    assert isinstance(tr, Trainer)
    assert library or want_route in logged
    x, c = _batch()
    rnd = rand_from_numpy(jax.tree_util.tree_map(
        lambda a: a[None], draws(kind, jax.random.PRNGKey(11))))
    params = params_from_numpy(jparams)
    p2, st, rep = tr.batch_step(params, tr.optimizer.init(params),
                                torch.from_numpy(x), torch.from_numpy(c),
                                1.0, batch_rand(rnd, 0))
    np.testing.assert_allclose(float(rep), float(jrep), rtol=2e-4)
    for m, atol in (("mu", 1e-8), ("nu", 1e-10)):
        got, want = _leaves(st[m]), _leaves(getattr(jst[2], m))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=3e-3,
                                       atol=atol, err_msg=f"{m} {k}")
    assert int(st["count"]) == int(jst[2].count) == 3
    got, want, jmu = _leaves(p2), _leaves(jp2), _leaves(jst[2].mu)
    for k in want:
        mu = _rows(jmu[k])
        weak = np.abs(mu) < 2e-2 * np.abs(mu).max(axis=1, keepdims=True)
        if "ln_kappa" in str(k):
            weak[:] = True
        np.testing.assert_allclose(_rows(got[k])[~weak],
                                   _rows(want[k])[~weak], rtol=3e-3,
                                   atol=2e-5, err_msg=str(k))


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("kind", ["joint", "mixture"])
def test_golden_trajectory(kind, plain):
    """tests/test_regression.py's 4-epoch ``GOLDEN_VMFNB`` /
    ``GOLDEN_MIXTURE`` (D = 40, 5 batches of 24, nboot 3, seed 0; the
    JAX generic Trainer on ``forward`` + the composite loss) with the
    port's ``--no_fused`` step fed JAX's draws."""
    x_sb, c_sb = _superbatch()
    S, Bs = x_sb.shape[:2]
    label = None
    if kind == "mixture":
        rng = np.random.default_rng(7)
        label = np.zeros((40, 3), np.float32)
        label[np.arange(40), rng.integers(0, 3, 40)] = 1.0
    jmodel, model = _models(kind, {}, Dm=40, label=label)
    params = params_from_numpy(_np(jmodel.init(jax.random.PRNGKey(0))))
    tr, logged = make_step(model, TrainingOptions(nboot=3, fused=False),
                           plain=plain)
    assert "forward + composite loss" in logged
    st = tr.optimizer.init(params)
    losses = []
    for epoch in range(4):
        ekey = jax.random.fold_in(jax.random.PRNGKey(0), epoch)
        reps = []
        for b in range(S):
            rnd = rand_from_numpy(jax.tree_util.tree_map(
                lambda a: a[None], draws(kind, jax.random.fold_in(ekey, b),
                                         batch=Bs)))
            params, st, rep = tr.batch_step(
                params, st, torch.from_numpy(x_sb[b]),
                torch.from_numpy(c_sb[b]), float(epoch), batch_rand(rnd, 0))
            reps.append(float(rep))
        losses.append(float(np.mean(reps)))
    golden = GOLDEN_VMFNB if kind == "joint" else GOLDEN_MIXTURE
    np.testing.assert_allclose(losses, golden, rtol=1e-3)
