"""The port's packed vMF-VAE step (mmvae_tpu_torch/ops/vmf_fast.py) and
its generic step (train.loop.Trainer with ``forward`` + ``vmf_loss``)
against the JAX package's ``VMFFastStep`` and ``Trainer``: pack /
unpack, the small vector's bare ``ln_kappa``, the report and the first
boot gradient, one batch step and a two-epoch dense run fed the same
parameters and JAX's draws; the packed step against the generic one;
storage invariance; the architecture gate; and tests/test_regression.py's
``GOLDEN_VMF`` on the generic step with JAX's key chain.  No kernel of
the port lies on this path; JAX runs its CPU XLA path.

Tolerances and why:

- pack / unpack, the small vector, storage invariance: exact (data
  movement; int8, int16 and float32 counts widen to the same float32);
- report losses ``rtol=1e-5`` for one batch (float32 reassociation);
  first-step packed gradients per row ``1e-4`` of the row's largest (the
  same float32 formulas in two libraries); the ``ln_kappa`` element also
  8 ulp of ``df``: it is the small difference of ``df / kappa`` and the
  Baricz midpoint (both ~ ``df / kappa``, ``df = D / 2 - 1``), in float32
  either way (the rule of tests/test_torch_vmfnb_fast.py); the gradient
  tests run at ``kappa_min`` 0.5, where that element is not 0 (a clamp
  tie);
- trajectories, the packed step against the generic one, and one batch
  step against JAX: the JAX suite's yardstick for this step
  (tests/test_vmf_fast.py) — reports ``rtol=2e-4``, params ``rtol=3e-3,
  atol=1e-4``, Adam moments ``rtol=3e-3`` (``atol`` 1e-8 for mu, 1e-10
  for nu);
- ``GOLDEN_VMF``: its own ``rtol=1e-3``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.models.vmf import VMFVAE as JVAE
from mmvae_tpu.ops.losses import vmf_loss as jvmf_loss
from mmvae_tpu.ops.vmf_fast import VMFFastStep as JFast
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import Trainer as JTrainer
from mmvae_tpu_torch.cli.vmf_vae import make_step
from mmvae_tpu_torch.models.nb import params_from_numpy
from mmvae_tpu_torch.models.vmf import VMFVAE
from mmvae_tpu_torch.ops.nb_fast import batch_rand, rand_from_numpy
from mmvae_tpu_torch.ops.vmf_fast import VMFFastStep
from mmvae_tpu_torch.train.config import TrainingOptions
from mmvae_tpu_torch.train.loop import DenseEpochRunner, Trainer
from tests.test_regression import GOLDEN_VMF, _superbatch

D, B = 640, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _assert_tree(got, want, **tol):
    flat_w = _leaves(_np(want))
    flat_g = _leaves(jax.tree_util.tree_map(lambda t: t.detach().numpy(),
                                            got))
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        if tol:
            np.testing.assert_allclose(flat_g[k], w, err_msg=str(k), **tol)
        else:
            np.testing.assert_array_equal(flat_g[k], w, err_msg=str(k))


@pytest.fixture(scope="module")
def setup():
    """JAX step and params (a learned standardization that is not the
    identity, kappa_min 0.5), the port's model, the params as numpy."""
    jmodel = JVAE(data_dim=D, covar_dim=1, kappa_min=0.5)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(11)
    jparams["x_mean"] = jnp.asarray(
        rng.random((1, D)).astype(np.float32) * 0.06)
    jparams["ln_x_sd"] = jnp.asarray(
        rng.normal(size=(1, D)).astype(np.float32) * 0.5)
    jfast = JFast(jmodel, JOptions(nboot=3))
    return jfast, jparams, VMFVAE(data_dim=D, covar_dim=1, kappa_min=0.5), \
        _np(jparams)


def _counts(seed=3, dtype=np.int16, rows=B):
    rng = np.random.default_rng(seed)
    x = rng.poisson(0.7, size=(rows, D)).astype(dtype)
    x[0, :5] = 30
    return x


def _jax_rand(jfast, key=7):
    return _np(jfast._draw_batch(jax.random.PRNGKey(key), B))


def test_pack_unpack_bitwise_vs_jax(setup):
    jfast, jparams, model, pnp = setup
    fast = VMFFastStep(model, TrainingOptions())
    q = fast.pack(params_from_numpy(pnp))
    assert q["P"].shape == (fast.rows.K, D) == (2 * 2 + 1 + 4, D)
    _assert_tree(q, jfast.pack(jparams))
    _assert_tree(fast.unpack(q), jfast.unpack(jfast.pack(jparams)))
    _assert_tree(fast.unpack(q), jparams)


def test_small_vector_bare_ln_kappa(setup):
    """The small vector ends in the bare ``ln_kappa`` (no layer name):
    packed from, and unpacked to, the top-level (1,) tensor; the Adam
    state's moment trees go through the same layout."""
    _, _, model, pnp = setup
    fast = VMFFastStep(model, TrainingOptions())
    params = params_from_numpy(pnp)
    off, shape = fast._sv_segs["ln_kappa"]
    assert shape == (1,) and off + 1 == fast._sv_len
    q = fast.pack(params)
    assert float(q["sv"][-1]) == float(params["ln_kappa"][0])
    back = fast.unpack(q)
    assert tuple(back["ln_kappa"].shape) == (1,)
    assert "ln_kappa" not in back.get("", {})
    st = fast.unpack_opt_state(fast.optimizer.init(q))
    assert tuple(st["mu"]["ln_kappa"].shape) == (1,)
    assert list(st["nu"]) == list(back)


def test_first_boot_gradient_and_report_match_jax(setup):
    """The report loss and the packed gradient of one boot loss, before
    any update, from JAX's draws; the views are made once, as in JAX."""
    jfast, jparams, model, pnp = setup
    x = _counts()
    c = np.ones((B, 1), np.float32)
    rnd = _jax_rand(jfast)
    jq = jfast.pack(jparams)
    beta = 0.37
    jx, jc = jnp.asarray(x), jnp.asarray(c)
    jviews = jfast._views(jx)
    jrep = jfast._loss(jq, jviews, jx, jc, None,
                       tuple(jnp.asarray(e) for e in rnd["rep_eps"]), beta,
                       include_const=True, boot=False)
    jg = jax.grad(lambda q: jfast._loss(
        q, jviews, jx, jc, jnp.asarray(rnd["ridx"][0]),
        tuple(jnp.asarray(e[0]) for e in rnd["boot_eps"]), beta,
        include_const=False, boot=True))(jq)

    fast = VMFFastStep(model, TrainingOptions(nboot=3))
    q = {k: v.requires_grad_() for k, v in
         fast.pack(params_from_numpy(pnp)).items()}
    r = rand_from_numpy(rnd)
    views = fast._views(torch.from_numpy(x))
    for got, want in zip(views, jviews):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)
    tc = torch.from_numpy(c)
    with torch.no_grad():
        rep = fast._loss(q, views, tc, None, r["rep_eps"],
                         torch.tensor(beta), include_const=True, boot=False)
    np.testing.assert_allclose(float(rep), float(jrep), rtol=1e-5)
    loss = fast._loss(q, views, tc, r["ridx"][0],
                      tuple(e[0] for e in r["boot_eps"]), torch.tensor(beta),
                      include_const=False, boot=True)
    gP, gsv = torch.autograd.grad(loss, (q["P"], q["sv"]))
    df = D / 2 - 1
    sv_tol = np.zeros(fast._sv_len)
    sv_tol[fast._sv_segs["ln_kappa"][0]] = 8 * 1.19e-7 * df
    assert float(np.asarray(jg["sv"])[-1]) != 0.0  # kappa_min 0.5: a tie
    for got, want, extra in ((gP, jg["P"], 0.0),
                             (gsv[None], jg["sv"][None], sv_tol)):
        want = np.asarray(want)
        tol = 1e-4 * np.abs(want).max(axis=1, keepdims=True) + extra + 1e-12
        err = np.abs(got.numpy() - want)
        assert np.all(err <= tol), f"max err/tol {np.max(err / tol):.3g}"


def test_batch_step_matches_jax(setup):
    """One reference batch step (report + 3 bootstrap Adam steps) from the
    same params and the same JAX-drawn noise."""
    jfast, jparams, model, pnp = setup
    x = _counts(seed=4)
    c = np.ones((B, 1), np.float32)
    rnd = _jax_rand(jfast, key=11)
    jq = jfast.pack(jparams)
    jq2, jst, jrep = jfast.batch_step(
        jq, jfast.optimizer.init(jq), jnp.asarray(x), jnp.asarray(c), 1.0,
        rand=jax.tree_util.tree_map(jnp.asarray, rnd))
    fast = VMFFastStep(model, TrainingOptions(nboot=3))
    q = fast.pack(params_from_numpy(pnp))
    q2, st, rep = fast.batch_step(
        q, fast.optimizer.init(q), torch.from_numpy(x), torch.from_numpy(c),
        1.0, batch_rand(rand_from_numpy(jax.tree_util.tree_map(
            lambda a: a[None], rnd)), 0))
    np.testing.assert_allclose(float(rep), float(jrep), rtol=2e-4)
    _assert_tree(q2, jq2, rtol=3e-3, atol=1e-4)
    _assert_tree(st["mu"], jst[2].mu, rtol=3e-3, atol=1e-8)
    _assert_tree(st["nu"], jst[2].nu, rtol=3e-3, atol=1e-10)
    assert int(st["count"]) == int(jst[2].count) == 3


@pytest.mark.parametrize("N,Bt", [(48, 16), (40, 16)])  # wrap-free / wrap
def test_dense_runner_two_epochs_matches_jax(N, Bt):
    """Two epochs of the dense-resident runner against the JAX trainer's
    on-device epoch with the packed vMF step, fed the JAX draws."""
    Dr = 200
    rng = np.random.default_rng(4)
    x = rng.poisson(0.9, size=(N, Dr)).astype(np.int16)
    x[:, :3] += 12
    jmodel = JVAE(data_dim=Dr, covar_dim=1)
    topt = JOptions(nboot=3, seed=5)
    jfast = JFast(jmodel, topt)
    trainer = JTrainer(lambda p, xx, c, k, t: jmodel.forward(p, xx, c, k, t),
                       lambda xx, o, b: jvmf_loss(xx, o, b), topt,
                       fast_step=jfast)
    run = trainer.make_ondevice_epoch(types.SimpleNamespace(D=Dr), None, N,
                                      Bt, data_dense=jnp.asarray(x))
    jparams = jmodel.init(jax.random.PRNGKey(2))
    pnp = _np(jparams)
    jstate = trainer.optimizer.init(jparams)

    fast = VMFFastStep(VMFVAE(data_dim=Dr, covar_dim=1),
                       TrainingOptions(nboot=3, seed=5))
    runner = DenseEpochRunner(fast, torch.from_numpy(x), Bt, seed=5)
    q = fast.pack(params_from_numpy(pnp))
    st = fast.optimizer.init(q)
    nbatch = -(-N // Bt)
    for epoch in range(2):
        jparams, jstate, jrep = run(jparams, jstate, epoch)
        rand = jax.jit(lambda: jfast.draw_rand(
            jax.random.fold_in(jax.random.PRNGKey(5), jnp.int32(epoch)),
            jnp.arange(nbatch, dtype=jnp.int32), Bt))()
        q, st, reps, _ = runner(q, st, epoch, rand=rand_from_numpy(_np(rand)))
        np.testing.assert_allclose(reps.numpy(), np.asarray(jrep), rtol=2e-4)
    _assert_tree(fast.unpack(q), jparams, rtol=3e-3, atol=1e-4)
    assert int(st["count"]) == int(jstate[2].count) == 2 * nbatch * 3


def _trajectory(step, model, x, seed=0):
    """Two epochs of the dense runner over ``x`` from the port's init."""
    runner = DenseEpochRunner(step, torch.from_numpy(x), B, seed=seed)
    q = step.pack(model.init(torch.Generator().manual_seed(0)))
    st = step.optimizer.init(q)
    reps = []
    for epoch in range(2):
        q, st, rep, _ = runner(q, st, epoch)
        reps.append(rep.numpy())
    return step.unpack(q), st, np.concatenate(reps)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("do_relu", [False, True])
def test_packed_step_matches_generic_step(dtype, do_relu):
    """The packed step against the generic ``Trainer`` (the route
    ``--no_fused_step`` takes) over two epochs with the same draws: the
    JAX suite's contract (tests/test_vmf_fast.py:47-80)."""
    model = VMFVAE(data_dim=D, covar_dim=1, do_relu=do_relu)
    x = _counts(dtype=dtype, rows=2 * B)
    packed, route = make_step(model, TrainingOptions(nboot=3))
    assert isinstance(packed, VMFFastStep) and "VMFFastStep" in route
    generic, route = make_step(model, TrainingOptions(nboot=3,
                                                      fused_step=False))
    assert isinstance(generic, Trainer) and "vmf_loss" in route
    p1, s1, r1 = _trajectory(packed, model, x)
    p2, s2, r2 = _trajectory(generic, model, x)
    np.testing.assert_allclose(r1, r2, rtol=2e-4)
    _assert_tree(p1, _np(jax.tree_util.tree_map(lambda t: t.numpy(), p2)),
                 rtol=3e-3, atol=1e-4)
    assert int(s1["count"]) == int(s2["count"]) == 2 * 2 * 3


def test_storage_invariance_and_repeatability():
    """int8 == int16 == float32 storage of the same counts, and two runs,
    bitwise (reports and parameters of one packed batch step)."""
    model = VMFVAE(data_dim=D, covar_dim=1)
    x = _counts(rows=2 * B)
    outs = []
    for dt in (np.int8, np.int16, np.float32, np.int16):
        step = VMFFastStep(model, TrainingOptions(nboot=2))
        runner = DenseEpochRunner(step, torch.from_numpy(x.astype(dt)), B)
        q = step.pack(model.init(torch.Generator().manual_seed(0)))
        q, _, reps, _ = runner(q, step.optimizer.init(q), 0)
        outs.append((reps.numpy(), q["P"].numpy(), q["sv"].numpy()))
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            np.testing.assert_array_equal(a, b)


def test_supports_and_unsupported():
    assert VMFFastStep.supports(VMFVAE(data_dim=64, covar_dim=1))
    for kw in ({"encoding": (16,)}, {"decoding": (16,)}):
        model = VMFVAE(data_dim=64, covar_dim=1, **kw)
        assert not VMFFastStep.supports(model)
        assert not JFast.supports(JVAE(data_dim=64, covar_dim=1, **kw))
        with pytest.raises(NotImplementedError, match="generic step"):
            VMFFastStep(model, TrainingOptions())
        step, route = make_step(model, TrainingOptions())
        assert isinstance(step, Trainer) and "generic step" in route
    assert "generic step" in VMFFastStep.UNSUPPORTED
    from mmvae_tpu_torch.models.nb import NBVAE

    assert not VMFFastStep.supports(NBVAE(data_dim=64))


def test_golden_trajectory():
    """tests/test_regression.py's 4-epoch ``GOLDEN_VMF`` (D = 40, 5
    batches of 24, nboot 3, seed 0) with the port's generic ``Trainer``
    fed the draws of JAX's key chain (``_draw_batch``, documented there
    as bitwise the generic step's)."""
    x_sb, c_sb = _superbatch()
    S, Bs = x_sb.shape[:2]
    params = params_from_numpy(_np(JVAE(data_dim=40, covar_dim=1).init(
        jax.random.PRNGKey(0))))
    tr, route = make_step(VMFVAE(data_dim=40, covar_dim=1),
                          TrainingOptions(nboot=3, fused=False))
    assert isinstance(tr, Trainer), route
    fake = types.SimpleNamespace(rows=types.SimpleNamespace(Z=2),
                                 opt=types.SimpleNamespace(nboot=3))
    st = tr.optimizer.init(params)
    losses = []
    for epoch in range(4):
        ekey = jax.random.fold_in(jax.random.PRNGKey(0), epoch)
        reps = []
        for b in range(S):
            rnd = rand_from_numpy(jax.tree_util.tree_map(
                lambda a: np.asarray(a)[None], JFast._draw_batch(
                    fake, jax.random.fold_in(ekey, b), Bs)))
            params, st, rep = tr.batch_step(
                params, st, torch.from_numpy(x_sb[b]),
                torch.from_numpy(c_sb[b]), float(epoch), batch_rand(rnd, 0))
            reps.append(float(rep))
        losses.append(float(np.mean(reps)))
    np.testing.assert_allclose(losses, GOLDEN_VMF, rtol=1e-3)
