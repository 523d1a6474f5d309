"""The port's joint vMF+NB model and packed step (mmvae_tpu_torch/models/
vmfnb.py, ops/vmfnb_fast.py) against the JAX package's ``VMFNBVAE`` and
``VMFNBFastStep``: the parameter tree, the shared encoder (plain and
folded), pack / unpack, the first boot gradient, one whole batch step
and a two-epoch dense run fed the same parameters and JAX's draws.  JAX
runs its CPU XLA path, and its Pallas kernels in interpret mode where
marked.

Tolerances and why:

- init layout, pack / unpack: exact (names, order, shapes; pure data
  movement);
- the encoders: ``rtol=1e-5, atol=1e-5 * max|ref|`` (float32 sums over
  D in another order; the folded encoder moves the row norm and the
  standardization through the contraction);
- report losses ``rtol=1e-5`` for one batch (float32 reassociation),
  first-step packed gradients per row ``1e-4`` of the row's largest
  (the same float32 formulas in two libraries; the Pallas kernels use
  Stirling lgamma / digamma);
- the kappa head's gradient row also gets 8 ulp of ``df`` per count:
  it is the small difference of ``df / kappa`` and the Baricz midpoint,
  both ~ ``df / kappa`` with ``df = D / 2 - 1``, in float32 either way;
- trajectories: the JAX suite's yardstick for the joint step
  (tests/test_vmfnb_fast.py) — reports ``rtol=2e-4``, params
  ``rtol=3e-3, atol=1e-4``, Adam moments ``rtol=3e-3`` — since Adam's
  first step maps each gradient element to about +-lr by its sign;
  after one batch step, params whose first moment is below 2% of its
  row's scale, and the kappa row, whose gradient is mostly that float32
  cancellation, have no parameter bound (their direction is within
  float32 noise, and Adam's step bound holds any route): they rest on
  the moment checks; the rest are held to the yardstick.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmvae_tpu.ops.enc_kernel as jek
from mmvae_tpu.models.vmfnb import VMFNBVAE as JVAE
from mmvae_tpu.models.vmfnb import vmfnb_composite_loss
from mmvae_tpu.ops import nb_step as jns
from mmvae_tpu.ops.vmfnb_fast import VMFNBFastStep as JFast
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import Trainer
from mmvae_tpu_torch.models.nb import params_from_numpy
from mmvae_tpu_torch.models.vmfnb import VMFNBVAE
from mmvae_tpu_torch.ops.nb_fast import batch_rand, rand_from_numpy
from mmvae_tpu_torch.ops.vmfnb_fast import VMFNBFastStep
from mmvae_tpu_torch.train.config import TrainingOptions
from mmvae_tpu_torch.train.loop import DenseEpochRunner

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
    jmodel = JVAE(data_dim=D)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    # a learned standardization that is not the identity
    rng = np.random.default_rng(11)
    jparams["x_mean"] = jnp.asarray(
        rng.random((1, D)).astype(np.float32) * 0.06)
    jparams["ln_x_sd"] = jnp.asarray(
        rng.normal(size=(1, D)).astype(np.float32) * 0.5)
    jparams["mu_bias"] = jnp.asarray(
        rng.normal(size=(1, D)).astype(np.float32) * 0.2)
    jfast = JFast(jmodel, JOptions(nboot=3))
    return jfast, jparams, VMFNBVAE(data_dim=D), _np(jparams)


@pytest.mark.parametrize("hidden", [{}, {"mean_encoding": (6,)},
                                    {"mean_decoding": (5,),
                                     "vmf_decoding": (4,)}])
def test_init_layout_matches_jax(hidden):
    """Names, insertion order and shapes of the parameter tree."""
    want = JVAE(data_dim=33, **hidden).init(jax.random.PRNGKey(0))
    got = VMFNBVAE(data_dim=33, **hidden).init(
        torch.Generator().manual_seed(0))
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], dict):
            assert list(got[k]) == list(want[k])
            for leaf in want[k]:
                assert tuple(got[k][leaf].shape) == want[k][leaf].shape
        else:
            assert tuple(got[k].shape) == want[k].shape


def _counts(seed=3, dtype=np.int16, rows=B):
    rng = np.random.default_rng(seed)
    x = rng.poisson(0.7, size=(rows, D)).astype(dtype)
    x[0, :5] = 30  # a few tiles of the mixed lgamma regime
    return x


@pytest.mark.parametrize("encoder", ["shared_encode_mu", "encode_mu"])
def test_encoders_match_jax(setup, encoder):
    """The plain shared encoder and the folded one (the recorder's and
    the serving CLI's) against JAX's ``shared_encode_mu``."""
    jfast, jparams, model, pnp = setup
    x = _counts(dtype=np.float32, rows=12)
    want = jfast.model.shared_encode_mu(jparams, jnp.asarray(x))
    got = getattr(model, encoder)(params_from_numpy(pnp),
                                  torch.from_numpy(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_pack_unpack_bitwise_vs_jax(setup):
    jfast, jparams, model, pnp = setup
    fast = VMFNBFastStep(model, TrainingOptions())
    q = fast.pack(params_from_numpy(pnp))
    assert q["P"].shape == (fast.rows.K, D) == (3 * 2 + 9 + 1 + 1, D)
    _assert_tree(q, jfast.pack(jparams))
    _assert_tree(fast.unpack(q), jfast.unpack(jfast.pack(jparams)))
    _assert_tree(fast.unpack(q), jparams)


def test_draw_rand_structure_matches_jax(setup):
    """Three reparameterization draws (nb, nu, vmf) per loss."""
    jfast, _, model, _ = setup
    fast = VMFNBFastStep(model, TrainingOptions(nboot=3))
    got = fast.draw_rand(torch.Generator().manual_seed(0), 4, B)
    want = jax.eval_shape(lambda: jfast.draw_rand(jax.random.PRNGKey(0),
                                                  jnp.arange(4), B))
    assert len(got["rep_eps"]) == len(got["boot_eps"]) == 3
    flat_g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), got))
    assert [a.shape for a in flat_g] == [
        w.shape for w in jax.tree_util.tree_leaves(want)]


def _jax_rand(jfast):
    rand = jax.jit(lambda: jfast.draw_rand(jax.random.PRNGKey(7),
                                           jnp.arange(1), B))()
    return _np(jax.tree_util.tree_map(lambda a: a[0], rand))


def _interpret(monkeypatch, on):
    monkeypatch.setattr(jns, "_INTERPRET", on)
    monkeypatch.setattr(jek, "_INTERPRET", on)


ROUTES = [("kernel", False), ("plain", False), ("kernel", True)]


@pytest.mark.parametrize("route,interpret", ROUTES)
def test_first_boot_gradient_and_report_match_jax(setup, monkeypatch, route,
                                                  interpret):
    """The report loss and the packed gradient of one boot loss, before
    any update; ``interpret`` runs JAX through its Pallas kernels."""
    jfast, jparams, model, pnp = setup
    _interpret(monkeypatch, interpret)
    x = _counts(dtype=np.int8 if interpret else np.int16)
    rnd = _jax_rand(jfast)
    jq = jfast.pack(jparams)
    beta = 0.37
    jx = jnp.asarray(x)
    jrep = jfast._loss(jq, None, jx, None, None,
                       tuple(jnp.asarray(e) for e in rnd["rep_eps"]), beta,
                       include_const=True, boot=False)
    jg = jax.grad(lambda q: jfast._loss(
        q, None, jx, None, jnp.asarray(rnd["ridx"][0]),
        tuple(jnp.asarray(e[0]) for e in rnd["boot_eps"]), beta,
        include_const=False, boot=True))(jq)

    fast = VMFNBFastStep(model, TrainingOptions(nboot=3),
                         plain=route == "plain")
    q = {k: v.requires_grad_() for k, v in
         fast.pack(params_from_numpy(pnp)).items()}
    r = rand_from_numpy(rnd)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        rep = fast._loss(q, tx, None, None, r["rep_eps"], torch.tensor(beta),
                         include_const=True, boot=False)
    np.testing.assert_allclose(float(rep), float(jrep), rtol=1e-5)
    loss = fast._loss(q, tx, None, r["ridx"][0],
                      tuple(e[0] for e in r["boot_eps"]), torch.tensor(beta),
                      include_const=False, boot=True)
    gP, gsv = torch.autograd.grad(loss, (q["P"], q["sv"]))
    # the kappa head's gradient is the small difference of df / kappa and
    # the Baricz midpoint (both ~ df / kappa, df = D / 2 - 1): float32
    # keeps it to a few ulp of df per row of x, in either framework
    xb = np.abs(x[rnd["ridx"][0]].astype(np.float64))
    kappa_tol = np.zeros((fast.rows.K, D))
    kappa_tol[fast.rows.kappa_w] = 8 * 1.19e-7 * (D / 2 - 1) * xb.sum(0) / B
    for got, want, extra in ((gP, jg["P"], kappa_tol),
                             (gsv[None], jg["sv"][None], 0.0)):
        want = np.asarray(want)
        tol = 1e-4 * np.abs(want).max(axis=1, keepdims=True) + extra + 1e-12
        err = np.abs(got.numpy() - want)
        assert np.all(err <= tol), f"max err/tol {np.max(err / tol):.3g}"


@pytest.mark.parametrize("route,interpret", ROUTES)
def test_batch_step_matches_jax(setup, monkeypatch, route, interpret):
    """One reference batch step (report + 3 bootstrap Adam steps) from the
    same params and the same JAX-drawn noise."""
    jfast, jparams, model, pnp = setup
    _interpret(monkeypatch, interpret)
    x = _counts(seed=4, dtype=np.int8 if interpret else np.int16)
    c = np.ones((B, 1), np.float32)
    rnd = _jax_rand(jfast)
    jq = jfast.pack(jparams)
    jq2, jst, jrep = jfast.batch_step(
        jq, jfast.optimizer.init(jq), jnp.asarray(x), jnp.asarray(c), 1.0,
        rand=jax.tree_util.tree_map(jnp.asarray, rnd))
    fast = VMFNBFastStep(model, TrainingOptions(nboot=3),
                         plain=route == "plain")
    q = fast.pack(params_from_numpy(pnp))
    q2, st, rep = fast.batch_step(
        q, fast.optimizer.init(q), torch.from_numpy(x), torch.from_numpy(c),
        1.0, batch_rand(rand_from_numpy(jax.tree_util.tree_map(
            lambda a: a[None], rnd)), 0))
    np.testing.assert_allclose(float(rep), float(jrep), rtol=2e-4)
    _assert_tree(st["mu"], jst[2].mu, rtol=3e-3, atol=1e-8)
    _assert_tree(st["nu"], jst[2].nu, rtol=3e-3, atol=1e-10)
    assert int(st["count"]) == int(jst[2].count) == 3
    # Adam moves each parameter by about +-lr in the direction of its
    # first moment; where that moment is below 2% of its row's scale the
    # float32 differences above can turn it.  No parameter bound holds
    # those elements (a turn moves one by up to 2 x nboot x lr, which no
    # route can exceed): they rest on the moment checks above, and the
    # rest are held to the trajectory yardstick
    for k in ("P", "sv"):
        jmu = np.asarray(jst[2].mu[k]).reshape(-1, D if k == "P" else 1)
        if k == "sv":
            jmu = jmu.T
        weak = np.abs(jmu) < 2e-2 * np.abs(jmu).max(axis=1, keepdims=True)
        if k == "P":  # the kappa row: see the first-boot gradient test
            weak[fast.rows.kappa_w] = True
        got = q2[k].numpy().reshape(jmu.shape)
        want = np.asarray(jq2[k]).reshape(jmu.shape)
        np.testing.assert_allclose(got[~weak], want[~weak], rtol=3e-3,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("N,Bt", [(48, 16), (40, 16)])  # wrap-free / wrap
def test_dense_runner_two_epochs_matches_jax(N, Bt):
    """Two epochs of the dense-resident runner against the JAX trainer's
    on-device epoch with the joint packed step, fed the JAX draws (the
    JAX trainer applies no feature clustering on this entry point)."""
    Dr = 200
    rng = np.random.default_rng(4)
    x = rng.poisson(0.9, size=(N, Dr)).astype(np.int16)
    x[:, :3] += 12  # mixed-regime tiles
    jmodel = JVAE(data_dim=Dr)
    topt = JOptions(nboot=3, seed=5)
    jfast = JFast(jmodel, topt)
    trainer = Trainer(
        lambda p, xx, c, k, t: jmodel.forward(p, xx, k, t),
        lambda xx, o, b: vmfnb_composite_loss(xx, o, b), topt,
        report_loss_override=lambda p, xx, c, k, b: jmodel.fused_step_report(
            p, xx, c, k, b, include_data_const=True),
        boot_loss_override=lambda p, xx, c, k, b: jmodel.fused_step_boot(
            p, xx, c, k, b, need_value=False), fast_step=jfast)
    run = trainer.make_ondevice_epoch(types.SimpleNamespace(D=Dr), None, N,
                                      Bt, data_dense=jnp.asarray(x))
    jparams = jmodel.init(jax.random.PRNGKey(2))
    pnp = _np(jparams)
    jstate = trainer.optimizer.init(jparams)

    fast = VMFNBFastStep(VMFNBVAE(data_dim=Dr),
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


@pytest.mark.parametrize("kw", [{"mean_encoding": (8,)},
                                {"mean_decoding": (8,)},
                                {"vmf_decoding": (8,)}, {"nu_max": 100.0}])
def test_unsupported_architectures_raise(kw):
    with pytest.raises(NotImplementedError, match="generic step"):
        VMFNBFastStep(VMFNBVAE(data_dim=D, **kw), TrainingOptions())
