"""The port's labeled mixture model and packed step (mmvae_tpu_torch/
models/vmfnb_mixture.py, ops/vmfnb_fast.py ``VMFNBMixtureFastStep``)
against the JAX package's: the parameter tree, pack / unpack, the first
boot gradient, the report, one whole batch step and a two-epoch dense run
fed the same parameters and JAX's draws; and the eval-mode vMF mixture
and NB encoder, plain and folded, with JAX's Gumbel uniforms.  JAX runs
its CPU XLA path, and its Pallas kernels in interpret mode where marked.
The label is a marker-style mask with about a quarter of the features
uncovered (JAX's ``tests/test_vmfnb_fast.py::_mk_label``), at D = 640
and a ragged D = 1,003.

Tolerances and why (those of ``tests/test_torch_vmfnb_fast.py``):

- init layout, pack / unpack: exact (names, order, shapes; pure data
  movement);
- report losses ``rtol=1e-5`` for one batch (float32 reassociation),
  first-step packed gradients per row ``1e-4`` of the row's largest,
  plus, on the kappa row, 8 ulp of ``df = dd / 2 - 1`` per count (the
  float32 difference of ``df / kappa`` and the Baricz midpoint);
- trajectories: reports ``rtol=2e-4``, Adam moments ``rtol=3e-3``,
  params ``rtol=3e-3, atol=1e-4`` except where the first moment is below
  2% of its row's scale, and the kappa row (float32 noise decides their
  direction; they rest on the moment checks);
- eval-mode encoder: the hard assignment must agree on every row whose
  top two of ``logits + g`` are more than 1e-4 apart, and at most one
  row may be that close; there, and for the log-variance everywhere,
  ``rtol=1e-5, atol=1e-5 * max|ref|`` (float32 sums over D in another
  order; the folded encoder moves the row norms through the
  contraction); the assignment's value ``(hard - y) + y`` ``atol=1e-6``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmvae_tpu.ops.enc_kernel as jek
from mmvae_tpu.models.vmfnb_mixture import VMFNBMixtureVAE as JVAE
from mmvae_tpu.models.vmfnb_mixture import mixture_composite_loss
from mmvae_tpu.ops import nb_step as jns
from mmvae_tpu.ops.vmfnb_fast import VMFNBMixtureFastStep as JFast
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import Trainer
from mmvae_tpu_torch.models.nb import params_from_numpy
from mmvae_tpu_torch.models.vmfnb_mixture import VMFNBMixtureVAE
from mmvae_tpu_torch.ops.nb_fast import batch_rand, rand_from_numpy
from mmvae_tpu_torch.ops.vmfnb_fast import VMFNBMixtureFastStep
from mmvae_tpu_torch.train.config import TrainingOptions
from mmvae_tpu_torch.train.loop import DenseEpochRunner

D, B, K = 640, 8, 5


def _mk_label(D=D, K=K, seed=11):
    """JAX's test label: each feature in each component with p = 0.25,
    component k holds feature k (every component non-empty)."""
    rng = np.random.default_rng(seed)
    L = (rng.random((D, K)) < 0.25).astype(np.float32)
    L[:K] = np.eye(K, dtype=np.float32)
    return L


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


def _jax_params(jmodel, seed=1):
    """Init plus a learned standardization that is not the identity and
    component directions that are not uniform."""
    Dm = jmodel.data_dim
    p = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 10)
    p["x_mean"] = jnp.asarray(rng.random((1, Dm)).astype(np.float32) * 0.06)
    p["ln_x_sd"] = jnp.asarray(
        rng.normal(size=(1, Dm)).astype(np.float32) * 0.5)
    p["mu_bias"] = jnp.asarray(
        rng.normal(size=(1, Dm)).astype(np.float32) * 0.2)
    p["ln_vmf_mu"] = jnp.asarray(
        rng.normal(size=p["ln_vmf_mu"].shape).astype(np.float32))
    return p


@pytest.fixture(scope="module")
def setup():
    label = _mk_label()
    assert 0.1 < 1 - label.any(axis=1).mean() < 0.4  # uncovered features
    jmodel = JVAE(label=label)
    jparams = _jax_params(jmodel)
    jfast = JFast(jmodel, JOptions(nboot=3))
    return jfast, jparams, VMFNBMixtureVAE(label=label), _np(jparams)


@pytest.mark.parametrize("hidden", [{}, {"mean_encoding": (6,)},
                                    {"mean_decoding": (5,)}])
def test_init_layout_matches_jax(hidden):
    """Names, insertion order and shapes of the parameter tree."""
    label = _mk_label(D=33, K=4)
    want = JVAE(label=label, **hidden).init(jax.random.PRNGKey(0))
    got = VMFNBMixtureVAE(label=label, **hidden).init(
        torch.Generator().manual_seed(0))
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], dict):
            assert list(got[k]) == list(want[k])
            for leaf in want[k]:
                assert tuple(got[k][leaf].shape) == want[k][leaf].shape
        else:
            assert tuple(got[k].shape) == want[k].shape


def test_filter_and_dd_match_jax(setup):
    jfast, _, model, _ = setup
    np.testing.assert_array_equal(model._filter(), jfast.model._filter())
    assert model.dd == jfast.model.dd
    assert model.kappa_max == jfast.model.kappa_max == 100.0
    label, filt = model.masks("cpu")
    assert label.shape == (K, D) and filt.shape == (D,)
    assert model._can_fuse_step() == jfast.model._can_fuse_step()


def _counts(seed=3, dtype=np.int16, rows=B, Dm=D):
    rng = np.random.default_rng(seed)
    x = rng.poisson(0.7, size=(rows, Dm)).astype(dtype)
    x[0, :5] = 30  # a few tiles of the mixed lgamma regime
    return x


def test_pack_unpack_bitwise_vs_jax(setup):
    jfast, jparams, model, pnp = setup
    fast = VMFNBMixtureFastStep(model, TrainingOptions())
    q = fast.pack(params_from_numpy(pnp))
    assert q["P"].shape == (fast.rows.Krows, D) == (2 * 2 + 8 + 1 + 1 + K, D)
    _assert_tree(q, jfast.pack(jparams))
    _assert_tree(fast.unpack(q), jfast.unpack(jfast.pack(jparams)))
    _assert_tree(fast.unpack(q), jparams)
    # Adam moments carry over in the same layout
    st = fast.pack_opt_state({"count": torch.tensor(0, dtype=torch.int32),
                              "mu": params_from_numpy(pnp),
                              "nu": params_from_numpy(pnp)})
    _assert_tree(st["mu"], jfast.pack(jparams))


def test_draw_rand_structure_matches_jax(setup):
    """Two reparameterization draws (mu, nu) per loss."""
    jfast, _, model, _ = setup
    fast = VMFNBMixtureFastStep(model, TrainingOptions(nboot=3))
    got = fast.draw_rand(torch.Generator().manual_seed(0), 4, B)
    want = jax.eval_shape(lambda: jfast.draw_rand(jax.random.PRNGKey(0),
                                                  jnp.arange(4), B))
    assert len(got["rep_eps"]) == len(got["boot_eps"]) == 2
    flat_g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), got))
    assert [a.shape for a in flat_g] == [
        w.shape for w in jax.tree_util.tree_leaves(want)]


def _jax_rand(jfast, Bt=B):
    rand = jax.jit(lambda: jfast.draw_rand(jax.random.PRNGKey(7),
                                           jnp.arange(1), Bt))()
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

    fast = VMFNBMixtureFastStep(model, TrainingOptions(nboot=3),
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
    xb = np.abs(x[rnd["ridx"][0]].astype(np.float64))
    kappa_tol = np.zeros((fast.rows.Krows, D))
    kappa_tol[fast.rows.kappa_w] = (8 * 1.19e-7 * (model.dd / 2 - 1)
                                    * xb.sum(0) / B)
    for got, want, extra in ((gP, jg["P"], kappa_tol),
                             (gsv[None], jg["sv"][None], 0.0)):
        want = np.asarray(want)
        tol = 1e-4 * np.abs(want).max(axis=1, keepdims=True) + extra + 1e-12
        err = np.abs(got.numpy() - want)
        assert np.all(err <= tol), f"max err/tol {np.max(err / tol):.3g}"


def _assert_step(q2, st, jq2, jst, rows):
    _assert_tree(st["mu"], jst[2].mu, rtol=3e-3, atol=1e-8)
    _assert_tree(st["nu"], jst[2].nu, rtol=3e-3, atol=1e-10)
    for k in ("P", "sv"):
        jmu = np.asarray(jst[2].mu[k]).reshape(-1, D if k == "P" else 1)
        if k == "sv":
            jmu = jmu.T
        weak = np.abs(jmu) < 2e-2 * np.abs(jmu).max(axis=1, keepdims=True)
        if k == "P":  # the kappa row: see the first-boot gradient test
            weak[rows.kappa_w] = True
        got = q2[k].numpy().reshape(jmu.shape)
        want = np.asarray(jq2[k]).reshape(jmu.shape)
        np.testing.assert_allclose(got[~weak], want[~weak], rtol=3e-3,
                                   atol=1e-4, err_msg=k)


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
    fast = VMFNBMixtureFastStep(model, TrainingOptions(nboot=3),
                                plain=route == "plain")
    q = fast.pack(params_from_numpy(pnp))
    q2, st, rep = fast.batch_step(
        q, fast.optimizer.init(q), torch.from_numpy(x), torch.from_numpy(c),
        1.0, batch_rand(rand_from_numpy(jax.tree_util.tree_map(
            lambda a: a[None], rnd)), 0))
    np.testing.assert_allclose(float(rep), float(jrep), rtol=2e-4)
    assert int(st["count"]) == int(jst[2].count) == 3
    _assert_step(q2, st, jq2, jst, fast.rows)


@pytest.mark.parametrize("N,Bt", [(48, 16), (40, 16)])  # wrap-free / wrap
def test_dense_runner_two_epochs_matches_jax(N, Bt):
    """Two epochs of the dense-resident runner against the JAX trainer's
    on-device epoch with the mixture's packed step, fed the JAX draws, at
    a ragged D with uncovered features."""
    Dr, Kr = 203, 4
    rng = np.random.default_rng(4)
    x = rng.poisson(0.9, size=(N, Dr)).astype(np.int16)
    x[:, :3] += 12  # mixed-regime tiles
    label = _mk_label(D=Dr, K=Kr, seed=2)
    jmodel = JVAE(label=label)
    topt = JOptions(nboot=3, seed=5)
    jfast = JFast(jmodel, topt)
    trainer = Trainer(
        lambda p, xx, c, k, t: jmodel.forward(p, xx, k, t),
        lambda xx, o, b: mixture_composite_loss(xx, o, b, jmodel.dd), topt,
        report_loss_override=lambda p, xx, c, k, b: jmodel.fused_step_report(
            p, xx, c, k, b, include_data_const=True),
        boot_loss_override=lambda p, xx, c, k, b: jmodel.fused_step_boot(
            p, xx, c, k, b, need_value=False), fast_step=jfast)
    run = trainer.make_ondevice_epoch(types.SimpleNamespace(D=Dr), None, N,
                                      Bt, data_dense=jnp.asarray(x))
    jparams = _jax_params(jmodel, seed=2)
    pnp = _np(jparams)
    jstate = trainer.optimizer.init(jparams)

    fast = VMFNBMixtureFastStep(VMFNBMixtureVAE(label=label),
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
                                {"mean_decoding": (8,)}, {"nu_max": 100.0}])
def test_unsupported_architectures_raise(kw):
    with pytest.raises(NotImplementedError, match="generic step"):
        VMFNBMixtureFastStep(VMFNBMixtureVAE(label=_mk_label(), **kw),
                             TrainingOptions())


# ----------------------------------------------------------------------
# eval mode: the hard Gumbel assignment and the NB encoder
# ----------------------------------------------------------------------

def _margin(logits, u):
    """Top-two gap of logits + g per row (float64)."""
    g = -np.log(-np.log(u.astype(np.float64)))
    z = np.sort(np.asarray(logits, np.float64) + g, axis=1)
    return z[:, -1] - z[:, -2]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.fixture(scope="module", params=[640, 1003])
def eval_case(request):
    """JAX's eval-mode vMF mixture and NB encoder on 24 rows (three
    8-row batches under one key), with the uniforms JAX draws from that
    key, and the port's model."""
    Dm = request.param
    label = _mk_label(D=Dm, K=K, seed=Dm)
    jmodel = JVAE(label=label)
    jparams = _jax_params(jmodel, seed=3)
    x = _counts(seed=9, dtype=np.float32, rows=3 * B, Dm=Dm)
    key = jax.random.PRNGKey(42)
    u = np.array(jax.random.uniform(key, (B, K), minval=1e-20, maxval=1.0))
    outs = []
    for b in range(3):  # JAX: every batch under the same key
        xb = jnp.asarray(x[b * B:(b + 1) * B])
        vmf = jmodel.vmf_forward(jparams, xb, key, False)
        mean, lnvar = jmodel.nb_encode_mu(jparams, xb, vmf.latent)
        outs.append(_np((vmf, mean, lnvar)))
    want = jax.tree_util.tree_map(lambda *a: np.concatenate(a), *outs)
    vmf_mu = outs[0][0].mu  # (D, K): the same for every batch
    return (VMFNBMixtureVAE(label=label), params_from_numpy(_np(jparams)),
            x, u, want, vmf_mu)


def _check_eval(got_latent, got_mean, got_lnvar, want, u):
    vmf, mean, lnvar = want
    margin = _margin(vmf.logits, np.tile(u, (3, 1)))
    sure = margin > 1e-4
    assert (~sure).sum() <= 1, f"{(~sure).sum()} near-tie rows"
    got_latent = np.asarray(got_latent)
    np.testing.assert_array_equal(got_latent[sure].argmax(1),
                                  vmf.latent[sure].argmax(1))
    np.testing.assert_allclose(got_latent[sure], vmf.latent[sure], atol=1e-6)
    _close(np.asarray(got_mean)[sure], mean[sure])
    _close(got_lnvar, lnvar)
    return sure


def test_vmf_forward_eval_matches_jax(eval_case):
    """The plain unfolded spec: ``vmf_forward(training=False)`` with
    JAX's uniforms tiled over three batches, then ``nb_encode_mu``."""
    model, params, x, u, want, vmf_mu = eval_case
    vmf = model.vmf_forward(params, torch.from_numpy(x), False,
                            gumbel_u=torch.from_numpy(u))
    _close(vmf.logits, want[0].logits)
    _close(vmf.kappa, want[0].kappa)
    _close(vmf.mu, vmf_mu)
    mean, lnvar = model.nb_encode_mu(params, torch.from_numpy(x), vmf.latent)
    sure = _check_eval(vmf.latent, mean, lnvar, want, u)
    _close(vmf.recon.numpy()[sure], want[0].recon[sure])
    # training mode: the soft E-step
    soft = model.vmf_forward(params, torch.from_numpy(x), True)
    _close(soft.latent, np.exp(want[0].logits))


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_folded_encoder_matches_jax(eval_case, dtype):
    """``encode_prepared``: one count-encoder call with the filter, on
    24 rows at once (the noise tiled), against JAX's unfolded spec."""
    model, params, x, u, want, _ = eval_case
    prep = model.prepare_encoder(params, torch.from_numpy(u))
    mean, lnvar, latent = model.encode_prepared(
        params, prep, torch.from_numpy(x.astype(dtype)))
    _check_eval(latent, mean, lnvar, want, u)


def test_gumbel_uniforms_and_record_encoder(setup):
    """The CLI's noise: seeded, in (0, 1), one (B, K) matrix; the
    recorder's encode returns the assignments as its third output."""
    _, _, model, pnp = setup
    u = model.gumbel_uniforms(B, 3)
    assert u.shape == (B, K) and bool((u > 0).all() and (u < 1).all())
    assert torch.equal(u, model.gumbel_uniforms(B, 3))
    assert not torch.equal(u, model.gumbel_uniforms(B, 4))
    fn, extra = model.record_encoder(3, B)
    assert extra == "clust"
    params = params_from_numpy(pnp)
    x = torch.from_numpy(_counts(seed=5))
    mean, lnvar, clust = fn(params, x)
    want = model.encode_mu(params, x, u)
    for g, w in zip((mean, lnvar, clust), want):
        assert torch.equal(g, w)
    assert clust.shape == (B, K)
    np.testing.assert_allclose(clust.sum(1).numpy(), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="cannot serve"):
        model.encode_mu(params, x[:5], u)
