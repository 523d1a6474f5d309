"""The port's packed fast step (mmvae_tpu_torch/ops/nb_fast.py) against
the JAX package's ``NBFastStep``: pack / unpack, the packed optimizer,
and one whole batch step fed the same parameters and the same noise
(drawn by JAX's ``draw_rand``).

Tolerances:

- pack / unpack: bitwise (pure data movement);
- the optimizer against optax: ``rtol=1e-6`` and an ``atol`` of about
  1e-6 of each leaf's scale (the same float32 operations, but the clip
  divides by a global norm the two frameworks sum in different orders,
  and ``g + wd * p`` cancels to tiny values in a few elements);
- a batch step: the JAX suite's trajectory yardstick
  (tests/test_nb_fast.py) — report ``rtol=2e-4``, params
  ``rtol=3e-3, atol=2e-5``, Adam moments ``rtol=3e-3, atol=1e-8``.
  Adam's first step maps each gradient element to about +-lr by its
  sign, so the parameters are compared only after the first step's
  gradients were compared directly (``test_first_boot_gradient``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.models.nb import NBVAE as JNBVAE
from mmvae_tpu.ops import nb_step as jns
from mmvae_tpu.ops.nb_fast import NBFastStep as JFast
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu_torch.models.nb import (NBVAE, adam_from_numpy, adam_to_numpy,
                                       params_from_numpy, params_to_numpy)
from mmvae_tpu_torch.ops.nb_fast import (NBFastStep, PackedAdam, batch_rand,
                                         rand_from_numpy)
from mmvae_tpu_torch.train.config import TrainingOptions

D, B = 640, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jmodel = JNBVAE(data_dim=D, covar_dim=1)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    jfast = JFast(jmodel, JOptions(nboot=3))
    model = NBVAE(data_dim=D)
    return jfast, jparams, model, _np(jparams)


def _assert_tree(got, want, **tol):
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.detach().numpy(), got)))
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        if tol:
            np.testing.assert_allclose(flat_g[k], np.asarray(w),
                                       err_msg=str(k), **tol)
        else:
            np.testing.assert_array_equal(flat_g[k], np.asarray(w),
                                          err_msg=str(k))


def test_pack_unpack_bitwise_vs_jax(setup):
    jfast, jparams, model, pnp = setup
    fast = NBFastStep(model, TrainingOptions())
    q = fast.pack(params_from_numpy(pnp))
    _assert_tree(q, jfast.pack(jparams))
    _assert_tree(fast.unpack(q), jfast.unpack(jfast.pack(jparams)))
    _assert_tree(fast.unpack(q), jparams)


def test_adam_state_round_trip_vs_jax(setup):
    jfast, jparams, model, pnp = setup
    fast = NBFastStep(model, TrainingOptions())
    jstate = jfast.optimizer.init(jfast.pack(jparams))
    rng = np.random.default_rng(0)
    jnamed = _np(jfast.unpack_opt_state(jstate))

    def draw(a):
        return rng.normal(size=a.shape).astype(np.float32)

    adam = jnamed[2]._replace(
        count=np.int32(7), mu=jax.tree_util.tree_map(draw, jnamed[2].mu),
        nu=jax.tree_util.tree_map(lambda a: np.abs(draw(a)), jnamed[2].nu))
    port = adam_from_numpy((*jnamed[:2], adam, *jnamed[3:]))
    packed = fast.pack_opt_state(port)
    jpacked = jfast.pack_opt_state((*jnamed[:2], adam, *jnamed[3:]))[2]
    _assert_tree(packed["mu"], jpacked.mu)
    _assert_tree(packed["nu"], jpacked.nu)
    back = adam_to_numpy(fast.unpack_opt_state(packed))
    assert back["count"] == 7
    _assert_tree(params_from_numpy(back["mu"]), adam.mu)


@pytest.mark.parametrize("clip_active", [True, False])
def test_optimizer_matches_optax(setup, clip_active):
    jfast, jparams, model, pnp = setup
    topt = TrainingOptions()
    jq = jfast.pack(jparams)
    jstate = jfast.optimizer.init(jq)
    opt = PackedAdam(topt.lr, topt.grad_clip, topt.weight_decay)
    q = {k: torch.from_numpy(np.array(v)) for k, v in jq.items()}
    state = opt.init(q)
    rng = np.random.default_rng(3)
    scale = 1.0 if clip_active else 1e-4  # global norm ~ 70 vs ~ 7e-3
    for _ in range(3):
        g = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
             for k, v in jq.items()}
        norm = np.sqrt(sum(float(np.sum(a.astype(np.float64) ** 2))
                           for a in g.values()))
        assert (norm > topt.grad_clip) == clip_active
        upd, jstate = jfast.optimizer.update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jq)
        jq = jax.tree_util.tree_map(lambda p, u: p + u, jq, upd)
        q, state = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                              state, q)
    _assert_tree(q, jq, rtol=1e-6, atol=1e-9)
    _assert_tree(state["mu"], jstate[2].mu, rtol=1e-6, atol=1e-6 * scale
                 * 1e-2)
    _assert_tree(state["nu"], jstate[2].nu, rtol=1e-6, atol=1e-6 * scale
                 * scale * 1e-4)
    assert int(state["count"]) == int(jstate[2].count) == 3


def _batch(seed=3, dtype=np.int16):
    rng = np.random.default_rng(seed)
    x = rng.poisson(0.7, size=(B, D)).astype(dtype)
    x[0, :5] = 30  # a few tiles of the mixed lgamma regime
    return x, np.ones((B, 1), np.float32)


def _jax_rand(jfast):
    rand = jax.jit(lambda: jfast.draw_rand(jax.random.PRNGKey(7),
                                           jnp.arange(1), B))()
    return _np(jax.tree_util.tree_map(lambda a: a[0], rand))


def test_draw_rand_structure_matches_jax(setup):
    jfast, _, model, _ = setup
    fast = NBFastStep(model, TrainingOptions(nboot=3))
    got = fast.draw_rand(torch.Generator().manual_seed(0), 4, B)
    want = jax.eval_shape(lambda: jfast.draw_rand(jax.random.PRNGKey(0),
                                                  jnp.arange(4), B))
    flat_g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), got))
    flat_w = jax.tree_util.tree_leaves(want)
    assert [a.shape for a in flat_g] == [w.shape for w in flat_w]
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(
        lambda t: 0, got)) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: 0, want))


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_first_boot_gradient_matches_jax(setup, route):
    """The packed gradient of one boot loss, before any update."""
    jfast, jparams, model, pnp = setup
    x, c = _batch()
    rnd = _jax_rand(jfast)
    jq = jfast.pack(jparams)
    beta = 0.37

    def jloss(q):
        return jfast._loss(q, None, jnp.asarray(x), jnp.asarray(c),
                           jnp.asarray(rnd["ridx"][0]),
                           tuple(jnp.asarray(e[0]) for e in rnd["boot_eps"]),
                           beta, include_const=False, boot=True)

    jg = jax.grad(jloss)(jq)
    fast = NBFastStep(model, TrainingOptions(nboot=3), plain=route == "plain")
    q = {k: v.requires_grad_() for k, v in
         fast.pack(params_from_numpy(pnp)).items()}
    r = rand_from_numpy(rnd)
    loss = fast._loss(q, torch.from_numpy(x), torch.from_numpy(c),
                      r["ridx"][0], tuple(e[0] for e in r["boot_eps"]),
                      torch.tensor(beta), include_const=False, boot=True)
    gP, gsv = torch.autograd.grad(loss, (q["P"], q["sv"]))
    for got, want in ((gP, jg["P"]), (gsv, jg["sv"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-4,
                                   atol=5e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("route,interpret", [("kernel", False),
                                             ("plain", False),
                                             ("kernel", True)])
def test_batch_step_matches_jax(setup, monkeypatch, route, interpret):
    """One reference batch step (report + 3 bootstrap Adam steps) from the
    same params and the same JAX-drawn noise; ``interpret`` runs the JAX
    step through its Pallas kernels in interpret mode."""
    jfast, jparams, model, pnp = setup
    monkeypatch.setattr(jns, "_INTERPRET", interpret)
    x, c = _batch(dtype=np.int8 if interpret else np.int16)
    rnd = _jax_rand(jfast)
    jq = jfast.pack(jparams)
    jq2, jst, jrep = jfast.batch_step(
        jq, jfast.optimizer.init(jq), jnp.asarray(x), jnp.asarray(c), 1.0,
        rand=jax.tree_util.tree_map(jnp.asarray, rnd))
    fast = NBFastStep(model, TrainingOptions(nboot=3), plain=route == "plain")
    q = fast.pack(params_from_numpy(pnp))
    q2, st, rep = fast.batch_step(q, fast.optimizer.init(q),
                                  torch.from_numpy(x), torch.from_numpy(c),
                                  1.0, batch_rand(rand_from_numpy(
                                      jax.tree_util.tree_map(
                                          lambda a: a[None], rnd)), 0))
    np.testing.assert_allclose(float(rep), float(jrep), rtol=2e-4)
    _assert_tree(q2, jq2, rtol=3e-3, atol=2e-5)
    _assert_tree(st["mu"], jst[2].mu, rtol=3e-3, atol=1e-8)
    _assert_tree(st["nu"], jst[2].nu, rtol=3e-3, atol=1e-10)
    assert int(st["count"]) == int(jst[2].count) == 3


def test_hidden_layers_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NBFastStep(NBVAE(data_dim=D, mean_encoding=(8,)), TrainingOptions())
    assert params_to_numpy({"a": torch.ones(2)})["a"].dtype == np.float32


def test_packed_step_refusal_names_the_generic_step():
    """A packed step refuses an architecture it does not take by naming
    the generic step the architecture trains on (ported since the NB
    generic step), not an unported path."""
    from mmvae_tpu_torch.ops.nb_fast import PackedFastStep

    class Never(PackedFastStep):
        @staticmethod
        def supports(model):
            return False

    with pytest.raises(NotImplementedError,
                       match=r"generic step, train\.loop\.Trainer"):
        Never(None, TrainingOptions())
    assert "not ported" not in PackedFastStep.UNSUPPORTED
