"""The port's fused step at widths past the compile-time instances
(ops/nb_step.py): the stacked rows T = R + C + Rn + 2 (+ 1 with pb) of
``nb_vae --mean_latent 13`` with one covariate (T = 17), a covariate
file of 12 columns (T = 17), the joint model with 11 overdispersion
latents and pb (T = 17), (16, 5, 1) (T = 24), a covariate file of 40
columns (T = 45) and of 123 (T = 128), against the JAX package, which
takes any width (``_prep`` pads T to a multiple of 8).

On the CPU every wrapper runs its plain version, so these tests hold the
plain versions of K1, K6, K2 and K3 (and the gradient assembly around
them) against JAX's XLA spec, and at T = 17 against its Pallas kernels in
interpret mode; the CUDA kernels' general instances are held against the
same plain versions on the card by ``chip_smoke.py`` (phases 28, 29, 30)
and their plans here.

Tolerances, the JAX suite's own (tests/test_nb_step.py, as
tests/test_torch_nb_step.py): values ``rtol=3e-5``; gradients
``rtol=5e-4, atol=5e-6 * max|ref|``; one packed batch step the
trajectory yardstick of tests/test_torch_nb_fast.py and
tests/test_torch_vmfnb_fast.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.models.nb import NBVAE as JNBVAE
from mmvae_tpu.models.vmfnb import VMFNBVAE as JVAE
from mmvae_tpu.ops import nb_step as jns
from mmvae_tpu.ops.nb_fast import NBFastStep as JFast
from mmvae_tpu.ops.vmfnb_fast import VMFNBFastStep as JJFast
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu_torch.models.nb import NBVAE, params_from_numpy
from mmvae_tpu_torch.models.vmfnb import VMFNBVAE
from mmvae_tpu_torch.ops import nb_step as tns
from mmvae_tpu_torch.ops.nb_fast import NBFastStep, batch_rand, rand_from_numpy
from mmvae_tpu_torch.ops.vmfnb_fast import VMFNBFastStep
from mmvae_tpu_torch.train.config import TrainingOptions

# (R, C, Rn): the widths of the repair; the joint one carries pb
NB_WIDE = [(13, 1, 1), (2, 12, 1), (16, 5, 1), (2, 40, 1), (2, 123, 1)]
JOINT_WIDE = (2, 1, 11)
DIFF = (1, 3, 4, 5, 6, 7, 8, 9)  # zm, zn, depth, wd, wc, bias2, wn, bias_n
NAMES = ["zm", "zn", "depth", "wd", "wc", "bias2", "wn", "bias_n", "pb"]


def _inputs(widths, regime, B=6, D=300, seed=0, joint=False):
    R, C, Rn = widths
    rng = np.random.default_rng(seed + 7 * R + C + Rn)
    if regime == "le7":
        x = rng.poisson(0.8, size=(B, D)).clip(0, 6).astype(np.int8)
    elif regime == "integer":
        x = rng.poisson(9.0, size=(B, D)).clip(0, 40).astype(np.int16)
    else:
        x = rng.poisson(0.8, size=(B, D)).astype(np.float32)
        x[0, :7] += 0.5
    zm = rng.normal(size=(B, R)).astype(np.float32)
    c = rng.normal(size=(B, C)).astype(np.float32)
    zn = rng.normal(size=(B, Rn)).astype(np.float32)
    depth = (np.abs(rng.normal(size=(B, 1))) + 0.3).astype(np.float32)
    w = [(rng.normal(size=s) * 0.2).astype(np.float32)
         for s in ((R, D), (C, D), (D,), (Rn, D), (D,))]
    if joint:
        w.append((rng.normal(size=(D,)) * 0.2).astype(np.float32))
    return [x, zm, c, zn, depth, *w]


def _torch(args, grad=False):
    out = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    if grad:
        for i in (*DIFF, 10) if len(out) == 11 else DIFF:
            out[i].requires_grad_()
    return out


def _assert_grads(got, want):
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b)
        scale = max(1e-3, float(np.abs(b).max()))
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=5e-4,
                                   atol=5e-6 * scale,
                                   err_msg=f"grad mismatch: {name}")


def _xla_value_and_grads(args, include_const, joint):
    """JAX's XLA spec (``xla_step_nll``) and its gradient in the
    differentiable operands (and pb)."""
    diff = (*DIFF, 10) if joint else DIFF

    def loss(*d):
        a = [jnp.asarray(v) for v in args]
        for i, v in zip(diff, d):
            a[i] = v
        pb = a[10] if joint else None
        return jns.xla_step_nll(*a[:10], pb=pb, include_const=include_const,
                                nu_exp=joint)

    d = tuple(jnp.asarray(args[i]) for i in diff)
    return jax.value_and_grad(loss, argnums=tuple(range(len(diff))))(*d)


# ----------------------------------------------------------------------
# the plans take every width of the repair, on the general instance
# ----------------------------------------------------------------------

@pytest.mark.parametrize("widths", [*NB_WIDE, JOINT_WIDE])
def test_plans_take_the_wide_widths(widths):
    R, C, Rn = widths
    joint = widths == JOINT_WIDE
    for plan in (tns.valgrad_plan(100, 20000, R, C, Rn, joint),
                 tns.valgrad_plan(100, 20000, R, C, Rn, joint, True),
                 tns.value_plan(100, 20000, R, C, Rn, joint)):
        assert plan.instance == "general"
        assert plan.workspace > 0
    # K1 and K3 read R + C + 1 rows: the joint width keeps their
    # compile-time (2, 1) instances
    for plan in (tns.finish_plan(100, 20000, R, C),
                 tns.lse_plan(100, 20000, R, C)):
        assert plan.instance == ("fixed" if joint else "general")
    T = R + C + Rn + 2
    assert tns.valgrad_plan(100, 20000, R, C, Rn).smem == T * 1280
    assert tns.value_plan(100, 20000, R, C, Rn).smem == T * 256
    assert tns.finish_plan(100, 20000, R, C).smem == (
        0 if joint else (R + C + 1) * 1280)


def test_plans_at_the_widths_once_refused():
    """The widths the reference trains and the port once refused."""
    assert tns.valgrad_plan(100, 20000, 13, 1, 1).instance == "general"
    assert tns.valgrad_plan(100, 20000, 2, 12, 1).instance == "general"
    assert tns.valgrad_plan(100, 20000, 2, 1, 11,
                            joint=True).instance == "general"
    assert tns.lse_plan(100, 20000, 13, 3).instance == "general"
    assert tns.value_plan(100, 20000, 2, 123, 1).grid == (313, 5)
    assert tns.finish_plan(100, 20000, 2, 123).grid == (313, 2)


@pytest.mark.parametrize("kernel,rows", [("valgrad", 181), ("value", 908),
                                         ("finish", 181)])
def test_card_limit_is_the_shared_memory_of_a_block(kernel, rows):
    """The one limit left: the general instance's shared memory, at most
    232,448 bytes a block on the H100; the refusal names it."""
    assert tns.MAX_STACKED_ROWS[kernel] == rows
    assert rows * tns.SMEM_ROW_BYTES[kernel] <= tns.MAX_SMEM_BYTES
    assert (rows + 1) * tns.SMEM_ROW_BYTES[kernel] > tns.MAX_SMEM_BYTES
    assert rows >= 128
    plan = {"valgrad": lambda C: tns.valgrad_plan(10, 100, 2, C, 1),
            "value": lambda C: tns.value_plan(10, 100, 2, C, 1),
            "finish": lambda C: tns.finish_plan(10, 100, 2, C)}[kernel]
    fill = rows - (5 if kernel != "finish" else 3)  # C filling the rows
    assert plan(fill).smem == rows * tns.SMEM_ROW_BYTES[kernel]
    with pytest.raises(ValueError, match="232,448 bytes"):
        plan(fill + 1)


# ----------------------------------------------------------------------
# the plain versions (the kernels' reference on the card) against JAX
# ----------------------------------------------------------------------

@pytest.mark.parametrize("regime", ["le7", "integer", "nonint"])
@pytest.mark.parametrize("widths", NB_WIDE)
def test_report_matches_xla_spec_at_wide_widths(widths, regime):
    """K1 then K6 (plain) against ``xla_step_nll`` with ``lgamma(x + 1)``."""
    args = _inputs(widths, regime, seed=1)
    want = jns.xla_step_nll(*[jnp.asarray(a) for a in args],
                            include_const=True)
    got = tns.nb_step_report(*_torch(args), include_const=True)
    np.testing.assert_allclose(float(got), float(want), rtol=3e-5)


@pytest.mark.parametrize("regime", ["le7", "integer", "nonint"])
@pytest.mark.parametrize("widths", NB_WIDE)
def test_boot_matches_xla_spec_at_wide_widths(widths, regime):
    """K1 -> K2v -> K3 (plain) and the gradient assembly against
    ``jax.grad`` of ``xla_step_nll`` (no ``lgamma(x + 1)``)."""
    args = _inputs(widths, regime, seed=2)
    v, g = _xla_value_and_grads(args, False, False)
    t = _torch(args, grad=True)
    got = tns.nb_step_boot(*t)
    np.testing.assert_allclose(float(got.detach()), float(v), rtol=3e-5)
    got.backward()
    _assert_grads([t[i].grad for i in DIFF], g)


@pytest.mark.parametrize("regime", ["le7", "integer", "nonint"])
def test_joint_report_and_boot_match_xla_spec_at_t17(regime):
    """The joint model's NB half at (2, 1, 11) with pb (T = 17): K6p and
    K1 -> K2pv -> K3 (plain) against the XLA spec with ``pb`` and the
    exp-clamp nu."""
    args = _inputs(JOINT_WIDE, regime, seed=3, joint=True)
    jargs = [jnp.asarray(a) for a in args]
    want = jns.xla_step_nll(*jargs[:10], pb=jargs[10], include_const=True,
                            nu_exp=True)
    got = tns.nb_step_report(*_torch(args[:10]), include_const=True,
                             pb=torch.from_numpy(args[10]))
    np.testing.assert_allclose(float(got), float(want), rtol=3e-5)
    v, g = _xla_value_and_grads(args, False, True)
    t = _torch(args, grad=True)
    got = tns.nb_step_boot_joint(*t)
    np.testing.assert_allclose(float(got.detach()), float(v), rtol=3e-5)
    got.backward()
    _assert_grads([t[i].grad for i in (*DIFF, 10)], g)


@pytest.mark.parametrize("widths", [(13, 1, 1), JOINT_WIDE])
def test_raw_kernel_outputs_match_pallas_interpret_at_t17(monkeypatch,
                                                         widths):
    """At T = 17 each plain version's raw outputs against its Pallas
    kernel's in interpret mode: K1 lse, K6 (K6p) the NLL, K2 (K2p) gout,
    rsum, u1, dzn and K3 fout, u2."""
    monkeypatch.setattr(jns, "_INTERPRET", True)
    joint = widths == JOINT_WIDE
    args = _inputs(widths, "integer", B=9, D=1100, seed=4, joint=joint)
    jargs = [jnp.asarray(a) for a in args]
    pb = jargs[10] if joint else None
    xp, zmp, cp, znp, dpp, W, dims = jns._prep(*jargs[:10], pb)
    B, D, R, C, Rn = (dims[k] for k in ("B", "D", "R", "C", "Rn"))
    assert R + C + Rn + 2 + joint == 17
    lj = jns._lse_call(zmp, cp, W, dims["bp"], dims["Dp"],
                       jns._tile_for(dims["bp"]), D, R, C)
    vj = jns._value_call(xp, zmp, cp, znp, dpp, lj, W, D=D, B=B,
                         with_const=True, has_pb=joint, nu_exp=joint)
    _, gout, rsum, u1, dzn = jns._valgrad_call(
        xp, zmp, cp, znp, dpp, lj, W, D=D, B=B, has_pb=joint, nu_exp=joint,
        need_value=False)
    fout, u2 = jns._finish_call(zmp, cp, lj, rsum, W, D=D)

    t = _torch(args)
    zc = torch.cat([t[1], t[2]], 1)
    Wt = tns.stack_rows(*t[5:10], t[10] if joint else None)
    lt = tns.lse(zc, Wt, R, C)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj)[:B], rtol=1e-6)
    val = tns.value(t[0], zc, t[3], t[4], lt, Wt, R, C, Rn, True, joint)
    np.testing.assert_allclose(float(val), float(vj), rtol=3e-5)
    got = tns.valgrad(t[0], zc, t[3], t[4], lt, Wt, R, C, Rn, joint)
    fin = tns.finish(zc, lt, got[1].contiguous(), Wt, R, C)
    T = R + C + Rn + 2 + joint
    want = [np.asarray(gout)[:T, :D], np.asarray(rsum)[:B],
            np.asarray(u1)[:B], np.asarray(dzn)[:B],
            np.asarray(fout)[:R + C + 1, :D], np.asarray(u2)[:B]]
    for name, a, b in zip(["gout", "rsum", "u1", "dzn", "fout", "u2"],
                          [*got, *fin], want):
        scale = max(1e-3, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, rtol=5e-4,
                                   atol=5e-6 * scale, err_msg=name)


@pytest.mark.parametrize("widths", NB_WIDE)
def test_lse_matches_logsumexp_at_wide_widths(widths):
    """K1's plain version against JAX's logsumexp of the XLA logits."""
    R, C, _ = widths
    x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n = _inputs(widths,
                                                             "integer")
    h = jnp.asarray(zm) @ wd + jnp.asarray(c) @ wc + bias2
    want = np.asarray(jax.nn.logsumexp(h, axis=1, keepdims=True))
    t = _torch([zm, c, wd, wc, bias2, wn, bias_n])
    got = tns.lse(torch.cat([t[0], t[1]], 1), tns.stack_rows(*t[2:]), R, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ----------------------------------------------------------------------
# one packed batch step at a wide model, fed JAX's parameters and draws
# ----------------------------------------------------------------------

D_STEP, B_STEP = 640, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree(got, want, **tol):
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.detach().numpy(), got)))
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        np.testing.assert_allclose(flat_g[k], np.asarray(w), err_msg=str(k),
                                   **tol)


def _counts(seed, dtype=np.int16):
    rng = np.random.default_rng(seed)
    x = rng.poisson(0.7, size=(B_STEP, D_STEP)).astype(dtype)
    x[0, :5] = 30  # a few tiles of the mixed lgamma regime
    return x


def _jax_rand(jfast):
    rand = jax.jit(lambda: jfast.draw_rand(jax.random.PRNGKey(7),
                                           jnp.arange(1), B_STEP))()
    return _np(jax.tree_util.tree_map(lambda a: a[0], rand))


def test_nb_batch_step_at_mean_latent_13_matches_jax():
    """``nb_vae --mean_latent 13`` with one covariate (T = 17): one
    packed batch step (report + 3 bootstrap Adam steps) on the kernel
    route's plain versions, from JAX's parameters and JAX's noise."""
    jmodel = JNBVAE(data_dim=D_STEP, covar_dim=1, mean_latent=13)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    jfast = JFast(jmodel, JOptions(nboot=3))
    model = NBVAE(data_dim=D_STEP, covar_dim=1, mean_latent=13)
    fast = NBFastStep(model, TrainingOptions(nboot=3))
    assert (fast.rows.R, fast.rows.C) == (13, 1)
    x, c = _counts(3), np.ones((B_STEP, 1), np.float32)
    rnd = _jax_rand(jfast)
    jq = jfast.pack(jparams)
    jq2, jst, jrep = jfast.batch_step(
        jq, jfast.optimizer.init(jq), jnp.asarray(x), jnp.asarray(c), 1.0,
        rand=jax.tree_util.tree_map(jnp.asarray, rnd))
    q = fast.pack(params_from_numpy(_np(jparams)))
    q2, st, rep = fast.batch_step(
        q, fast.optimizer.init(q), torch.from_numpy(x), torch.from_numpy(c),
        1.0, batch_rand(rand_from_numpy(jax.tree_util.tree_map(
            lambda a: a[None], rnd)), 0))
    np.testing.assert_allclose(float(rep), float(jrep), rtol=2e-4)
    _assert_tree(q2, jq2, rtol=3e-3, atol=2e-5)
    _assert_tree(st["mu"], jst[2].mu, rtol=3e-3, atol=1e-8)
    _assert_tree(st["nu"], jst[2].nu, rtol=3e-3, atol=1e-10)
    assert int(st["count"]) == int(jst[2].count) == 3


def test_joint_batch_step_at_t17_matches_jax():
    """The joint model with 11 overdispersion latents (2 + 1 + 11 + 2 + pb
    = 17 stacked rows): one packed batch step from JAX's parameters and
    noise, held as tests/test_torch_vmfnb_fast.py holds the default one:
    the report and the Adam moments to the yardstick, the parameters
    where their first moment is at least 2% of its row's scale (outside
    the kappa row)."""
    jmodel = JVAE(data_dim=D_STEP, overdisp_latent=11)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    jfast = JJFast(jmodel, JOptions(nboot=3))
    fast = VMFNBFastStep(VMFNBVAE(data_dim=D_STEP, overdisp_latent=11),
                         TrainingOptions(nboot=3))
    assert fast.rows.Rn == 11
    x, c = _counts(4), np.ones((B_STEP, 1), np.float32)
    rnd = _jax_rand(jfast)
    jq = jfast.pack(jparams)
    jq2, jst, jrep = jfast.batch_step(
        jq, jfast.optimizer.init(jq), jnp.asarray(x), jnp.asarray(c), 1.0,
        rand=jax.tree_util.tree_map(jnp.asarray, rnd))
    q = fast.pack(params_from_numpy(_np(jparams)))
    q2, st, rep = fast.batch_step(
        q, fast.optimizer.init(q), torch.from_numpy(x), torch.from_numpy(c),
        1.0, batch_rand(rand_from_numpy(jax.tree_util.tree_map(
            lambda a: a[None], rnd)), 0))
    np.testing.assert_allclose(float(rep), float(jrep), rtol=2e-4)
    _assert_tree(st["mu"], jst[2].mu, rtol=3e-3, atol=1e-8)
    _assert_tree(st["nu"], jst[2].nu, rtol=3e-3, atol=1e-10)
    assert int(st["count"]) == int(jst[2].count) == 3
    for k in ("P", "sv"):
        jmu = np.asarray(jst[2].mu[k]).reshape(-1, D_STEP if k == "P" else 1)
        if k == "sv":
            jmu = jmu.T
        weak = np.abs(jmu) < 2e-2 * np.abs(jmu).max(axis=1, keepdims=True)
        if k == "P":
            weak[fast.rows.kappa_w] = True
        got = q2[k].numpy().reshape(jmu.shape)
        want = np.asarray(jq2[k]).reshape(jmu.shape)
        np.testing.assert_allclose(got[~weak], want[~weak], rtol=3e-3,
                                   atol=1e-4, err_msg=k)
