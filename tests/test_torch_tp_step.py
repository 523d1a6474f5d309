"""The port's tensor-parallel pieces against the JAX package's under
``shard_map`` over a (1, 2) mesh of conftest's CPU devices: the three
collectives with their own backward passes (``parallel.collectives``),
each model's TP report and boot losses with their gradients, the models'
TP recording encoders, and the clip across the model row
(``train.loop.tp_clip`` against JAX's ``Trainer._make_tp_clip``).

Two gloo ranks, each a process of this file (``--worker``), started once
for the module, form the model row.  Each gets its block of the features
of the counts and of the parameters (``parallel.mesh.shard_params`` of
the JAX package's own parameters), and gathers its gradients back
(``gather_params``).  The models' noise is JAX's: the normal draws of the
key each TP loss splits (``_draw_batch``'s ``rep_eps``), and the
mixture's recording Gumbel uniforms.

The models run at D = 200 (100-column shards, no multiple of K2's
64-column tile) against JAX's XLA path, and the NB, joint and mixture
models at D = 96 against JAX's Pallas kernels in interpret mode.
Tolerances: values ``rtol=2e-4``; gradients ``rtol=1e-3`` with an
``atol`` of 1e-4 of the largest of the leaf's module (its weight and
bias together); the collectives' values and gradients ``rtol=1e-5``;
the recording encoders' outputs ``rtol=1e-4, atol=1e-5``, the mixture's
hard assignments equal; the clipped gradients ``rtol=1e-6``.
"""

import os
import pickle
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mmvae_tpu.ops import nb_step as jnb_step
from mmvae_tpu.parallel import collectives as jcoll
from mmvae_tpu.parallel.mesh import make_mesh as jmake_mesh
from mmvae_tpu.train.loop import Trainer as JTrainer
from mmvae_tpu_torch.models.nb import params_from_numpy
from mmvae_tpu_torch.ops.nb_fast import tree_leaves, tree_unflatten
from mmvae_tpu_torch.parallel import collectives as coll
from mmvae_tpu_torch.parallel.mesh import (DataMesh, gather_params,
                                           shard_params)
from mmvae_tpu_torch.train.loop import tp_clip
from tests.test_torch_tp_train import (batch_draws, jax_model, port_model,
                                       wait_ranks)
from tests.test_torch_multihost import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, WORLD = 8, 2
BETA = 0.5
KINDS = ("nb", "joint", "mixture", "vmf")
# (kind, D, JAX's kernels in interpret mode)
MODEL_CASES = [(k, 200, False) for k in KINDS] + [
    (k, 96, True) for k in ("nb", "joint", "mixture")]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return jmake_mesh(model_parallel=2, devices=jax.devices()[:2])


def jax_collectives(x, W, h, Wc, wt, wc):
    """Values and gradients of the three collectives in JAX (x (B, D) and
    W (D, H) split over the features, h (B, H) replicated, Wc (H, D)
    split by columns, wt (B, H) and wc (B, D) the losses' weights)."""
    mesh = _mesh()

    def body(x, W, h, Wc, wc):
        def f_id(x, W):
            return jnp.sum(wt * jcoll.psum_id_grad(x @ W, "model"))

        def f_grad(h, Wc):
            return jnp.sum(wc * (jcoll.psum_grad(h, "model") @ Wc))

        def f_norm(x):
            return jnp.sum(wc * jcoll.tp_l2_normalize(x, "model", axis=1))

        y = jcoll.psum_id_grad(x @ W, "model")
        gx, gW = jax.grad(f_id, argnums=(0, 1))(x, W)
        gh, gWc = jax.grad(f_grad, argnums=(0, 1))(h, Wc)
        n = jcoll.tp_l2_normalize(x, "model", axis=1)
        gn = jax.grad(f_norm)(x)
        m = jax.lax.pmax(x, "model")
        return y, gx, gW, gh, gWc, n, gn, m

    col, row, rep = P(None, "model"), P("model", None), P()
    f = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(col, row, rep, col, col),
        out_specs=(rep, col, row, rep, col, col, col, col),
        check_vma=False))
    return _np(f(x, W, h, Wc, wc))


def jax_model_case(kind, D, interpret, x, key):
    """JAX's TP report value, boot value and boot gradients (full arrays)
    and recording encoder outputs for one model."""
    jmodel = jax_model(kind, D)
    params = jmodel.init(jax.random.PRNGKey(3))
    specs = jmodel.tp_pspecs(params)
    mesh = _mesh()
    c = jnp.ones((B, 1), jnp.float32)
    rkey = jax.random.PRNGKey(0)

    if kind == "vmf":
        rep_fn = boot_fn = lambda p, x, c: jmodel.tp_step_loss(  # noqa
            p, x, c, key, BETA)
        rec_fn = lambda p, x: jmodel.tp_encode(p, x, None, "model")  # noqa
    else:
        rep_fn = lambda p, x, c: jmodel.fused_step_report_tp(  # noqa
            p, x, c, key, BETA)
        boot_fn = lambda p, x, c: jmodel.fused_step_boot_tp(  # noqa
            p, x, c, key, BETA, need_value=True)
        if kind == "nb":
            rec_fn = lambda p, x: jmodel.tp_encode_mu(  # noqa
                p, x, None, "model")
        elif kind == "joint":
            rec_fn = lambda p, x: jmodel.tp_shared_encode_mu(  # noqa
                p, x, "model")
        else:
            def rec_fn(p, x):
                vmf = jmodel.tp_vmf_forward(p, x, rkey, False, "model")
                return (*jmodel.tp_nb_encode_mu(p, x, vmf.latent, "model"),
                        vmf.latent)

    def body(p, x, c):
        rep = rep_fn(p, x, c)
        val, g = jax.value_and_grad(boot_fn)(p, x, c)
        return rep, val, g, rec_fn(p, x)

    n_rec = 3 if kind == "mixture" else 2
    f = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(specs, P(None, "model"), P()),
        out_specs=(P(), P(), specs, (P(),) * n_rec), check_vma=False))
    old = jnb_step._INTERPRET
    jnb_step._INTERPRET = interpret
    try:
        rep, val, g, rec = f(params, jnp.asarray(x, jnp.float32), c)
    finally:
        jnb_step._INTERPRET = old
    out = dict(params=_np(params), rep=float(rep), val=float(val),
               grads=_np(g), rec=_np(rec))
    if kind == "mixture":
        # the uniforms tp_vmf_forward draws from its key at eval
        out["u"] = np.asarray(jax.random.uniform(
            rkey, (B, jmodel.label.shape[1]), minval=1e-20, maxval=1.0))
    return out


def jax_clip(grads_full, specs, max_norm):
    """JAX's ``_make_tp_clip`` under shard_map on the full gradients."""
    clip = JTrainer._make_tp_clip(specs, "model", max_norm)
    f = jax.jit(jax.shard_map(clip, mesh=_mesh(), in_specs=(specs,),
                              out_specs=specs, check_vma=False))
    return _np(f(grads_full))


def _start_ranks(tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu", MMVAE_DIST_TIMEOUT="60",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    coord = f"127.0.0.1:{free_port()}"
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         coord, str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _worker(rank: int, coord: str, tmp: str) -> None:
    from mmvae_tpu_torch.parallel.multihost import init_multihost

    torch.set_num_threads(1)
    dev = init_multihost(coord, WORLD, rank, torch.device("cpu"))
    group = torch.distributed.new_group([0, 1])
    mesh = DataMesh(WORLD, rank, dev, "dp_shard", 2, group, None)
    with open(os.path.join(tmp, "cases.pkl"), "rb") as f:
        spec = pickle.load(f)
    out = {}

    # the collectives
    cv = spec["coll"]
    D = cv["x"].shape[1]
    cols = mesh.local_cols(D)
    x = _t(cv["x"][:, cols]).requires_grad_()
    W = _t(cv["W"][cols]).requires_grad_()
    h = _t(cv["h"]).requires_grad_()
    Wc = _t(cv["Wc"][:, cols]).requires_grad_()
    wt, wc = _t(cv["wt"]), _t(cv["wc"][:, cols])
    y = coll.psum_id_grad(x @ W, group)
    gx, gW = torch.autograd.grad(torch.sum(wt * y), (x, W))
    gh, gWc = torch.autograd.grad(
        torch.sum(wc * (coll.psum_grad(h, group) @ Wc)), (h, Wc))
    n = coll.tp_l2_normalize(x, group, dim=1)
    (gn,) = torch.autograd.grad(torch.sum(wc * n), (x,))
    m = coll.pmax(x.detach(), group)
    out["coll"] = [t.detach().numpy().copy()
                   for t in (y, gx, gW, gh, gWc, n, gn, m)]

    # the models
    for (kind, D, interp), case in spec["models"].items():
        model = port_model(kind, D)
        specs = model.tp_pspecs(model.init(torch.Generator().manual_seed(0)))
        cols = mesh.local_cols(D)
        p = shard_params(params_from_numpy(case["params"]), specs, mesh)
        xl = _t(spec["x"][:, :D][:, cols])
        c = torch.ones((B, 1))
        eps = tuple(_t(e) for e in case["eps"])
        if kind == "vmf":
            def rep_fn(q):
                return model.tp_step_loss(q, xl, c, eps, BETA, group)
            boot_fn = rep_fn
        else:
            def rep_fn(q):
                return model.fused_step_report_tp(q, xl, c, eps, BETA, group)

            def boot_fn(q):
                return model.fused_step_boot_tp(q, xl, c, eps, BETA, group,
                                                need_value=True)
        with torch.no_grad():
            rep = float(rep_fn(p))
        leaves = {k: v for k, v in p.items()}
        flat, paths = [], []
        for k in sorted(leaves):
            v = leaves[k]
            if isinstance(v, dict):
                for kk in sorted(v):
                    v[kk] = v[kk].detach().requires_grad_()
                    flat.append(v[kk])
                    paths.append((k, kk))
            else:
                leaves[k] = v.detach().requires_grad_()
                flat.append(leaves[k])
                paths.append((k,))
        val = boot_fn(leaves)
        gl = torch.autograd.grad(val, flat, allow_unused=True)
        g = {}
        for path, gv, v in zip(paths, gl, flat):
            gv = torch.zeros_like(v) if gv is None else gv
            if len(path) == 1:
                g[path[0]] = gv
            else:
                g.setdefault(path[0], {})[path[1]] = gv
        gfull = gather_params(g, specs, mesh)
        rec_fn, _ = model.tp_record_encoder(0, B, None, group)
        if kind == "mixture":
            rec_fn = partial(_mixture_rec, model, _t(case["u"]), group)
        with torch.no_grad():
            rec = [t.numpy().copy() for t in rec_fn(p, xl)]
        out["model", kind, D, interp] = dict(
            rep=rep, val=float(val), rec=rec,
            grads=jax.tree_util.tree_map(lambda t: t.numpy().copy(),
                                         gfull))

    # the clip, on a gradient tree of the NB model's shapes
    model = port_model("nb", 200)
    specs = model.tp_pspecs(model.init(torch.Generator().manual_seed(0)))
    split = [a is not None for a in tree_leaves(specs)]
    for name, gtree in spec["clip"]["grads"].items():
        gs = shard_params(params_from_numpy(gtree), specs, mesh)
        clipped = tp_clip(tree_leaves(gs), split, group, 1.0)
        full = gather_params(tree_unflatten(gs, clipped), specs, mesh)
        out["clip", name] = jax.tree_util.tree_map(
            lambda t: t.numpy().copy(), full)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _mixture_rec(model, u, group, p, x):
    vmf = model.tp_vmf_forward(p, x, False, group, u)
    return (*model.tp_nb_encode_mu(p, x, vmf.latent, group), vmf.latent)


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tpstep")
    rng = np.random.default_rng(9)
    Dc = 40
    coll_in = dict(
        x=rng.normal(size=(B, Dc)).astype(np.float32),
        W=rng.normal(size=(Dc, 5)).astype(np.float32),
        h=rng.normal(size=(B, 5)).astype(np.float32),
        Wc=rng.normal(size=(5, Dc)).astype(np.float32),
        wt=rng.normal(size=(B, 5)).astype(np.float32),
        wc=rng.normal(size=(B, Dc)).astype(np.float32))
    x = rng.poisson(1.2, size=(B, 200)).astype(np.float32)
    x[:2, :4] += 20  # tiles of the mixed lgamma regime
    models, refs = {}, {}
    for kind, D, interp in MODEL_CASES:
        key = jax.random.PRNGKey(7)
        # the key each TP loss splits: _draw_batch's rep_eps are its draws
        k_rep = jax.random.split(key)[0]
        eps = batch_draws(kind, key, B)["rep_eps"]
        ref = jax_model_case(kind, D, interp, x[:, :D], k_rep)
        refs[kind, D, interp] = ref
        models[kind, D, interp] = dict(params=ref["params"], eps=eps,
                                       u=ref.get("u"))
    # gradients of the NB model's shapes, one tree whose norm the clip
    # scales down and one it leaves alone
    jm = jax_model("nb", 200)
    p = _np(jm.init(jax.random.PRNGKey(0)))
    specs = jm.tp_pspecs(p)
    grads = {name: jax.tree_util.tree_map(
        lambda a: (scale * rng.normal(size=a.shape)).astype(np.float32), p)
        for name, scale in (("large", 1.0), ("small", 1e-4))}
    clip_refs = {name: jax_clip(g, specs, 1.0) for name, g in grads.items()}
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(dict(coll=coll_in, x=x, models=models,
                         clip=dict(grads=grads)), f)
    wait_ranks(_start_ranks, tmp)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    coll_ref = jax_collectives(**coll_in)
    return dict(coll=coll_ref, models=refs, clip=clip_refs, grads=grads,
                ranks=ranks)


COLL_NAMES = ["psum_id_grad", "psum_id_grad dx", "psum_id_grad dW",
              "psum_grad dh", "psum_grad dWc", "tp_l2_normalize",
              "tp_l2_normalize dx", "pmax"]


@pytest.mark.parametrize("i", range(len(COLL_NAMES)), ids=COLL_NAMES)
def test_collective_matches_jax(result, i):
    """Each rank's value or gradient is its block of JAX's (replicated
    ones whole); the ranks' replicated results are bitwise equal."""
    want = result["coll"][i]
    Dc = result["coll"][1].shape[1]
    got = [result["ranks"][r]["coll"][i] for r in range(WORLD)]
    split_rows = COLL_NAMES[i] == "psum_id_grad dW"
    split_cols = COLL_NAMES[i] in ("psum_id_grad dx", "psum_grad dWc",
                                   "tp_l2_normalize", "tp_l2_normalize dx",
                                   "pmax")
    for r, g in enumerate(got):
        w = Dc // WORLD
        if split_rows:
            ref = want[r * w:(r + 1) * w]
        elif split_cols:
            ref = want[:, r * w:(r + 1) * w]
        else:
            ref = want
            assert np.array_equal(g, got[0])
        np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-6)


def _module_scale(tree):
    out = {}
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        k = path[0].key
        out[k] = max(out.get(k, 0.0), float(np.abs(a).max()))
    return out


@pytest.mark.parametrize("kind,D,interp", MODEL_CASES)
def test_model_tp_losses_and_grads_match_jax(result, kind, D, interp):
    want = result["models"][kind, D, interp]
    scale = _module_scale(want["grads"])
    for r in range(WORLD):
        got = result["ranks"][r]["model", kind, D, interp]
        np.testing.assert_allclose(got["rep"], want["rep"], rtol=2e-4)
        np.testing.assert_allclose(got["val"], want["val"], rtol=2e-4)
        g_got = dict(jax.tree_util.tree_leaves_with_path(got["grads"]))
        g_want = dict(jax.tree_util.tree_leaves_with_path(want["grads"]))
        assert g_got.keys() == g_want.keys()
        for k, w in g_want.items():
            np.testing.assert_allclose(
                g_got[k], w, rtol=1e-3, atol=1e-4 * scale[k[0].key],
                err_msg=str(k))


@pytest.mark.parametrize("kind,D,interp", MODEL_CASES)
def test_model_tp_record_encoder_matches_jax(result, kind, D, interp):
    want = result["models"][kind, D, interp]["rec"]
    for r in range(WORLD):
        got = result["ranks"][r]["model", kind, D, interp]["rec"]
        assert len(got) == len(want)
        # replicated over the model row: the same bits on every rank
        for g, g0 in zip(got, result["ranks"][0]["model", kind, D,
                                                  interp]["rec"]):
            assert np.array_equal(g, g0)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
        if kind == "mixture":
            assert np.array_equal(np.argmax(got[2], 1), np.argmax(want[2], 1))
            np.testing.assert_allclose(got[2], want[2], atol=1e-6)


@pytest.mark.parametrize("name", ["large", "small"])
def test_tp_clip_matches_jax(result, name):
    want = result["clip"][name]
    for r in range(WORLD):
        got = result["ranks"][r]["clip", name]
        for (path, w), g in zip(
                jax.tree_util.tree_leaves_with_path(want),
                jax.tree_util.tree_leaves(got)):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9,
                                       err_msg=str(path))
    if name == "small":  # below the clip: untouched
        for w, g in zip(jax.tree_util.tree_leaves(result["grads"][name]),
                        jax.tree_util.tree_leaves(
                            result["ranks"][0]["clip", name])):
            assert np.array_equal(w, g)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
