"""The port's tensor-parallel training step (the generic ``Trainer`` with
``tp_pspecs`` and the models' ``fused_step_*_tp`` / ``tp_step_loss``,
built by each trainer CLI's ``make_step(mesh=...)``) against the JAX
package's TP ``Trainer`` (``tp_shard_map=True``) under ``shard_map`` on
conftest's CPU devices.

Four gloo ranks, each a process of this file (``--worker``), started once
for the module.  They form a (2, 2) grid (``parallel.mesh.make_mesh``)
and, through its model rows, two (1, 2) grids that run the same work
(ranks 2 and 3 repeat ranks 0 and 1: two runs, the same bits).  Every
model (NB, joint, mixture, vMF) takes S = 2 batch steps of nboot = 2 on
both grids: at D = 200 on (1, 2), whose 100-column shards are no
multiple of K2's 64-column tile, against JAX's XLA path; at D = 96 on
(2, 2) against JAX's Pallas kernels in interpret mode (the vMF-VAE has
no kernel: its XLA path).  Each data index is fed the draws JAX's step
makes in-step (``_draw_batch`` of the batch key with the data index
folded in, as ``_batch_step(axis_name='data')`` folds it), its rows of
each batch and its block of the features.

Tolerances, the data-parallel file's (tests/test_torch_parallel.py):
reports ``rtol=2e-4``; Adam's first moments ``rtol=3e-3`` with an
``atol`` of 1e-3 of the largest of the leaf's module (its weight and
bias together: the joint model's one-element ``ln_kappa`` bias has
moments ~1e-3 of its weight's, sums whose terms cancel, and JAX's own TP
and non-TP steps differ there by 0.3%); parameters ``rtol=3e-3,
atol=1e-4`` where the first moment is at least 2% of its leaf's largest.
Replicated leaves are bitwise equal on every rank of a grid after every
step; the split ones gather to the full tree.

Then the NB ``DenseEpochRunner`` over 2 epochs on (1, 2) and (2, 2) with
the port's own draws: every rank's gathered parameters bitwise equal,
and the runs of the two (1, 2) grids bitwise equal.
"""

import os
import pickle
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from mmvae_tpu.models.nb import NBVAE as JNBVAE
from mmvae_tpu.models.vmf import VMFVAE as JVMFVAE
from mmvae_tpu.models.vmfnb import VMFNBVAE as JVMFNBVAE
from mmvae_tpu.models.vmfnb_mixture import VMFNBMixtureVAE as JMixVAE
from mmvae_tpu.ops import nb_step as jnb_step
from mmvae_tpu.ops.nb_fast import NBFastStep as JNBFast
from mmvae_tpu.ops.vmf_fast import VMFFastStep as JVMFFast
from mmvae_tpu.ops.vmfnb_fast import VMFNBFastStep as JJointFast
from mmvae_tpu.ops.vmfnb_fast import VMFNBMixtureFastStep as JMixFast
from mmvae_tpu.parallel.mesh import make_mesh as jmake_mesh
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import Trainer as JTrainer
from mmvae_tpu_torch.cli import nb_vae, vmf_vae, vmfnb_vae
from mmvae_tpu_torch.models.nb import NBVAE, params_from_numpy
from mmvae_tpu_torch.models.vmf import VMFVAE
from mmvae_tpu_torch.models.vmfnb import VMFNBVAE
from mmvae_tpu_torch.models.vmfnb_mixture import VMFNBMixtureVAE
from mmvae_tpu_torch.ops.nb_fast import rand_from_numpy
from mmvae_tpu_torch.parallel.mesh import (DataMesh, gather_params,
                                           make_mesh, shard_params)
from mmvae_tpu_torch.train.config import TrainingOptions
from mmvae_tpu_torch.train.loop import DenseEpochRunner
from tests.test_torch_multihost import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, NBOOT, K, WORLD = 8, 2, 2, 3, 4
EPOCH = 3  # a KL weight away from its floor
KINDS = ("nb", "joint", "mixture", "vmf")
# (grid, D, JAX's kernels in interpret mode)
GRIDS = {"1x2": ((1, 2), 200, False), "2x2": ((2, 2), 96, True)}
CASES = [(kind, grid) for grid in GRIDS for kind in KINDS]


def label(D):
    rng = np.random.default_rng(11)
    L = (rng.random((D, K)) < 0.25).astype(np.float32)
    L[:K] = np.eye(K, dtype=np.float32)
    L[-7:] = 0.0  # features no component covers: the filter's zeros
    return L


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_model(kind, D):
    return {"nb": lambda: JNBVAE(data_dim=D, covar_dim=1),
            "joint": lambda: JVMFNBVAE(data_dim=D),
            "mixture": lambda: JMixVAE(label=label(D)),
            "vmf": lambda: JVMFVAE(data_dim=D, covar_dim=1, encoding=(8,),
                                   do_relu=True)}[kind]()


def port_model(kind, D):
    return {"nb": lambda: NBVAE(data_dim=D),
            "joint": lambda: VMFNBVAE(data_dim=D),
            "mixture": lambda: VMFNBMixtureVAE(label=label(D)),
            "vmf": lambda: VMFVAE(data_dim=D, covar_dim=1, encoding=(8,),
                                  do_relu=True)}[kind]()


def port_step(kind, model, topt, mesh):
    """What each trainer CLI builds under ``--tensor_parallel``."""
    if kind == "nb":
        return nb_vae.make_step(model, topt, mesh=mesh)[0]
    if kind == "vmf":
        return vmf_vae.make_step(model, topt, mesh=mesh)[0]
    return vmfnb_vae.make_step(model, topt, mesh=mesh)[0]


def jax_overrides(kind, m):
    if kind == "vmf":
        loss = lambda p, x, c, k, b: m.tp_step_loss(p, x, c, k, b)  # noqa
        return dict(report_loss_override=loss, boot_loss_override=loss)
    return dict(
        report_loss_override=lambda p, x, c, k, b: m.fused_step_report_tp(
            p, x, c, k, b),
        boot_loss_override=lambda p, x, c, k, b: m.fused_step_boot_tp(
            p, x, c, k, b, need_value=False))


def batch_draws(kind, key, Bl):
    """JAX's in-step draws of one batch key (``_draw_batch``, equal to
    ``_batch_step``'s; tests/test_torch_parallel.py)."""
    fake = types.SimpleNamespace(
        rows=types.SimpleNamespace(R=2, Rn=1, Z=2),
        opt=types.SimpleNamespace(nboot=NBOOT))
    cls = {"nb": JNBFast, "joint": JJointFast, "mixture": JMixFast,
           "vmf": JVMFFast}[kind]
    return _np(cls._draw_batch(fake, key, Bl))


def jax_case(kind, grid):
    """(initial params, draws [data index][batch], the step x_sb, c_sb ->
    reference dict) of JAX's TP Trainer on a (ndata, 2) mesh."""
    (ndata, nmodel), D, interpret = GRIDS[grid]
    jmodel = jax_model(kind, D)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    topt = JOptions(nboot=NBOOT, superbatch=S, seed=0)
    mesh = jmake_mesh(model_parallel=nmodel,
                      devices=jax.devices()[:ndata * nmodel])
    tr = JTrainer(lambda *a: None, lambda *a: None, topt, mesh=mesh,
                  tp_shard_map=True, data_dim=D,
                  tp_param_pspecs=jmodel.tp_pspecs(jparams),
                  **jax_overrides(kind, jmodel))
    ekey = jax.random.fold_in(jax.random.PRNGKey(0), EPOCH)
    Bl = B // ndata
    draws = [[batch_draws(kind, jax.random.fold_in(
        jax.random.fold_in(ekey, b), d), Bl) for b in range(S)]
        for d in range(ndata)]
    p0 = _np(jparams)

    def step(x_sb, c_sb):
        old = jnb_step._INTERPRET
        jnb_step._INTERPRET = interpret
        try:
            st = tr.optimizer.init(jparams)
            p1, st1, reps = tr.step(jparams, st, x_sb[..., :D], c_sb,
                                    EPOCH, np.arange(S))
            return dict(params=_np(p1), mu=_np(st1[1].mu),
                        reps=np.asarray(reps))
        finally:
            jnb_step._INTERPRET = old

    return p0, draws, step


def _start_ranks(tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu", MMVAE_DIST_TIMEOUT="60",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    coord = f"127.0.0.1:{free_port()}"
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         coord, str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


def wait_ranks(start, tmp, attempts=3, timeout=240):
    """Wait for the ranks ``start(tmp)`` began; start them again when the
    coordinator's port was taken in between."""
    procs = start(tmp)
    for attempt in range(attempts):
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
        if all(p.returncode == 0 for p in procs):
            return outs
        if not any("Address already in use" in o or "EADDRINUSE" in o
                   for o in outs) or attempt == attempts - 1:
            raise AssertionError("ranks failed:\n" + "\n---\n".join(
                o[-3000:] for o in outs))
        procs = start(tmp)


def grids(rank, dev):
    """(the (1, 2) grid of this rank's model row, the (2, 2) grid)."""
    g22 = make_mesh(dev, "dp_shard", 2)
    g12 = DataMesh(2, rank % 2, dev, "dp_shard", 2, g22.model_group, None)
    return {"1x2": g12, "2x2": g22}


def _to_np(tree):
    return jax.tree_util.tree_map(lambda a: a.detach().numpy().copy(), tree)


def _worker(rank: int, coord: str, tmp: str) -> None:
    from mmvae_tpu_torch.parallel.multihost import init_multihost

    torch.set_num_threads(1)
    dev = init_multihost(coord, WORLD, rank, torch.device("cpu"))
    meshes = grids(rank, dev)
    with open(os.path.join(tmp, "cases.pkl"), "rb") as f:
        spec = pickle.load(f)
    out = {}
    topt = TrainingOptions(nboot=NBOOT, seed=0)
    for (kind, grid), case in spec["cases"].items():
        mesh = meshes[grid]
        D = GRIDS[grid][1]
        model = port_model(kind, D)
        tr = port_step(kind, model, topt, mesh)
        rows, cols = mesh.rows(B), mesh.local_cols(D)
        params = shard_params(params_from_numpy(case["params"]),
                              tr.tp_pspecs, mesh)
        st = tr.optimizer.init(params)
        reps, local = [], []
        for b in range(S):
            x = torch.from_numpy(spec["x"][b][rows, :D][:, cols].copy())
            c = torch.from_numpy(spec["c"][b][rows])
            params, st, rep = tr.batch_step(
                params, st, x, c, float(EPOCH),
                rand_from_numpy(case["draws"][mesh.data_index][b]),
                mesh=mesh)
            reps.append(float(rep))
            local.append(_to_np(params))
        out[kind, grid] = dict(
            params=_to_np(gather_params(params, tr.tp_pspecs, mesh)),
            mu=_to_np(gather_params(st["mu"], tr.tp_pspecs, mesh)),
            reps=reps, local=local)
    # the runner: this data index's rows of each batch, its features
    for grid, mesh in meshes.items():
        D = GRIDS[grid][1]
        model = port_model("nb", D)
        tr = port_step("nb", model, topt, mesh)
        M = mesh.local_batch(B)
        data = spec["runner_x"][:, :D].reshape(-1, mesh.ndata, M, D)[
            :, mesh.data_index].reshape(-1, D)[:, mesh.local_cols(D)]
        runner = DenseEpochRunner(tr, torch.from_numpy(data.copy()), B,
                                  seed=4, mesh=mesh)
        q = shard_params(params_from_numpy(spec["runner_params"][D]),
                         tr.tp_pspecs, mesh)
        st = tr.optimizer.init(q)
        per_epoch = []
        for epoch in range(2):
            q, st, reps, _ = runner(q, st, epoch)
            per_epoch.append((_to_np(gather_params(q, tr.tp_pspecs, mesh)),
                              reps.numpy().copy()))
        out["runner", grid] = per_epoch
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(5)
    Dmax = max(g[1] for g in GRIDS.values())
    x_sb = rng.poisson(1.2, size=(S, B, Dmax)).astype(np.int16)
    x_sb[:, :2, :4] += 20  # tiles of the mixed lgamma regime
    c_sb = np.ones((S, B, 1), np.float32)
    steps, cases = {}, {}
    for kind, grid in CASES:
        p0, draws, steps[kind, grid] = jax_case(kind, grid)
        cases[kind, grid] = dict(params=p0, draws=draws)
    runner_x = rng.poisson(1.0, size=(4 * B, Dmax)).astype(np.int16)
    runner_params = {g[1]: _np(JNBVAE(data_dim=g[1], covar_dim=1).init(
        jax.random.PRNGKey(2))) for g in GRIDS.values()}
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(dict(x=x_sb, c=c_sb, cases=cases, runner_x=runner_x,
                         runner_params=runner_params), f)
    with ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(wait_ranks, _start_ranks, tmp)
        # JAX's steps meanwhile, one at a time (interpret mode flips a
        # module flag)
        refs = {k: f(x_sb, c_sb) for k, f in steps.items()}
        ranks_done.result()
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return refs, ranks


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def check_against_jax(got, want):
    """The DP file's tolerances (module docstring)."""
    np.testing.assert_allclose(got["reps"], want["reps"], rtol=2e-4)
    mu_g, mu_w = _leaves(got["mu"]), _leaves(want["mu"])
    p_g, p_w = _leaves(got["params"]), _leaves(want["params"])
    assert mu_g.keys() == mu_w.keys() == p_g.keys() == p_w.keys()
    # a module's leaves share one scale: a bias whose rows' contributions
    # cancel to float32 noise (the joint model's one-element ln_kappa
    # bias, ~1e-3 of its weight's moments, where JAX's own TP and
    # non-TP steps differ by 0.3%) is held to its weight's
    module = {}
    for k, w in mu_w.items():
        module[k[0]] = max(module.get(k[0], 0.0), float(np.abs(w).max()))
    for k, w in mu_w.items():
        w = np.asarray(w)
        np.testing.assert_allclose(mu_g[k], w, rtol=3e-3,
                                   atol=1e-3 * module[k[0]], err_msg=str(k))
        scale = np.abs(w).max()
        big = np.abs(w) >= 0.02 * scale
        np.testing.assert_allclose(p_g[k][big], np.asarray(p_w[k])[big],
                                   rtol=3e-3, atol=1e-4, err_msg=str(k))


@pytest.mark.parametrize("kind,grid", CASES)
def test_tp_step_matches_jax(result, kind, grid):
    refs, ranks = result
    for r in range(WORLD):
        check_against_jax(ranks[r][kind, grid], refs[kind, grid])


@pytest.mark.parametrize("kind,grid", CASES)
def test_tp_replicated_leaves_equal_and_runs_repeat(result, kind, grid):
    """Every rank of a grid gathers the same bits, and holds the same
    replicated leaves after every step; the two (1, 2) grids (ranks 0, 1
    and 2, 3) are two runs of the same work: the same bits."""
    _, ranks = result
    D = GRIDS[grid][1]
    specs = port_model(kind, D).tp_pspecs(
        port_model(kind, D).init(torch.Generator().manual_seed(0)))
    split = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda s: s is not None, specs,
                               is_leaf=lambda s: s is None))
    for r in range(1, WORLD):
        for a, b in zip(jax.tree_util.tree_leaves(ranks[0][kind, grid]
                                                  ["params"]),
                        jax.tree_util.tree_leaves(ranks[r][kind, grid]
                                                  ["params"])):
            assert np.array_equal(a, b)
        for s in range(S):
            la = jax.tree_util.tree_leaves(ranks[0][kind, grid]["local"][s])
            lb = jax.tree_util.tree_leaves(ranks[r][kind, grid]["local"][s])
            same_shard = grid == "1x2" and r == 2
            for a, b, sp in zip(la, lb, split):
                if not sp or same_shard:
                    assert np.array_equal(a, b), (r, s)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_tp_runner_ranks_equal_and_repeat(result, grid):
    _, ranks = result
    for epoch in range(2):
        q0, reps0 = ranks[0]["runner", grid][epoch]
        assert np.isfinite(reps0).all()
        for r in range(1, WORLD):
            q, reps = ranks[r]["runner", grid][epoch]
            assert np.array_equal(reps, reps0)
            for a, b in zip(jax.tree_util.tree_leaves(q),
                            jax.tree_util.tree_leaves(q0)):
                assert np.array_equal(a, b), (r, epoch)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
