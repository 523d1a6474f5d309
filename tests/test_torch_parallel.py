"""The port's data-parallel steps (mmvae_tpu_torch/parallel, the packed
steps' and the generic ``Trainer``'s ``batch_step(mesh=...)``) against the
JAX package's, on two gloo ranks.

Five steps, each in both modes: the NB, joint, mixture and vMF packed
steps and the generic step at ``--mean_encoding 8``.  For ``--dp_shard``
JAX runs its ``Trainer`` under a mesh of 2 of conftest's 8 CPU devices
with ``dp_shard_map=True`` (the ``shard_map`` step, per-shard draws,
pmean'd gradients); for ``--data_parallel`` it runs with no mesh at all
(its SPMD partitioner gives the single-device trajectory) and global
draws.
The per-shard draws come out of ``shard_map`` with ``rand_pspecs``
(``mmvae_tpu/ops/nb_fast.py:265``; the generic step's from ``_draw_batch``
with the shard index folded in, as its ``_batch_step`` folds it).  The
port runs two processes (this file as a script, ``--worker``) that meet
through ``parallel.multihost.init_multihost`` on gloo; each is fed its
rows of the batches and of those draws (under ``--data_parallel`` the
global draws) and takes S = 2 batch steps of nboot = 2.

Tolerances, the packed step's JAX suite yardstick (tests/test_nb_fast.py,
tests/test_vmfnb_fast.py): reports ``rtol=2e-4``; Adam's first moments
``rtol=3e-3`` with an ``atol`` of 1e-3 of the leaf's largest; parameters
``rtol=3e-3, atol=1e-4`` where the first moment is at least 2% of its
leaf's largest (Adam's first steps map each gradient element to about
+-lr by its sign, so an element whose gradient is float32 noise may step
either way; those rest on the moment check).  The lgamma regime of a
64-column tile is chosen over the rows a rank sees, which JAX's
``shard_map`` does too, so a rank's values agree within the regimes'
tolerance, not bitwise.

Every rank's parameters are bitwise equal after each epoch, and a run
repeated gives the same bits (``DenseEpochRunner`` over 2 epochs in both
modes, the port's own draws); ``--data_parallel`` through the runner is
held to the single-process runner at ``rtol=1e-4``.
"""

import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.models.nb import NBVAE as JNBVAE
from mmvae_tpu.models.vmf import VMFVAE as JVMFVAE
from mmvae_tpu.models.vmfnb import VMFNBVAE as JVMFNBVAE
from mmvae_tpu.models.vmfnb_mixture import VMFNBMixtureVAE as JMixVAE
from mmvae_tpu.ops.nb_fast import NBFastStep as JNBFast
from mmvae_tpu.ops.vmf_fast import VMFFastStep as JVMFFast
from mmvae_tpu.ops.vmfnb_fast import VMFNBFastStep as JJointFast
from mmvae_tpu.ops.vmfnb_fast import VMFNBMixtureFastStep as JMixFast
from mmvae_tpu.parallel.mesh import make_mesh
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import Trainer as JTrainer
from mmvae_tpu_torch.cli import nb_vae
from mmvae_tpu_torch.models.nb import NBVAE, params_from_numpy
from mmvae_tpu_torch.models.vmf import VMFVAE
from mmvae_tpu_torch.models.vmfnb import VMFNBVAE
from mmvae_tpu_torch.models.vmfnb_mixture import VMFNBMixtureVAE
from mmvae_tpu_torch.ops.nb_fast import NBFastStep, rand_from_numpy
from mmvae_tpu_torch.ops.vmf_fast import VMFFastStep
from mmvae_tpu_torch.ops.vmfnb_fast import (VMFNBFastStep,
                                            VMFNBMixtureFastStep)
from mmvae_tpu_torch.parallel.mesh import DataMesh
from mmvae_tpu_torch.train.config import TrainingOptions
from mmvae_tpu_torch.train.loop import DenseEpochRunner
from tests.test_torch_multihost import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, B, S, NBOOT, WORLD, K = 96, 8, 2, 2, 2, 3
M = B // WORLD
EPOCH = 3  # a KL weight away from its floor
CASES = [(kind, mode) for mode in ("dp_shard", "data_parallel")
         for kind in ("nb", "joint", "mixture", "vmf", "generic")]


def _label():
    rng = np.random.default_rng(11)
    L = (rng.random((D, K)) < 0.25).astype(np.float32)
    L[:K] = np.eye(K, dtype=np.float32)
    return L


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_parts(kind):
    """(JAX model, JAX packed step or None, JAX Trainer kwargs)."""
    topt = JOptions(nboot=NBOOT, superbatch=S, seed=0)
    if kind == "generic":
        m = JNBVAE(data_dim=D, covar_dim=1, mean_encoding=(8,))
        return m, None, dict(
            report_loss_override=lambda p, x, c, k, b: m.fused_step_report(
                p, x, c, k, b, include_data_const=True),
            boot_loss_override=lambda p, x, c, k, b: m.fused_step_boot(
                p, x, c, k, b, need_value=False))
    m, cls = {"nb": (JNBVAE(data_dim=D, covar_dim=1), JNBFast),
              "joint": (JVMFNBVAE(data_dim=D), JJointFast),
              "mixture": (JMixVAE(label=_label()), JMixFast),
              "vmf": (JVMFVAE(data_dim=D, covar_dim=1), JVMFFast)}[kind]
    return m, cls(m, topt), {}


def port_step(kind):
    """The port's step of a case (what its CLI builds)."""
    topt = TrainingOptions(nboot=NBOOT, seed=0)
    if kind == "generic":
        return nb_vae.make_step(NBVAE(data_dim=D, mean_encoding=(8,)),
                                topt)[0]
    return {"nb": lambda: NBFastStep(NBVAE(data_dim=D), topt),
            "joint": lambda: VMFNBFastStep(VMFNBVAE(data_dim=D), topt),
            "mixture": lambda: VMFNBMixtureFastStep(
                VMFNBMixtureVAE(label=_label()), topt),
            "vmf": lambda: VMFFastStep(VMFVAE(data_dim=D, covar_dim=1),
                                       topt)}[kind]()


def _draws_generic(key, b, d, Bl):
    """The generic ``_batch_step``'s draws of shard ``d`` of batch ``b``
    (``d`` None: the single-device step's): ``_draw_batch`` of its key
    chain (tests/test_torch_generic_step.py)."""
    import types

    fake = types.SimpleNamespace(rows=types.SimpleNamespace(R=2, Rn=1),
                                 opt=types.SimpleNamespace(nboot=NBOOT))
    k = jax.random.fold_in(key, b)
    if d is not None:
        k = jax.random.fold_in(k, d)
    return _np(JNBFast._draw_batch(fake, k, Bl))


def _shard_draws(jfast, mesh, ekey):
    """Per-shard draws out of ``shard_map`` with ``rand_pspecs`` (as
    ``make_ondevice_epoch_dp`` draws them): rank d's rows are its slice
    of each leaf's row axis."""
    from jax.sharding import PartitionSpec as P

    draw = jax.jit(jax.shard_map(
        lambda: jfast.draw_rand(ekey, jnp.arange(S, dtype=jnp.int32), M,
                                axis_name="data"),
        mesh=mesh, in_specs=(), out_specs=jfast.rand_pspecs(P, "data"),
        check_vma=False))
    rand = _np(draw())

    def rank(d, b):
        sl = slice(d * M, (d + 1) * M)
        return {"rep_eps": tuple(e[b, sl] for e in rand["rep_eps"]),
                "ridx": rand["ridx"][b][:, sl],
                "boot_eps": tuple(e[b][:, sl] for e in rand["boot_eps"])}

    return [[rank(d, b) for b in range(S)] for d in range(WORLD)]


def _jax_case(kind, mode):
    """JAX's set-up of a case: (initial params, per-rank draws
    [rank][batch], the step: x_sb, c_sb -> (final params, Adam first
    moments, reports))."""
    jmodel, jfast, kw = _jax_parts(kind)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    topt = JOptions(nboot=NBOOT, superbatch=S, seed=0)
    ekey = jax.random.fold_in(jax.random.PRNGKey(0), EPOCH)
    if mode == "dp_shard":
        mesh = make_mesh(devices=jax.devices()[:WORLD])
        tr = JTrainer(lambda *a: None, lambda *a: None, topt, mesh=mesh,
                      dp_shard_map=True, fast_step=jfast, **kw)
        draws = (_shard_draws(jfast, mesh, ekey) if jfast is not None else
                 [[_draws_generic(ekey, b, d, M) for b in range(S)]
                  for d in range(WORLD)])
    else:
        tr = JTrainer(lambda *a: None, lambda *a: None, topt,
                      fast_step=jfast, **kw)
        if jfast is not None:
            glob = _np(jfast.draw_rand(ekey, jnp.arange(S, dtype=jnp.int32),
                                       B))
            glob = [jax.tree_util.tree_map(lambda a: a[b], glob)
                    for b in range(S)]
        else:
            glob = [_draws_generic(ekey, b, None, B) for b in range(S)]
        draws = [glob] * WORLD
    p0 = _np(jparams)  # the step donates its arguments

    def step(x_sb, c_sb):
        st = tr.optimizer.init(jparams)
        p1, st1, reps = tr.step(jparams, st, x_sb, c_sb, EPOCH,
                                np.arange(S))
        return dict(params=_np(p1), mu=_np(st1[2].mu),
                    reps=np.asarray(reps))

    return p0, draws, step


def _start_ranks(tmp):
    """This file as ``--worker`` on WORLD gloo ranks, started."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", MMVAE_DIST_TIMEOUT="60",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    coord = f"127.0.0.1:{free_port()}"
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         coord, str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


def _wait_ranks(procs, tmp, attempts=3):
    """Wait for the ranks (120 s each); start them again when the
    coordinator's port was taken in between."""
    for attempt in range(attempts):
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=120)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
        if all(p.returncode == 0 for p in procs):
            return outs
        if not any("Address already in use" in o or "EADDRINUSE" in o
                   for o in outs) or attempt == attempts - 1:
            raise AssertionError("ranks failed:\n" + "\n---\n".join(
                o[-3000:] for o in outs))
        procs = _start_ranks(tmp)


def _worker(rank: int, coord: str, tmp: str) -> None:
    """One rank: every case's S batch steps, then 2 epochs of the runner
    in each mode, twice."""
    from mmvae_tpu_torch.parallel.multihost import init_multihost

    torch.set_num_threads(1)
    dev = init_multihost(coord, WORLD, rank, torch.device("cpu"))
    calls = [0]

    def counted(fn):
        def wrap(*a, **kw):
            calls[0] += 1
            return fn(*a, **kw)
        return wrap

    # the step's collectives, counted (parallel.collectives calls these)
    torch.distributed.all_reduce = counted(torch.distributed.all_reduce)
    torch.distributed.all_gather = counted(torch.distributed.all_gather)
    with open(os.path.join(tmp, "cases.pkl"), "rb") as f:
        spec = pickle.load(f)
    out = {}
    rows = slice(rank * M, (rank + 1) * M)
    for (kind, mode), case in spec["cases"].items():
        fast = port_step(kind)
        mesh = DataMesh(WORLD, rank, dev, mode)
        q = fast.pack(params_from_numpy(case["params"]))
        st = fast.optimizer.init(q)
        reps = []
        calls[0] = 0
        for b in range(S):
            x = torch.from_numpy(spec["x"][b][rows])
            c = torch.from_numpy(spec["c"][b][rows])
            q, st, rep = fast.batch_step(
                q, st, x, c, float(EPOCH),
                rand_from_numpy(case["draws"][rank][b]), mesh=mesh)
            reps.append(float(rep))
        to_np = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: a.detach().numpy(), t)
        out[kind, mode] = dict(params=to_np(fast.unpack(q)),
                               mu=to_np(fast.unpack(st["mu"])), reps=reps,
                               calls=calls[0])
    # the runner: this rank's rows of each batch, batch after batch
    data = spec["runner_x"].reshape(-1, WORLD, M, D)[:, rank].reshape(-1, D)
    for mode in ("data_parallel", "dp_shard"):
        for run in range(2):
            fast = port_step("nb")
            mesh = DataMesh(WORLD, rank, dev, mode)
            runner = DenseEpochRunner(fast, torch.from_numpy(data), B,
                                      seed=4, mesh=mesh)
            q = fast.pack(params_from_numpy(spec["runner_params"]))
            st = fast.optimizer.init(q)
            per_epoch = []
            for epoch in range(2):
                q, st, reps, _ = runner(q, st, epoch)
                per_epoch.append((
                    {k: v.numpy().copy() for k, v in q.items()},
                    reps.numpy().copy()))
            out["runner", mode, run] = per_epoch
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(5)
    x_sb = rng.poisson(1.2, size=(S, B, D)).astype(np.int16)
    x_sb[:, :2, :4] += 20  # tiles of the mixed lgamma regime
    c_sb = np.ones((S, B, 1), np.float32)
    steps, cases = {}, {}
    for kind, mode in CASES:
        p0, draws, steps[kind, mode] = _jax_case(kind, mode)
        cases[kind, mode] = dict(params=p0, draws=draws)
    runner_x = rng.poisson(1.0, size=(5 * B, D)).astype(np.int16)
    runner_params = _np(JNBVAE(data_dim=D, covar_dim=1).init(
        jax.random.PRNGKey(2)))
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(dict(x=x_sb, c=c_sb, cases=cases, runner_x=runner_x,
                         runner_params=runner_params), f)
    procs = _start_ranks(tmp)
    # JAX compiles its steps while the ranks run, several at a time (XLA
    # compiles without the GIL)
    with ThreadPoolExecutor(4) as pool:
        refs = dict(zip(steps, pool.map(lambda f: f(x_sb, c_sb),
                                        steps.values())))
    _wait_ranks(procs, tmp)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    # the single-process runner on the same data and seed
    fast = port_step("nb")
    runner = DenseEpochRunner(fast, torch.from_numpy(runner_x), B, seed=4)
    q = fast.pack(params_from_numpy(runner_params))
    st = fast.optimizer.init(q)
    single = []
    for epoch in range(2):
        q, st, reps, _ = runner(q, st, epoch)
        single.append(({k: v.numpy().copy() for k, v in q.items()},
                       reps.numpy().copy()))
    return refs, ranks, single


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


@pytest.mark.parametrize("kind,mode", CASES)
def test_dp_step_matches_jax(result, kind, mode):
    refs, ranks, _ = result
    want = refs[kind, mode]
    for r in range(WORLD):
        got = ranks[r][kind, mode]
        np.testing.assert_allclose(got["reps"], want["reps"], rtol=2e-4)
        mu_g, mu_w = _leaves(got["mu"]), _leaves(want["mu"])
        p_g, p_w = _leaves(got["params"]), _leaves(want["params"])
        assert mu_g.keys() == mu_w.keys() == p_g.keys() == p_w.keys()
        for k, w in mu_w.items():
            w = np.asarray(w)
            scale = np.abs(w).max()
            np.testing.assert_allclose(mu_g[k], w, rtol=3e-3,
                                       atol=1e-3 * scale, err_msg=str(k))
            big = np.abs(w) >= 0.02 * scale
            np.testing.assert_allclose(p_g[k][big], np.asarray(p_w[k])[big],
                                       rtol=3e-3, atol=1e-4, err_msg=str(k))
    # one collective a boot step (the report rides the first), and under
    # --data_parallel one gather of the batch a step
    assert ranks[0][kind, mode]["calls"] == S * (
        NBOOT + (mode == "data_parallel"))
    # the ranks' reductions are the same additions: bitwise equal
    for a, b in zip(jax.tree_util.tree_leaves(ranks[0][kind, mode]),
                    jax.tree_util.tree_leaves(ranks[1][kind, mode])):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("mode", ["data_parallel", "dp_shard"])
def test_ranks_equal_after_each_epoch_and_runs_repeat(result, mode):
    _, ranks, _ = result
    for epoch in range(2):
        base_q, base_reps = ranks[0]["runner", mode, 0][epoch]
        for r in range(WORLD):
            for run in range(2):
                q, reps = ranks[r]["runner", mode, run][epoch]
                assert np.array_equal(reps, base_reps)
                for k in base_q:
                    assert np.array_equal(q[k], base_q[k]), (r, run, k)


def test_data_parallel_runner_matches_single_process(result):
    _, ranks, single = result
    for epoch in range(2):
        q, reps = ranks[0]["runner", "data_parallel", 0][epoch]
        sq, sreps = single[epoch]
        np.testing.assert_allclose(reps, sreps, rtol=1e-4)
        for k in sq:
            np.testing.assert_allclose(q[k], sq[k], rtol=1e-4,
                                       atol=1e-4 * np.abs(sq[k]).max())


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
