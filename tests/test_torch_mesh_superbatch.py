"""The port's superbatch step under a mesh (``train/superbatch.py`` with a
``DataMesh``, ``DenseEpochRunner(mesh=..., superbatch=S)``, ``Trainer.step``
/ ``step_record(mesh=...)``) on two gloo ranks on the CPU, where the
superbatch body runs eagerly with its collectives (on a card it is one
CUDA graph with NCCL inside, or a chain of segment graphs around the gloo
collectives: ``chip_smoke.py`` phase 44).

Two processes of this file (``--worker``) meet once for the module; they
hold ``--dp_shard`` and ``--data_parallel`` meshes of two ranks and a
``--tensor_parallel 2`` grid (one model row) over the same processes.

- The runner at S = 3 (7 batches an epoch: superbatches of 3, 3 and 1)
  against its per-batch path (``superbatch=None``) on the same draws, 2
  epochs, the second recording: reports, parameters, Adam state and
  record outputs bitwise equal.  Under both data-parallel modes the NB,
  joint, mixture and vMF packed steps and the generic step (a hidden
  encoder, and ``--no_fused_step``); under tensor parallelism the four
  models' TP ``Trainer`` with their TP record encoders; the
  dense-resident tier, and host streaming for the NB step in each mesh.
  Both ranks end with the same bits.
- ``Trainer.step`` then ``step_record`` under a mesh, an S = 3
  superbatch each, against JAX's ``shard_map`` superbatch step
  (``Trainer(mesh=..., dp_shard_map=True)``, and ``tp_shard_map=True``
  with ``tp_record_encode``) on conftest's CPU devices, JAX's in-step
  draws injected.  Tolerances, tests/test_torch_parallel.py's: reports
  ``rtol=2e-4``; Adam's first moments ``rtol=3e-3`` with an ``atol`` of
  1e-3 of the leaf's largest; parameters ``rtol=3e-3, atol=1e-4`` where
  the first moment is at least 2% of its leaf's largest; posteriors
  ``rtol=3e-3, atol=2e-5`` (tests/test_torch_superbatch.py's); the Adam
  count equal.
- ``Trainer.step`` walking an epoch in 3 + 3 + 1 batches from its own
  draws (``nbatch=``) equals the per-batch runner bitwise in each mesh.
- ``can_step_record`` under tensor parallelism, and the capture-form rule.
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

from mmvae_tpu.io.writers import write_matrix_market_file
from mmvae_tpu.models.nb import NBVAE as JNBVAE
from mmvae_tpu.ops.nb_fast import NBFastStep as JNBFast
from mmvae_tpu.parallel.mesh import make_mesh as jmake_mesh
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import Trainer as JTrainer
from mmvae_tpu_torch.cli import nb_vae, vmf_vae, vmfnb_vae
from mmvae_tpu_torch.data.block import MtxDataBlock, create_ones_like
from mmvae_tpu_torch.io.index import build_mmutil_index
from mmvae_tpu_torch.models.nb import NBVAE, params_from_numpy
from mmvae_tpu_torch.models.vmf import VMFVAE
from mmvae_tpu_torch.models.vmfnb import VMFNBVAE
from mmvae_tpu_torch.models.vmfnb_mixture import VMFNBMixtureVAE
from mmvae_tpu_torch.ops.nb_fast import NBFastStep, rand_from_numpy
from mmvae_tpu_torch.ops.vmf_fast import VMFFastStep
from mmvae_tpu_torch.ops.vmfnb_fast import (VMFNBFastStep,
                                            VMFNBMixtureFastStep)
from mmvae_tpu_torch.parallel.collectives import FORMS, capture_form
from mmvae_tpu_torch.parallel.mesh import (DataMesh, gather_params,
                                           make_mesh, shard_params)
from mmvae_tpu_torch.parallel.multihost import sharded_batches
from mmvae_tpu_torch.train.config import TrainingOptions
from mmvae_tpu_torch.train.loop import DenseEpochRunner, StreamedBatches
from tests.test_torch_multihost import free_port
from tests.test_torch_tp_train import jax_overrides, label, wait_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, B, WORLD, NBOOT, SB, K = 96, 8, 2, 2, 3, 3
M = B // WORLD
NBATCH = 7  # an epoch: superbatches of 3, 3 and 1
N = NBATCH * B
EPOCH = 3  # Trainer.step's: a KL weight away from its floor
DP_KINDS = ("nb", "joint", "mixture", "vmf", "generic", "no_fused_step")
TP_KINDS = ("nb", "joint", "mixture", "vmf")
RUNNER_CASES = ([(k, m, "dense") for m in ("dp_shard", "data_parallel")
                 for k in DP_KINDS]
                + [(k, "tp", "dense") for k in TP_KINDS]
                + [("nb", m, "stream") for m in ("dp_shard", "data_parallel",
                                                 "tp")])
MESHES = ("dp_shard", "data_parallel", "tp")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_np(tree):
    return jax.tree_util.tree_map(
        lambda a: a.detach().numpy().copy() if isinstance(a, torch.Tensor)
        else a, tree)


def port_route(kind, mesh):
    """(model, step) of a case: under tensor parallelism what each
    trainer CLI builds; else the packed step, or ``nb_vae``'s generic
    step with a hidden encoder or ``--no_fused_step``."""
    topt = TrainingOptions(nboot=NBOOT, seed=4)
    if mesh.tp:
        model = {"nb": lambda: NBVAE(data_dim=D),
                 "joint": lambda: VMFNBVAE(data_dim=D),
                 "mixture": lambda: VMFNBMixtureVAE(label=label(D)),
                 "vmf": lambda: VMFVAE(data_dim=D, covar_dim=1,
                                       encoding=(8,), do_relu=True)}[kind]()
        cli = {"nb": nb_vae, "vmf": vmf_vae}.get(kind, vmfnb_vae)
        return model, cli.make_step(model, topt, mesh=mesh)[0]
    if kind == "generic":
        model = NBVAE(data_dim=D, mean_encoding=(8,))
        return model, nb_vae.make_step(model, topt)[0]
    if kind == "no_fused_step":
        model = NBVAE(data_dim=D)
        return model, nb_vae.make_step(model, TrainingOptions(
            nboot=NBOOT, seed=4, fused_step=False))[0]
    model, cls = {"nb": (NBVAE(data_dim=D), NBFastStep),
                  "joint": (VMFNBVAE(data_dim=D), VMFNBFastStep),
                  "mixture": (VMFNBMixtureVAE(label=label(D)),
                              VMFNBMixtureFastStep),
                  "vmf": (VMFVAE(data_dim=D, covar_dim=1),
                          VMFFastStep)}[kind]
    return model, cls(model, topt)


def _record_fn(model, fast, mesh):
    """The recorder's encode of a rank (``cli.common.run_training``'s)."""
    if mesh.tp:
        enc = fast.tp_record_encode
    else:
        enc = model.record_encoder(4, B, rows=mesh.rows(B))[0]

    def record(p, x):
        with torch.no_grad():
            return enc(p, x)
    return record


def _local(x, mesh):
    """A rank's rows of each batch of the (N, D) counts (and its
    features under tensor parallelism)."""
    rows = x.reshape(-1, mesh.ndata, mesh.local_batch(B), D)[
        :, mesh.data_index].reshape(-1, D)
    return np.ascontiguousarray(rows[:, mesh.local_cols(D)] if mesh.tp
                                else rows)


def _epoch(fast, q, po, reps, enc, mesh):
    full = fast.unpack(q)
    st = fast.unpack_opt_state(po)
    if mesh.tp:
        full = gather_params(full, fast.tp_pspecs, mesh)
        st = dict(st, mu=gather_params(st["mu"], fast.tp_pspecs, mesh),
                  nu=gather_params(st["nu"], fast.tp_pspecs, mesh))
    return dict(q=_to_np(full), po=_to_np(st), reps=_to_np(reps),
                enc=None if enc is None else _to_np(enc))


def runner_case(kind, mesh, tier, spec):
    """Both paths of a case: {S: [epoch 0, epoch 1 (recording)]}."""
    model, fast = port_route(kind, mesh)
    if tier == "dense":
        source = torch.from_numpy(_local(spec["x"], mesh))
    else:
        Ml = mesh.local_batch(B)
        source = StreamedBatches(
            MtxDataBlock(spec["mtx"], spec["mtx"] + ".index", Ml),
            MtxDataBlock(spec["ones"], spec["ones"] + ".index", Ml), Ml,
            "cpu", sharded_batches(N, B, mesh.data_index, mesh.ndata),
            mesh.local_cols(D) if mesh.tp else None)
    params = model.init(torch.Generator().manual_seed(0))
    if mesh.tp:
        params = shard_params(params, fast.tp_pspecs, mesh)
    out = {}
    for S in (None, SB):
        runner = DenseEpochRunner(fast, source, B, seed=4, mesh=mesh,
                                  record_fn=_record_fn(model, fast, mesh),
                                  superbatch=S)
        q = fast.pack(params)
        po = fast.optimizer.init(q)
        out[S] = []
        for epoch in range(2):
            q, po, reps, enc = runner(q, po, epoch, record=epoch == 1)
            out[S].append(_epoch(fast, q, po, reps, enc, mesh))
        runner.close()
    return out


def trainer_epoch(mesh, x):
    """The NB generic step (TP: the TP trainer) over one epoch: the
    per-batch runner, and ``Trainer.step`` in 3 + 3 + 1 batches from its
    own draws (``nbatch=``)."""
    _, tr = port_route("nb" if mesh.tp else "generic", mesh)
    model = (NBVAE(data_dim=D) if mesh.tp
             else NBVAE(data_dim=D, mean_encoding=(8,)))
    params = model.init(torch.Generator().manual_seed(1))
    if mesh.tp:
        params = shard_params(params, tr.tp_pspecs, mesh)
    local = _local(x, mesh)
    runner = DenseEpochRunner(tr, torch.from_numpy(local), B, seed=4,
                              mesh=mesh, superbatch=None)
    st0 = tr.optimizer.init(params)
    q, po, reps, _ = runner(params, st0, 2)
    want = _epoch(tr, q, po, reps, None, mesh)
    Ml = mesh.local_batch(B)
    xs = local.reshape(NBATCH, Ml, -1)
    c = np.ones((NBATCH, Ml, 1), np.float32)
    p, st, got = params, st0, []
    for lo in range(0, NBATCH, SB):
        ids = np.arange(lo, min(lo + SB, NBATCH))
        p, st, r = tr.step(p, st, xs[ids], c[ids], 2, ids, nbatch=NBATCH,
                           mesh=mesh)
        got.append(r)
    return want, _epoch(tr, p, st, torch.cat(got), None, mesh)


def step_vs_jax(mesh, spec):
    """``Trainer.step`` on batches 0-2 then ``step_record`` on 3-5 of
    epoch EPOCH from JAX's initial parameters and in-step draws."""
    case = spec["jax"]["tp" if mesh.tp else "dp_shard"]
    model = NBVAE(data_dim=D) if mesh.tp else NBVAE(data_dim=D,
                                                    mean_encoding=(8,))
    _, tr = port_route("nb" if mesh.tp else "generic", mesh)
    params = params_from_numpy(case["params"])
    if mesh.tp:
        params = shard_params(params, tr.tp_pspecs, mesh)
    rows = mesh.rows(B)
    sx = spec["sx"][:, rows]
    if mesh.tp:
        sx = sx[..., mesh.local_cols(D)]
    sx = np.ascontiguousarray(sx)
    sc = np.ones((2 * SB, mesh.local_batch(B), 1), np.float32)
    draws = case["draws"][mesh.data_index]
    rand = [rand_from_numpy(jax.tree_util.tree_map(
        lambda *a: np.stack(a), *draws[lo:lo + SB])) for lo in (0, SB)]
    ids_a, ids_b = np.arange(SB), np.arange(SB, 2 * SB)
    p, st, rep = tr.step(params, tr.optimizer.init(params), sx[:SB],
                         sc[:SB], EPOCH, ids_a, rand=rand[0], mesh=mesh)
    p, st, (rep2, enc, extra) = tr.step_record(
        p, st, sx[SB:], sc[SB:], EPOCH, ids_b, model.encode_mu,
        rand=rand[1], mesh=mesh)
    out = _epoch(tr, p, st, torch.cat([rep, rep2]), enc, mesh)
    out["extra"] = _to_np(extra)
    out["count"] = int(st["count"])
    return out


def _worker(rank: int, coord: str, tmp: str) -> None:
    from mmvae_tpu_torch.parallel.multihost import init_multihost

    torch.set_num_threads(1)
    dev = init_multihost(coord, WORLD, rank, torch.device("cpu"))
    meshes = {"tp": make_mesh(dev, "dp_shard", 2),
              **{m: DataMesh(WORLD, rank, dev, m)
                 for m in ("dp_shard", "data_parallel")}}
    with open(os.path.join(tmp, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    out = {}
    for kind, mode, tier in RUNNER_CASES:
        out["runner", kind, mode, tier] = runner_case(kind, meshes[mode],
                                                      tier, spec)
    for mode in MESHES:
        out["epoch", mode] = trainer_epoch(meshes[mode], spec["x"])
    for mode in ("dp_shard", "tp"):
        out["jax", mode] = step_vs_jax(meshes[mode], spec)
    tp = meshes["tp"]
    out["can"] = {kind: (port_route(kind, tp)[1].can_step_record(),
                         port_route(kind, tp)[1].can_step_record(True))
                  for kind in TP_KINDS}
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _start_ranks(tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu", MMVAE_DIST_TIMEOUT="60",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    coord = f"127.0.0.1:{free_port()}"
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         coord, str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


def jax_case(mode, sx, sc):
    """(spec entry, reference thunk) of JAX's mesh Trainer: the generic
    NB step (a hidden encoder) under ``dp_shard_map``, or the TP step
    with its record encoder, on conftest's first two devices."""
    topt = JOptions(nboot=NBOOT, superbatch=SB, seed=4)
    if mode == "tp":
        jm = JNBVAE(data_dim=D, covar_dim=1)
        jparams = jm.init(jax.random.PRNGKey(1))
        tr = JTrainer(lambda *a: None, lambda *a: None, topt,
                      mesh=jmake_mesh(model_parallel=2,
                                      devices=jax.devices()[:2]),
                      tp_shard_map=True, data_dim=D,
                      tp_param_pspecs=jm.tp_pspecs(jparams),
                      tp_record_encode=lambda p, x: jm.tp_encode_mu(
                          p, x, None, "model"),
                      **jax_overrides("nb", jm))
        ndata, Bl, adam = 1, B, 1
    else:
        jm = JNBVAE(data_dim=D, covar_dim=1, mean_encoding=(8,))
        jparams = jm.init(jax.random.PRNGKey(1))
        tr = JTrainer(
            lambda *a: None, lambda *a: None, topt,
            mesh=jmake_mesh(devices=jax.devices()[:2]), dp_shard_map=True,
            report_loss_override=lambda p, x, c, k, b: jm.fused_step_report(
                p, x, c, k, b, include_data_const=True),
            boot_loss_override=lambda p, x, c, k, b: jm.fused_step_boot(
                p, x, c, k, b, need_value=False))
        ndata, Bl, adam = WORLD, M, 2
    ekey = jax.random.fold_in(jax.random.PRNGKey(4), EPOCH)
    fake = types.SimpleNamespace(rows=types.SimpleNamespace(R=2, Rn=1),
                                 opt=types.SimpleNamespace(nboot=NBOOT))
    draws = [[_np(JNBFast._draw_batch(fake, jax.random.fold_in(
        jax.random.fold_in(ekey, b), d), Bl)) for b in range(2 * SB)]
        for d in range(ndata)]
    p0 = _np(jparams)

    def run():
        st = tr.optimizer.init(jparams)
        p, st, r1 = tr.step(jparams, st, sx[:SB], sc[:SB], EPOCH,
                            np.arange(SB))
        p, st, (r2, enc, extra) = tr.step_record(
            p, st, sx[SB:], sc[SB:], EPOCH, np.arange(SB, 2 * SB),
            lambda pp, x: jm.encode_mu(pp, x))
        return dict(q=_np(p), mu=_np(st[adam].mu),
                    count=int(st[adam].count),
                    reps=np.concatenate([np.asarray(r1), np.asarray(r2)]),
                    enc=_np(enc), extra=np.asarray(extra))

    return dict(params=p0, draws=draws), run


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("msb")
    rng = np.random.default_rng(9)
    x = rng.poisson(1.1, size=(N, D)).astype(np.int16)
    x[:, 0] += 1  # no empty cell
    x[::5, :4] += 20  # tiles of the mixed lgamma regime
    rr, cc = np.nonzero(x.T)
    mtx = str(tmp / "m.mtx.gz")
    write_matrix_market_file(mtx, rr, cc, x.T[rr, cc].astype(np.float32),
                             (D, N))
    build_mmutil_index(mtx, mtx + ".index")
    ones = str(tmp / "ones.mtx.gz")
    create_ones_like(MtxDataBlock(mtx, mtx + ".index", B), ones)
    build_mmutil_index(ones, ones + ".index")
    sx = rng.poisson(1.2, size=(2 * SB, B, D)).astype(np.int16)
    sx[:, :2, :4] += 20
    sc = np.ones((2 * SB, B, 1), np.float32)
    refs, jax_spec = {}, {}
    for mode in ("dp_shard", "tp"):
        jax_spec[mode], refs[mode] = jax_case(mode, sx, sc)
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(dict(x=x, mtx=mtx, ones=ones, sx=sx, jax=jax_spec), f)
    with ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(wait_ranks, _start_ranks, tmp)
        want = {mode: run() for mode, run in refs.items()}
        ranks_done.result()
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return want, ranks


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _bitwise(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys(), what
    for k in w:
        assert np.array_equal(g[k], w[k]), (what, k)


@pytest.mark.parametrize("kind,mode,tier", RUNNER_CASES)
def test_runner_superbatches_equal_per_batch(result, kind, mode, tier):
    """S = 3 against ``superbatch=None``, both ranks, every epoch:
    reports, parameters, Adam state and record outputs bitwise; the
    ranks hold the same parameters and reports."""
    _, ranks = result
    for r, rk in enumerate(ranks):
        case = rk["runner", kind, mode, tier]
        for e, (got, want) in enumerate(zip(case[SB], case[None])):
            _bitwise(got, want, (r, e))
            if e == 1:
                assert got["enc"] is not None and len(got["enc"]) == (
                    3 if kind == "mixture" else 2)
                assert got["enc"][0].shape[:2] == (NBATCH, M if mode != "tp"
                                                   else B)
    for e in range(2):
        a = {k: ranks[0]["runner", kind, mode, tier][SB][e][k]
             for k in ("q", "reps")}
        b = {k: ranks[1]["runner", kind, mode, tier][SB][e][k]
             for k in ("q", "reps")}
        _bitwise(a, b, ("ranks", e))


@pytest.mark.parametrize("mode", MESHES)
def test_trainer_step_walks_an_epoch_as_the_runner(result, mode):
    _, ranks = result
    for rk in ranks:
        want, got = rk["epoch", mode]
        _bitwise(got, want, mode)


@pytest.mark.parametrize("mode", ["dp_shard", "tp"])
def test_trainer_step_and_step_record_match_jax(result, mode):
    """The port's ``Trainer.step`` / ``step_record(mesh=...)`` against
    JAX's ``shard_map`` superbatch step (module docstring's
    tolerances)."""
    want, ranks = result
    w = want[mode]
    for r, rk in enumerate(ranks):
        got = rk["jax", mode]
        np.testing.assert_allclose(got["reps"], w["reps"], rtol=2e-4)
        assert got["count"] == w["count"] == 2 * SB * NBOOT
        mu_g, mu_w = _leaves(got["po"]["mu"]), _leaves(w["mu"])
        p_g, p_w = _leaves(got["q"]), _leaves(w["q"])
        assert mu_g.keys() == mu_w.keys() == p_g.keys() == p_w.keys()
        for k, wv in mu_w.items():
            wv = np.asarray(wv)
            scale = np.abs(wv).max()
            np.testing.assert_allclose(mu_g[k], wv, rtol=3e-3,
                                       atol=1e-3 * scale, err_msg=str(k))
            big = np.abs(wv) >= 0.02 * scale
            np.testing.assert_allclose(p_g[k][big], np.asarray(p_w[k])[big],
                                       rtol=3e-3, atol=1e-4, err_msg=str(k))
        # the rank's rows of JAX's (S, B, width) posteriors
        rows = slice(0, B) if mode == "tp" else slice(r * M, (r + 1) * M)
        for g, wv in zip(got["enc"], w["enc"]):
            np.testing.assert_allclose(g, np.asarray(wv)[:, rows],
                                       rtol=3e-3, atol=2e-5)
        np.testing.assert_array_equal(got["extra"], w["extra"])


def test_can_step_record_under_tensor_parallelism(result):
    """True with the model's TP record encoder, as JAX's; an extra
    output only where the encoder gives one (the mixture's
    assignments)."""
    _, ranks = result
    for rk in ranks:
        assert rk["can"] == {"nb": (True, False), "joint": (True, False),
                             "mixture": (True, True), "vmf": (True, False)}


def test_capture_form_rule():
    assert FORMS == ("graph", "segments", "eager")
    assert capture_form("nccl", "cuda") == "graph"
    assert capture_form(None, "cuda") == "graph"  # one process
    assert capture_form("gloo", "cuda") == "segments"
    for backend in ("gloo", "nccl", None):
        assert capture_form(backend, "cpu") == "eager"
    with pytest.raises(ValueError, match="mpi"):
        capture_form("mpi", "cuda")


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
