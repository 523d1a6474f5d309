"""The port's superbatch step (``mmvae_tpu_torch.train.superbatch``,
``Trainer.step`` / ``step_record``, ``DenseEpochRunner(superbatch=S)``
and the trainer CLIs' ``--superbatch``) on the CPU, where the superbatch
body runs eagerly (on a card it is a CUDA graph replay, which
``chip_smoke.py`` phase 43 holds against the eager path bitwise).

- ``Trainer.step`` then ``Trainer.step_record`` against the JAX
  package's, an S = 3 superbatch each, JAX's in-step draws injected:
  tests/test_torch_train.py's tolerances (reports ``rtol=2e-4``;
  parameters and posteriors ``rtol=3e-3, atol=2e-5``), the Adam count
  equal;
- the epoch runner at S in {1, 3, 8} against the per-batch path
  (``superbatch=None``), bitwise, over 7 batches (a short last
  superbatch, a wrap-around batch): the NB, vMF, joint and mixture
  packed steps and the NB generic step, 3 epochs with the second
  recording and a resume into epoch 1, on the dense-resident, ELL,
  rotating and host-streaming tiers;
- ``nb_vae --superbatch 3`` against ``--superbatch 1``: the same files;
  resumed from a JAX CLI checkpoint of ``--superbatch 3``: JAX's scores
  carried (``rel=1e-5``) and its artifacts' names and shapes;
- a two-rank mesh with ``--superbatch 3``: its log line, and the bits of
  the same pair at ``--superbatch 1`` (the mesh's superbatches in full:
  tests/test_torch_mesh_superbatch.py).
"""

import gzip
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.io.writers import read_data_file, read_vector_file
from mmvae_tpu.io.writers import write_matrix_market_file
from mmvae_tpu.models.nb import NBVAE as JNBVAE
from mmvae_tpu.ops.losses import nb_loss as jnb_loss
from mmvae_tpu.ops.nb_fast import NBFastStep as JFast
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import Trainer as JTrainer
from mmvae_tpu_torch.cli import nb_vae
from mmvae_tpu_torch.cli.nb_vae import make_step
from mmvae_tpu_torch.data.block import (MtxDataBlock, MtxMemoryBlock,
                                        create_ones_like)
from mmvae_tpu_torch.data.shards import ShardStore
from mmvae_tpu_torch.io.index import build_mmutil_index
from mmvae_tpu_torch.models.nb import NBVAE, params_from_numpy
from mmvae_tpu_torch.models.vmf import VMFVAE
from mmvae_tpu_torch.models.vmfnb import VMFNBVAE
from mmvae_tpu_torch.models.vmfnb_mixture import VMFNBMixtureVAE
from mmvae_tpu_torch.ops.densify import DeviceCSC
from mmvae_tpu_torch.ops.nb_fast import NBFastStep, rand_from_numpy
from mmvae_tpu_torch.ops.vmf_fast import VMFFastStep
from mmvae_tpu_torch.ops.vmfnb_fast import (VMFNBFastStep,
                                            VMFNBMixtureFastStep)
from mmvae_tpu_torch.train.config import TrainingOptions
from mmvae_tpu_torch.train.loop import (DenseEpochRunner, EllBatches,
                                        ResidentBatches, RotatingBatches,
                                        StreamedBatches, Trainer,
                                        build_dense, epoch_generator)
from mmvae_tpu_torch.train.superbatch import tree_map
from tests.test_torch_multihost import _start_pair, _wait_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        lambda t: t.detach().numpy() if isinstance(t, torch.Tensor) else
        np.asarray(t), tree)))


def _assert_tree(got, want, **tol):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=str(k), **tol)


# ------------------------------------------------- Trainer.step vs JAX

DJ, BJ, SJ = 200, 16, 3


def _jax_draws(seed, epoch, ids, R=2, Rn=1, nboot=3):
    """JAX ``Trainer.step``'s in-step draws of batches ``ids``
    (``_draw_batch`` of fold_in(fold_in(PRNGKey(seed), epoch), id), equal
    to ``_batch_step``'s), stacked on a leading axis."""
    fake = types.SimpleNamespace(rows=types.SimpleNamespace(R=R, Rn=Rn),
                                 opt=types.SimpleNamespace(nboot=nboot))
    ekey = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.int32(epoch))
    per = [_np(JFast._draw_batch(fake, jax.random.fold_in(ekey, b), BJ))
           for b in ids]
    return rand_from_numpy(jax.tree_util.tree_map(
        lambda *a: np.stack(a), *per))


def test_trainer_step_and_step_record_match_jax():
    """``--no_fused_step``'s generic step (the default architecture, K7 /
    K8's plain versions): ``step`` over batches 0-2 of epoch 1, then
    ``step_record`` over batches 3-5 from its state, against JAX's."""
    rng = np.random.default_rng(6)
    x = rng.poisson(0.7, size=(2 * SJ, BJ, DJ)).astype(np.int16)
    x[:, 0, :5] = 30  # mixed lgamma regimes
    c = np.ones((2 * SJ, BJ, 1), np.float32)
    jmodel = JNBVAE(data_dim=DJ, covar_dim=1)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    topt = JOptions(nboot=3, seed=4)
    jtr = JTrainer(
        lambda p, xx, cc, k, t: jmodel.forward(p, xx, cc, k, t),
        lambda xx, o, b: jnb_loss(xx, o, b), topt,
        boot_loss_fn=lambda xx, o, b: jnb_loss(xx, o, b,
                                               include_data_const=False),
        report_loss_override=lambda p, xx, cc, k, b: jmodel.fused_loss(
            p, xx, cc, k, b, True, include_data_const=True),
        boot_loss_override=lambda p, xx, cc, k, b: jmodel.fused_loss(
            p, xx, cc, k, b, True, include_data_const=False))
    model = NBVAE(data_dim=DJ)
    tr, _ = make_step(model, TrainingOptions(nboot=3, seed=4,
                                             fused_step=False))
    assert isinstance(tr, Trainer) and tr.can_step_record()
    ids_a, ids_b = np.arange(SJ), np.arange(SJ, 2 * SJ)
    params = params_from_numpy(_np(jparams))  # JAX's step donates them

    jp, jst, jrep = jtr.step(jparams, jtr.optimizer.init(jparams),
                             x[:SJ], c[:SJ], 1, ids_a)
    jp, jst, (jrep2, jenc, jextra) = jtr.step_record(
        jp, jst, x[SJ:], c[SJ:], 1, ids_b,
        lambda p, xx: jmodel.encode_mu(p, xx))

    p, st, rep = tr.step(params, tr.optimizer.init(params), x[:SJ], c[:SJ],
                         1, ids_a, rand=_jax_draws(4, 1, ids_a))
    np.testing.assert_allclose(rep.numpy(), np.asarray(jrep), rtol=2e-4)
    p, st, (rep2, enc, extra) = tr.step_record(
        p, st, x[SJ:], c[SJ:], 1, ids_b, model.encode_mu,
        rand=_jax_draws(4, 1, ids_b))
    np.testing.assert_allclose(rep2.numpy(), np.asarray(jrep2), rtol=2e-4)
    _assert_tree(p, _np(jp), rtol=3e-3, atol=2e-5)
    for got, want in zip(enc, jenc):
        assert got.shape == (SJ, BJ, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=3e-3, atol=2e-5)
    np.testing.assert_array_equal(extra.numpy(), np.asarray(jextra))
    assert extra.shape == (SJ,)  # a zero a batch, JAX's scan output
    assert int(st["count"]) == int(jst[2].count) == 2 * SJ * 3


def test_trainer_step_draws_and_sizes():
    """``rand=None`` takes rows ``batch_ids`` of the draw of an epoch of
    ``nbatch`` batches (the runner's), and needs ``nbatch``; one call of
    S batches equals S calls of one, bitwise, and the graphs object is
    kept across calls and grown for a larger S."""
    model = NBVAE(data_dim=40)
    tr, _ = make_step(model, TrainingOptions(nboot=2, seed=3,
                                             fused_step=False))
    rng = np.random.default_rng(2)
    x = rng.poisson(0.8, size=(4, 8, 40)).astype(np.int8)
    c = np.ones((4, 8, 1), np.float32)
    p0 = model.init(torch.Generator().manual_seed(0))
    ids = np.arange(1, 4)
    rand = tr.draw_rand(epoch_generator(3, 2, "cpu"), 4, 8)
    want = tr.step(p0, tr.optimizer.init(p0), x[1:], c[1:], 2, ids,
                   rand=tree_map(lambda t: t[1:4], rand))
    got = tr.step(p0, tr.optimizer.init(p0), x[1:], c[1:], 2, ids,
                  nbatch=4)
    with pytest.raises(ValueError, match="nbatch"):
        tr.step(p0, tr.optimizer.init(p0), x[1:], c[1:], 2, ids)
    with pytest.raises(ValueError, match="outside an epoch"):
        tr.step(p0, tr.optimizer.init(p0), x[1:], c[1:], 2, ids, nbatch=3)
    p, st = p0, tr.optimizer.init(p0)
    reps = []
    for b in ids:
        p, st, r = tr.step(p, st, x[b:b + 1], c[b:b + 1], 2, [b],
                           rand=tree_map(lambda t: t[b:b + 1], rand))
        reps.append(r)
    one = (p, st, torch.cat(reps))
    for a in (got, one):
        _assert_bitwise([a], [want])
    assert tr._sb[None].S == 3
    tr.release_graphs()
    assert tr._sb == {}


# --------------------------------------------- runner vs per-batch path

D, B, N = 50, 10, 66  # 7 batches, the last wrapping around
K = 3


def _label():
    lab = np.zeros((D, K), np.float32)
    lab[np.arange(30), np.arange(30) % K] = 1.0
    return lab


def _route(kind):
    """(model, step) of a route: a model's packed step, or ``nb_vae
    --no_fused_step``'s generic step."""
    topt = TrainingOptions(nboot=2)
    if kind == "generic":
        model = NBVAE(data_dim=D)
        return model, make_step(model, TrainingOptions(
            nboot=2, fused_step=False))[0]
    model, cls = {"nb": (NBVAE(data_dim=D), NBFastStep),
                  "vmf": (VMFVAE(data_dim=D, covar_dim=1), VMFFastStep),
                  "joint": (VMFNBVAE(data_dim=D), VMFNBFastStep),
                  "mixture": (VMFNBMixtureVAE(label=_label()),
                              VMFNBMixtureFastStep)}[kind]
    return model, cls(model, topt)


ROUTES = ("nb", "vmf", "joint", "mixture", "generic")
TIERS = ("dense", "ell", "rotating", "stream")


@pytest.fixture(scope="module")
def mtx(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sb")
    rng = np.random.default_rng(8)
    dens = rng.poisson(1.1, size=(D, N)).astype(np.float32)
    dens[D - 1] += 1
    dens[:3, ::5] += 9  # mixed lgamma regimes
    rr, cc = np.nonzero(dens)
    path = str(tmp / "m.mtx.gz")
    write_matrix_market_file(path, rr, cc, dens[rr, cc], dens.shape)
    build_mmutil_index(path, path + ".index")
    ones = str(tmp / "ones.mtx.gz")
    create_ones_like(MtxDataBlock(path, path + ".index", B), ones)
    build_mmutil_index(ones, ones + ".index")
    return path, ones


def _source(mtx, tier):
    path, ones = mtx
    mem = MtxMemoryBlock(path, path + ".index", B, count_dtype="auto")
    if tier == "dense":
        return build_dense(mem, "cpu")
    if tier == "ell":
        return EllBatches(DeviceCSC.from_memory_block(
            mem, count_dtype="auto", device="cpu"), B)
    if tier == "rotating":
        # shards of 2 batches, 2 of them resident
        per = B * D
        return RotatingBatches(ShardStore.build(
            mem, B, shard_budget=2 * per + 64, pin_budget=4 * per + 200,
            layout="dense", device="cpu"))
    covar = MtxDataBlock(ones, ones + ".index", B)
    return StreamedBatches(MtxDataBlock(path, path + ".index", B), covar, B,
                           "cpu")


def _record_fn(model):
    enc, _ = model.record_encoder(0, B)

    def record(p, x):
        with torch.no_grad():
            return enc(p, x)
    return record


def _epochs(route, source, S, q, po, first, n):
    model, fast = route
    runner = DenseEpochRunner(fast, source, B, seed=7,
                              record_fn=_record_fn(model), superbatch=S)
    assert runner.nbatch == 7
    out = []
    for epoch in range(first, first + n):
        q, po, reps, enc = runner(q, po, epoch, record=epoch == 1)
        out.append((q, po, reps, enc))
    runner.close()
    return out


def _init(route):
    model, fast = route
    q = fast.pack(model.init(torch.Generator().manual_seed(0)))
    return q, fast.optimizer.init(q)


_REF: dict = {}


def _reference(mtx, kind, tier):
    """3 epochs of the per-batch path (epoch 1 recording)."""
    if (kind, tier) not in _REF:
        route = _route(kind)
        _REF[kind, tier] = _epochs(route, _source(mtx, tier), None,
                                   *_init(route), 0, 3)
    return _REF[kind, tier]


def _order(tree) -> list:
    """The keys of every dict of ``tree`` in their insertion order (the
    order code that zips two trees' ``items()`` relies on)."""
    if isinstance(tree, dict):
        return [(k, _order(v)) for k, v in tree.items()]
    if isinstance(tree, (tuple, list)):
        return [_order(v) for v in tree]
    return None


def _assert_bitwise(got, want):
    """Each epoch's (q, opt_state, reports, record outputs) bitwise, its
    dicts in the same order."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _order(g) == _order(w)
        lg, lw = _leaves(g), _leaves(w)
        assert lg.keys() == lw.keys()
        for k in lw:
            np.testing.assert_array_equal(lg[k], lw[k], err_msg=str(k))


@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("kind", ROUTES)
def test_superbatch_runner_equals_per_batch(mtx, kind, tier, S):
    """S batch steps a dispatch give the per-batch path's parameters, Adam
    state, reports and posteriors, bitwise, and a run resumed into epoch
    1 from epoch 0's state those of the uninterrupted run."""
    want = _reference(mtx, kind, tier)
    route = _route(kind)
    got = _epochs(route, _source(mtx, tier), S, *_init(route), 0, 3)
    _assert_bitwise(got, want)
    assert got[0][3] is None and len(got[1][3]) == len(want[1][3]) >= 2
    q0, po0 = (tree_map(lambda t: t.clone(), a) for a in got[0][:2])
    resumed = _epochs(route, _source(mtx, tier), S, q0, po0, 1, 2)
    _assert_bitwise(resumed, want[1:])


def test_superbatch_runner_dense_covariate(mtx):
    """The dense-resident tier with a dense (N, 2) covariate: each
    superbatch's rows gathered by batch id, as one batch's are."""
    rng = np.random.default_rng(3)
    covar = torch.from_numpy(rng.normal(size=(N, 2)).astype(np.float32))
    model = NBVAE(data_dim=D, covar_dim=2)
    fast = NBFastStep(model, TrainingOptions(nboot=2))
    data = _source(mtx, "dense")
    outs = {}
    for S in (None, 3):
        runner = DenseEpochRunner(fast, data, B, seed=1, covar=covar,
                                  covar_dim=2, superbatch=S)
        q = fast.pack(model.init(torch.Generator().manual_seed(0)))
        po = fast.optimizer.init(q)
        outs[S] = [runner(q, po, e) for e in range(2)]
        runner.close()
    _assert_bitwise(outs[3], outs[None])


def test_trainer_step_walks_an_epoch_as_the_runner(mtx):
    """A 7-batch epoch (its last batch wrapping around) walked through
    ``Trainer.step`` in superbatches of 3, 3 and 1 with the default draws,
    then a recording epoch through ``step_record``, equal bitwise to the
    per-batch epoch runner's two epochs (parameters, Adam state, reports
    and posteriors); the epoch's draw is made once and kept."""
    model, tr = _route("generic")
    data = _source(mtx, "dense")
    xs = torch.stack([x for x, _ in ResidentBatches(data, B).batches()])
    assert xs.shape[0] == 7
    c = torch.ones((7, B, 1))

    def record(p, x):
        with torch.no_grad():
            return tuple(model.encode_mu(p, x))

    runner = DenseEpochRunner(tr, data, B, seed=tr.opt.seed,
                              record_fn=record, superbatch=None)
    q, po = _init((model, tr))
    want = []
    for epoch in range(2):
        q, po, reps, enc = runner(q, po, epoch, record=epoch == 1)
        want.append((q, po, reps, enc))
    p, st = _init((model, tr))
    got = []
    for epoch in range(2):
        reps, encs = [], []
        for lo, hi in ((0, 3), (3, 6), (6, 7)):
            ids = list(range(lo, hi))
            if epoch == 0:
                p, st, r = tr.step(p, st, xs[lo:hi], c[lo:hi], epoch, ids,
                                   nbatch=7)
            else:
                p, st, (r, e, extra) = tr.step_record(
                    p, st, xs[lo:hi], c[lo:hi], epoch, ids,
                    model.encode_mu, nbatch=7)
                encs.append(e)
                np.testing.assert_array_equal(extra.numpy(), 0)
            reps.append(r)
        enc = (tuple(torch.cat(t) for t in zip(*encs)) if encs else None)
        got.append((p, st, torch.cat(reps), enc))
        assert tr._draw[0][1:3] == (epoch, 7)
    _assert_bitwise(got, want)
    tr.release_graphs()


# ------------------------------------------------------------- the CLIs

def _run_jax(module, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               MMVAE_FEATURE_PERM="0")
    r = subprocess.run([sys.executable, "-m", module] + args,
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]


def _files(d: str, base: str) -> dict:
    """A run's outputs by suffix, gzip files decompressed (the header
    holds the name), the metrics' losses."""
    out = {}
    for f in os.listdir(d):
        if not f.startswith(base):
            continue
        p = os.path.join(d, f)
        if f.endswith(".gz"):
            out[f[len(base):]] = gzip.open(p).read()
        elif f.endswith(".metrics.jsonl"):
            out[f[len(base):]] = [json.loads(ln)["loss"]
                                  for ln in open(p)]
    return out


def test_runner_superbatch_matches_jax_superbatch_steps(mtx):
    """The port's epoch runner at S = 3 against the JAX package's host
    superbatch loop (what its CLI runs with ``--superbatch 3``:
    ``Trainer.step`` on batches 0-2, 3-5 and 6, then ``step_record``),
    the NB packed step, from JAX's init with JAX's draws, 2 epochs with
    the second recording: tests/test_torch_train.py's tolerances."""
    data = _source(mtx, "dense")
    xn = data.numpy()
    jmodel = JNBVAE(data_dim=D, covar_dim=1)
    topt = JOptions(nboot=2, seed=7, superbatch=3)
    jfast = JFast(jmodel, topt)
    jtr = JTrainer(
        lambda p, xx, cc, k, t: jmodel.forward(p, xx, cc, k, t),
        lambda xx, o, b: jnb_loss(xx, o, b), topt,
        report_loss_override=lambda p, xx, cc, k, b: jmodel.fused_step_report(
            p, xx, cc, k, b, include_data_const=True),
        boot_loss_override=lambda p, xx, cc, k, b: jmodel.fused_step_boot(
            p, xx, cc, k, b), fast_step=jfast)
    jparams = jmodel.init(jax.random.PRNGKey(2))
    model = NBVAE(data_dim=D)
    fast = NBFastStep(model, TrainingOptions(nboot=2, seed=7))

    def record(p, x):
        with torch.no_grad():
            return tuple(model.encode_mu(p, x))

    runner = DenseEpochRunner(fast, data, B, seed=7, record_fn=record,
                              superbatch=3)
    q = fast.pack(params_from_numpy(_np(jparams)))
    st = fast.optimizer.init(q)
    jst = jtr.optimizer.init(jparams)
    cols = [(b * B + np.arange(B)) % N for b in range(7)]
    for epoch in range(2):
        jreps, jencs = [], []
        for lo, hi in ((0, 3), (3, 6), (6, 7)):
            x_sb = np.stack([xn[cols[b]] for b in range(lo, hi)])
            c_sb = np.ones((hi - lo, B, 1), np.float32)
            if epoch == 0:
                jparams, jst, r = jtr.step(jparams, jst, x_sb, c_sb, epoch,
                                           np.arange(lo, hi))
            else:
                jparams, jst, (r, e, _) = jtr.step_record(
                    jparams, jst, x_sb, c_sb, epoch, np.arange(lo, hi),
                    lambda p, xx: jmodel.encode_mu(p, xx))
                jencs.append(_np(e))
            jreps.append(np.asarray(r))
        rand = jax.jit(lambda: jfast.draw_rand(
            jax.random.fold_in(jax.random.PRNGKey(7), jnp.int32(epoch)),
            jnp.arange(7, dtype=jnp.int32), B))()
        q, st, reps, enc = runner(q, st, epoch, record=epoch == 1,
                                  rand=rand_from_numpy(_np(rand)))
        np.testing.assert_allclose(reps.numpy(), np.concatenate(jreps),
                                   rtol=2e-4)
        if epoch == 1:
            for got, want in zip(enc, zip(*jencs)):
                np.testing.assert_allclose(got.numpy(), np.concatenate(want),
                                           rtol=3e-3, atol=2e-5)
    runner.close()
    _assert_tree(fast.unpack(q), _np(jparams), rtol=3e-3, atol=2e-5)
    assert int(st["count"]) == int(jst[2].count) == 2 * 7 * 2


def _artifacts(d, prefix: str) -> dict:
    """{suffix: shape} of a run's ``<prefix>_*.gz`` artifacts."""
    return {f[len(prefix):]: read_data_file(str(d / f)).shape
            for f in os.listdir(d)
            if f.startswith(prefix + "_") and f.endswith(".gz")}


def test_cli_superbatch_sizes_and_jax(mtx, tmp_path, capfd, monkeypatch):
    """``nb_vae --superbatch 3`` against ``--superbatch 1``: the same files
    and checkpoint.  Against the JAX CLI's ``--superbatch 3`` run from
    scratch on the same matrix and seed: the artifacts' names and shapes,
    the metrics rows' keys, finite scores (as tests/test_torch_train.py
    holds the per-batch CLI: the two packages' inits and draws come from
    different generators, so their values are held at the runner, by
    ``test_runner_superbatch_matches_jax_superbatch_steps``).  Then the
    port at ``--superbatch 3`` resumes JAX's checkpoint: JAX's scores
    carried (``rel=1e-5``) and one more finite epoch."""
    monkeypatch.setenv("MMVAE_FEATURE_PERM", "0")
    path, _ = mtx
    common = ["--mtx", path, "--batch_size", str(B), "--recording", "2"]
    for S in ("1", "3"):
        d = tmp_path / f"s{S}"
        os.makedirs(d)
        assert nb_vae.main(common + [
            "--out", str(d / "run"), "--max_epoch", "2", "--superbatch", S,
            "--device", "cpu", "--checkpoint_dir", str(d / "ck")]) == 0
        assert (f"Superbatch: {S} batch steps a dispatch (eager on the "
                "CPU)") in capfd.readouterr().err
    got, want = (_files(str(tmp_path / s), "run") for s in ("s3", "s1"))
    assert len(got) > 10 and got == want
    a, b = (np.load(str(tmp_path / s / "ck" / "ckpt.npz"))
            for s in ("s3", "s1"))
    assert a.files == b.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the JAX CLI at --superbatch 3 from scratch
    jd = tmp_path / "jax"
    os.makedirs(jd)
    _run_jax("mmvae_tpu.cli.nb_vae", common + [
        "--out", str(jd / "run"), "--max_epoch", "2", "--superbatch", "3",
        "--checkpoint_dir", str(tmp_path / "jck")])
    port, jx = _artifacts(tmp_path / "s3", "run"), _artifacts(jd, "run")
    assert port == jx and len(port) > 10
    rows = {}
    for name, d in (("port", tmp_path / "s3"), ("jax", jd)):
        with open(d / "run.metrics.jsonl") as f:
            rows[name] = [json.loads(ln) for ln in f]
        scores = [float(v) for v in read_vector_file(str(d / "run.scores.gz"))]
        assert len(scores) == 2 and np.isfinite(scores).all()
    assert [set(r) for r in rows["port"]] == [set(r) for r in rows["jax"]]
    # the port resumes JAX's --superbatch 3 checkpoint at --superbatch 3
    pout = str(tmp_path / "resumed")
    assert nb_vae.main(common + ["--out", pout, "--max_epoch", "3",
                                 "--superbatch", "3", "--device", "cpu",
                                 "--resume", str(tmp_path / "jck")]) == 0
    js, ps = ([float(v) for v in read_vector_file(f + ".scores.gz")]
              for f in (str(jd / "run"), pout))
    assert len(ps) == 3 and ps[:2] == pytest.approx(js, rel=1e-5)
    assert np.isfinite(ps[2])


def test_mesh_superbatch_logs_and_trains_as_before(mtx, tmp_path):
    """Two gloo ranks with ``--superbatch 3``: the mesh's step runs 3
    batch steps a superbatch (eager on the CPU), rank 0 says so once,
    and the outputs equal the ``--superbatch 1`` pair's."""
    path, _ = mtx
    started = []
    for S in ("3", "1"):
        os.makedirs(tmp_path / S)
        a = ["--mtx", path, "--batch_size", str(B), "--recording", "2",
             "--out", str(tmp_path / S / "run"), "--max_epoch", "2",
             "--superbatch", S]
        started.append((_start_pair(a), a))
    logs = [_wait_pair(*s) for s in started]
    for S, log in zip(("3", "1"), logs):
        assert log.count(f"Superbatch: {S} batch steps a dispatch (eager "
                         "on the CPU)") == 1
        assert "groups nothing" not in log
    got, want = (_files(str(tmp_path / s), "run") for s in ("3", "1"))
    assert len(got) > 10 and got == want
