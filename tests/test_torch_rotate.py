"""The port's rotating-shard tier (mmvae_tpu_torch.data.shards,
train.loop.RotatingBatches) and its tier choice.

- ``ShardStore.build`` against the JAX package's on the same file: the
  layout choice, the shard plan (``b0``, ``nb``), ``pinned_idx`` and
  every shard array, bitwise.
- Trajectories on the rotating tier against the port's dense-resident
  ones, bitwise (the same batches, schedule and draws): every layout,
  resident shards, one shard, the wrap-around batch (N % B != 0), the
  recorder's outputs, the vMF-VAE and joint packed steps, and a run
  resumed from a checkpoint written while the next shard's copy was in
  flight.
- The port's rotating runner against JAX's ``make_rotating_epoch`` fed
  JAX's draws, in tests/test_torch_train.py's tolerance: per-batch
  reports ``rtol=2e-4``, parameters after two epochs ``rtol=3e-3,
  atol=2e-5``.
"""

import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.data import MtxMemoryBlock as JBlock
from mmvae_tpu.data.shards import ShardStore as JStore
from mmvae_tpu.models.nb import NBVAE as JNBVAE
from mmvae_tpu.ops.losses import nb_loss
from mmvae_tpu.ops.nb_fast import NBFastStep as JFast
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import Trainer as JTrainer
from mmvae_tpu_torch.data.block import (MtxDataBlock, MtxMemoryBlock,
                                        create_ones_like)
from mmvae_tpu_torch.data.shards import ShardStore
from mmvae_tpu_torch.io.index import build_mmutil_index
from mmvae_tpu_torch.io.writers import write_matrix_market_file
from mmvae_tpu_torch.models.nb import NBVAE, adam_from_numpy, params_from_numpy
from mmvae_tpu_torch.models.vmf import VMFVAE
from mmvae_tpu_torch.models.vmfnb import VMFNBVAE
from mmvae_tpu_torch.ops.nb_fast import NBFastStep, rand_from_numpy
from mmvae_tpu_torch.ops.vmf_fast import VMFFastStep
from mmvae_tpu_torch.ops.vmfnb_fast import VMFNBFastStep
from mmvae_tpu_torch.train import checkpoint as tck
from mmvae_tpu_torch.train import loop
from mmvae_tpu_torch.train.config import TrainingOptions
from mmvae_tpu_torch.train.recorder import LatentRecorder

D, N, B = 50, 70, 16  # 5 batches, the last wraps around


def _write(path, dens):
    rr, cc = np.nonzero(dens)
    write_matrix_market_file(path, rr, cc, dens[rr, cc], dens.shape)
    build_mmutil_index(path, path + ".index")
    return path


def _counts(seed=5, kind="int8"):
    """(D, N) counts, every cell nonzero at gene D - 1; ``kind`` int16
    adds counts past 127, float32 non-integer values."""
    rng = np.random.default_rng(seed)
    dens = rng.poisson(1.2, size=(D, N)).astype(np.float32)
    dens[D - 1] += 1
    dens[:3, ::7] += 9  # a few denser cells
    if kind == "int16":
        dens[4, 3] = 300
    elif kind == "float32":
        dens[dens > 0] += 0.5
    return dens


@pytest.fixture(scope="module")
def mtx(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rot")
    path = _write(str(tmp / "m.mtx.gz"), _counts())
    ones = str(tmp / "ones.mtx.gz")
    create_ones_like(MtxDataBlock(path, path + ".index", B), ones)
    build_mmutil_index(ones, ones + ".index")
    return path, ones


def _blocks(mtx):
    path, ones = mtx
    data = MtxMemoryBlock(path, path + ".index", B, count_dtype="auto")
    covar = MtxDataBlock(ones, ones + ".index", B)
    covar.auto_ones = True
    return data, covar


def _force_rotation(monkeypatch, shard_bytes=2000, layout=None, pin=None):
    """A budget no resident layout fits; shards of 2 dense batches (900
    bytes: one), ``pin`` bytes of them resident."""
    monkeypatch.setenv("MMVAE_DENSE_BYTES", "1")
    monkeypatch.setenv("MMVAE_SHARD_BYTES", str(shard_bytes))
    if layout:
        monkeypatch.setenv("MMVAE_SHARD_LAYOUT", layout)
    if pin is not None:
        monkeypatch.setenv("MMVAE_PIN_BYTES", str(pin))


def _train(data, covar, fast, model, epochs=2, recorder=None, **kw):
    topt = TrainingOptions(nboot=2, max_epoch=epochs, recording=2, seed=0)
    params = model.init(torch.Generator().manual_seed(0))
    return loop.train_vae_model(fast, recorder, data, covar, topt, params,
                                "cpu", **kw)


def _nb():
    model = NBVAE(data_dim=D)
    return NBFastStep(model, TrainingOptions(nboot=2)), model


def _assert_same(a, b):
    (pa, la), (pb, lb) = a, b
    assert la == lb
    fa, fb = (dict(jax.tree_util.tree_leaves_with_path(p)) for p in (pa, pb))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


# ---------------------------------------------------------------- store

@pytest.mark.parametrize("kind", ["int8", "int16", "float32"])
@pytest.mark.parametrize("layout", [None, "dense", "ell", "csr"])
@pytest.mark.parametrize("pin", [0, 5000])
def test_shard_store_matches_jax(tmp_path, kind, layout, pin):
    path = _write(str(tmp_path / "m.mtx.gz"), _counts(kind=kind))
    kw = dict(shard_budget=2000, layout=layout, pin_budget=pin)
    js = JStore.build(JBlock(path, path + ".index", B), B, **kw)
    ps = ShardStore.build(MtxMemoryBlock(path, path + ".index", B), B, **kw)
    assert (ps.layout, ps.D, ps.ntot, ps.B, ps.nbatch) == (
        js.layout, js.D, js.ntot, js.B, js.nbatch)
    assert ps.val_dtype == js.val_dtype
    assert [(s.b0, s.nb) for s in ps.shards] == [(s.b0, s.nb)
                                                 for s in js.shards]
    assert ps.pinned_idx == js.pinned_idx
    assert ps.nshards >= 3 and (pin == 0) == (not ps.pinned_idx)
    for p, j in zip(ps.shards, js.shards):
        assert len(p.arrays) == len(j.arrays)
        for a, b in zip(p.arrays, j.arrays):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for r in range(ps.nshards):
        assert ps.shard_bytes(r) == js.shard_bytes(r)


def test_shard_put_caches_resident_shards(mtx):
    data, _ = _blocks(mtx)
    store = ShardStore.build(data, B, shard_budget=2000, pin_budget=5000)
    p = min(store.pinned_idx)
    rot = min(set(range(store.nshards)) - store.pinned_idx)
    assert store.put(p) is store.put(p)
    assert store.put(rot) is not store.put(rot)


@pytest.mark.parametrize("layout", ["dense", "ell", "csr"])
def test_shard_batches_match_schedule(mtx, layout):
    """Every batch of every shard, the wrap-around one included, is the
    host reader's batch of its global id."""
    data, _ = _blocks(mtx)
    store = ShardStore.build(data, B, shard_budget=2000, layout=layout)
    src = loop.RotatingBatches(store)
    sched = loop.sequential_batches(N, B)
    got = [x for x, _ in src.batches()]
    assert len(got) == len(sched) == 5
    for x, cols in zip(got, sched):
        want = data.read_into(cols, np.zeros((B, D), data.val_dtype))
        np.testing.assert_array_equal(x.numpy(), want)


# ----------------------------------------------------------- trajectory

@pytest.mark.parametrize("layout", ["dense", "ell", "csr"])
def test_rotation_matches_dense_bitwise(mtx, monkeypatch, capfd, layout):
    data, covar = _blocks(mtx)
    want = _train(data, covar, *_nb())
    _force_rotation(monkeypatch, layout=layout)
    got = _train(data, covar, *_nb())
    assert f"{layout} layout" in capfd.readouterr().err
    _assert_same(got, want)


@pytest.mark.parametrize("case", ["pinned", "single_shard"])
def test_rotation_variants_match_dense_bitwise(mtx, monkeypatch, capfd,
                                               case):
    """Shards kept resident beside rotating ones; one shard (R = 1, the
    prefetch takes the same shard for the next epoch)."""
    data, covar = _blocks(mtx)
    want = _train(data, covar, *_nb(), epochs=3)
    if case == "pinned":
        _force_rotation(monkeypatch, shard_bytes=900, pin=2000)
    else:
        _force_rotation(monkeypatch, shard_bytes=1 << 30)
    got = _train(data, covar, *_nb(), epochs=3)
    err = capfd.readouterr().err
    assert ("Rotating 1/1 " in err) == (case == "single_shard")
    assert ("Rotating 3/5 " in err) == (case == "pinned")
    _assert_same(got, want)


@pytest.mark.parametrize("step", ["vmf", "joint"])
def test_rotation_packed_steps_match_dense(mtx, monkeypatch, step):
    data, covar = _blocks(mtx)

    def run():
        if step == "vmf":
            model = VMFVAE(data_dim=D, covar_dim=1)
            fast = VMFFastStep(model, TrainingOptions(nboot=2))
        else:
            model = VMFNBVAE(data_dim=D)
            fast = VMFNBFastStep(model, TrainingOptions(nboot=2))
        return _train(data, covar, fast, model)

    want = run()
    _force_rotation(monkeypatch, layout="csr")
    _assert_same(run(), want)


def test_rotation_recording_matches_dense(mtx, monkeypatch, tmp_path):
    data, covar = _blocks(mtx)

    def run(tag):
        fast, model = _nb()
        enc, _ = model.record_encoder(0, B)
        rec = LatentRecorder(str(tmp_path / tag), 2, N, encode_fn=enc)
        _train(data, covar, fast, model, recorder=rec)
        return {f: gzip.open(tmp_path / f).read()
                for f in sorted(os.listdir(tmp_path))
                if f.startswith(tag + "_")}

    want = run("res")
    _force_rotation(monkeypatch, shard_bytes=900, pin=2000)
    got = run("rot")
    assert len(got) == len(want) == 28
    assert list(got.values()) == list(want.values())


def test_auto_enable_routes_beyond_budget_to_rotation(mtx, monkeypatch,
                                                      capfd):
    """Above MMVAE_ONDEVICE_BYTES auto-enable picks rotation, without
    MMVAE_DENSE_BYTES lowered: the loader tiers on the same budget."""
    data, covar = _blocks(mtx)
    want = _train(data, covar, *_nb())
    monkeypatch.setenv("MMVAE_ONDEVICE_BYTES", "1")
    monkeypatch.delenv("MMVAE_DENSE_BYTES", raising=False)
    monkeypatch.setenv("MMVAE_SHARD_BYTES", "2000")
    got = _train(data, covar, *_nb())
    err = capfd.readouterr().err
    assert "Auto-enabling rotating-shard on-device epochs" in err
    assert "host-resident shards" in err
    _assert_same(got, want)


def test_resume_mid_rotation_matches_uninterrupted(mtx, monkeypatch,
                                                   tmp_path):
    """A checkpoint written by ``on_epoch_end`` while the next epoch's
    first shard is being copied resumes to the uninterrupted run's
    bits."""
    data, covar = _blocks(mtx)
    _force_rotation(monkeypatch, shard_bytes=900, pin=2000)
    sources = []

    class Watched(loop.RotatingBatches):
        def __init__(self, store):
            super().__init__(store)
            sources.append(self)

    monkeypatch.setattr(loop, "RotatingBatches", Watched)
    ck = str(tmp_path / "ck")

    def save(epoch, p, o, losses):
        if epoch == 0:
            assert sources[-1]._carry is not None  # a copy in flight
            tck.save_checkpoint(ck, p, epoch, 0, losses, opt_state=o)

    fast, model = _nb()
    want = _train(data, covar, fast, model, epochs=3, on_epoch_end=save)
    params_np, start, prev = tck.load_checkpoint(ck, model)
    assert start == 1 and prev == want[1][:1]
    fast, model = _nb()
    topt = TrainingOptions(nboot=2, max_epoch=3, recording=2, seed=0)
    params, losses = loop.train_vae_model(
        fast, None, data, covar, topt, params_from_numpy(params_np), "cpu",
        start_epoch=1,
        init_opt_state=adam_from_numpy(tck.load_opt_state(ck, model)))
    _assert_same((params, prev + losses), want)


# ------------------------------------------------------- against JAX

def test_rotating_runner_matches_jax(tmp_path):
    """Two epochs of the port's rotating runner and of JAX's
    ``make_rotating_epoch`` over the same stores (csr layout, a resident
    shard), fed JAX's draws."""
    path = _write(str(tmp_path / "m.mtx.gz"), _counts(seed=9))
    kw = dict(shard_budget=2000, layout="csr", pin_budget=9000)
    jstore = JStore.build(JBlock(path, path + ".index", B), B, **kw)
    pstore = ShardStore.build(MtxMemoryBlock(path, path + ".index", B), B,
                              **kw)
    assert pstore.pinned_idx and pstore.nshards >= 3
    jmodel = JNBVAE(data_dim=D, covar_dim=1)
    topt = JOptions(nboot=3, seed=5)
    jfast = JFast(jmodel, topt)
    trainer = JTrainer(
        lambda p, xx, c, k, t: jmodel.forward(p, xx, c, k, t),
        lambda xx, o, b: nb_loss(xx, o, b), topt,
        report_loss_override=lambda p, xx, c, k, b: jmodel.fused_step_report(
            p, xx, c, k, b, include_data_const=True),
        boot_loss_override=lambda p, xx, c, k, b: jmodel.fused_step_boot(
            p, xx, c, k, b), fast_step=jfast)
    run = trainer.make_rotating_epoch(jstore, None, N, B)
    jparams = jmodel.init(jax.random.PRNGKey(2))
    pnp = jax.tree_util.tree_map(np.asarray, jparams)
    jstate = trainer.optimizer.init(jparams)

    fast = NBFastStep(NBVAE(data_dim=D), TrainingOptions(nboot=3, seed=5))
    runner = loop.DenseEpochRunner(fast, loop.RotatingBatches(pstore), B,
                                   seed=5)
    q = fast.pack(params_from_numpy(pnp))
    st = fast.optimizer.init(q)
    nbatch = -(-N // B)
    for epoch in range(2):
        jparams, jstate, jrep = run(jparams, jstate, epoch)
        rand = jax.jit(lambda: jfast.draw_rand(
            jax.random.fold_in(jax.random.PRNGKey(5), jnp.int32(epoch)),
            jnp.arange(nbatch, dtype=jnp.int32), B))()
        q, st, reps, _ = runner(q, st, epoch, rand=rand_from_numpy(
            jax.tree_util.tree_map(np.asarray, rand)))
        np.testing.assert_allclose(reps.numpy(), np.asarray(jrep), rtol=2e-4)
    got = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        lambda t: t.numpy(), fast.unpack(q))))
    for p, want in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jparams)):
        np.testing.assert_allclose(got[p], want, rtol=3e-3, atol=2e-5,
                                   err_msg=str(p))
    assert int(st["count"]) == int(jstate[2].count) == 2 * nbatch * 3
