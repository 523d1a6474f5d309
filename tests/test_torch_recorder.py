"""The port's recorder (``train.recorder.LatentRecorder``: the background
writer, ``submit_epoch``, ``update_on_batch``), its visit sweeps
(``train.loop.visit_data`` / ``visit_vae_model``) and the live batch
line of the host-streaming tier, against the JAX package's
(``mmvae_tpu/train/recorder.py``, ``train/loop.py:1700-1745, 1889-1916``).

Artifacts are compared as decompressed bytes (the gzip header holds the
file name); posteriors the two packages compute from the same parameters
agree to ``rtol=1e-5, atol=1e-6`` (float32 encoders, summed in another
order).
"""

import glob
import gzip
import io
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.data.block import MtxMemoryBlock as JBlock
from mmvae_tpu.models.nb import NBVAE as JNB
from mmvae_tpu.train import loop as jloop
from mmvae_tpu.train.recorder import LatentRecorder as JRecorder
from mmvae_tpu_torch.data.block import (MtxDataBlock, MtxMemoryBlock,
                                        create_ones_like)
from mmvae_tpu_torch.data.pipeline import sequential_batches
from mmvae_tpu_torch.io.index import build_mmutil_index
from mmvae_tpu_torch.io.writers import write_matrix_market_file
from mmvae_tpu_torch.models.nb import NBVAE, params_from_numpy
from mmvae_tpu_torch.ops.nb_fast import NBFastStep
from mmvae_tpu_torch.train import loop, recorder as rec_mod
from mmvae_tpu_torch.train.config import TrainingOptions
from mmvae_tpu_torch.train.recorder import LatentRecorder

D, N, B = 30, 44, 8  # 6 batches, the last wrapping around to rows 0-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def mtx(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rec")
    rng = np.random.default_rng(11)
    dens = rng.poisson(1.2, size=(D, N)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    rr, cc = np.nonzero(dens)
    order = np.lexsort((rr, cc))
    path = str(tmp / "rec.mtx.gz")
    write_matrix_market_file(path, rr[order], cc[order], dens[rr, cc][order],
                             (D, N))
    build_mmutil_index(path, path + ".index")
    return path, dens.T.copy()


def _files(prefix: str) -> dict:
    """{name after the prefix: decompressed bytes} of a run's gz files."""
    out = {}
    for f in sorted(glob.glob(prefix + "_*.gz")):
        with gzip.open(f) as fh:
            out[f[len(prefix):]] = fh.read()
    return out


def _blocks(path, stream=False, tmp=None):
    data = (MtxDataBlock(path, path + ".index", B) if stream
            else MtxMemoryBlock(path, path + ".index", B, count_dtype="auto"))
    cov = os.path.join(tmp or os.path.dirname(path),
                       f"cov{'s' if stream else 'm'}.mtx.gz")
    if not os.path.exists(cov):
        create_ones_like(data, cov)
        build_mmutil_index(cov, cov + ".index")
    covar = MtxDataBlock(cov, cov + ".index", B)
    covar.auto_ones = True
    return data, covar


def _train(path, out, async_writes, epochs=4, stream=False, fast=None,
           rec=None):
    model = NBVAE(data_dim=D)
    topt = TrainingOptions(nboot=2, max_epoch=epochs, recording=2, seed=0,
                           auto_ondevice=not stream)
    data, covar = _blocks(path, stream)
    rec = rec or LatentRecorder(out, epochs, N, encode_fn=model.encode_mu,
                                async_writes=async_writes)
    return loop.train_vae_model(
        fast or NBFastStep(model, topt), rec, data, covar, topt,
        model.init(torch.Generator().manual_seed(0)), "cpu"), rec


def test_async_recorder_writes_the_sync_bytes(mtx, tmp_path):
    path, _ = mtx
    (p_s, l_s), _ = _train(path, str(tmp_path / "sync"), False)
    (p_a, l_a), rec = _train(path, str(tmp_path / "async"), True)
    assert rec._pending == []  # joined before train_vae_model returned
    sync, asy = _files(str(tmp_path / "sync")), _files(str(tmp_path / "async"))
    assert len(sync) == 2 * 28 and sync == asy
    assert l_s == l_a


def test_port_async_recorder_writes_jax_bytes(mtx, tmp_path):
    """The same posteriors and parameters through JAX's async
    ``submit_epoch`` and the port's: the same decompressed files."""
    _, x = mtx
    jmodel = JNB(data_dim=D, covar_dim=1)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    batches = np.stack(sequential_batches(N, B))
    rng = np.random.default_rng(0)
    enc = (rng.normal(size=(len(batches), B, 2)).astype(np.float32),
           rng.normal(size=(len(batches), B, 2)).astype(np.float32))
    jrec = JRecorder(str(tmp_path / "jax"), 9, N,
                     encode_fn=lambda p, xx: jmodel.encode_mu(p, xx),
                     async_writes=True)
    jrec.submit_epoch(batches, tuple(jnp.asarray(e) for e in enc), None,
                      jparams, 3)
    jrec.flush()
    prec = LatentRecorder(str(tmp_path / "port"), 9, N,
                          encode_fn=NBVAE(data_dim=D).encode_mu,
                          async_writes=True)
    prec.submit_epoch(batches, tuple(torch.from_numpy(e) for e in enc),
                      params_from_numpy(_np(jparams)), 3)
    prec.flush()
    got, want = _files(str(tmp_path / "port")), _files(str(tmp_path / "jax"))
    assert len(want) == 28 and got == want


def _slow_writes(monkeypatch, delay=0.02):
    real = rec_mod.write_data_file

    def slow(p, a):
        time.sleep(delay)
        real(p, a)

    monkeypatch.setattr(rec_mod, "write_data_file", slow)


def test_ingest_after_submit_leaves_the_epoch_alone(tmp_path, monkeypatch):
    """An epoch's files hold the rows as submitted, though the next
    epoch's rows are ingested while its writes are still queued."""
    _slow_writes(monkeypatch)
    batches = np.stack(sequential_batches(N, B))
    a = (np.ones((len(batches), B, 2), np.float32),) * 2
    b = (np.full((len(batches), B, 2), 2.0, np.float32),) * 2
    params = {"x_mean": torch.zeros((1, D))}
    rec = LatentRecorder(str(tmp_path / "r"), 9, N, encode_fn=None,
                         async_writes=True)
    rec.submit_epoch(batches, tuple(map(torch.from_numpy, a)), params, 1)
    rec.ingest(batches, tuple(map(torch.from_numpy, b)))
    params["x_mean"] += 5.0  # the caller's tensors move on, too
    rec.update_on_epoch(params, 2)
    rec.flush()
    for epoch, v, xm in ((1, 1.0, 0.0), (2, 2.0, 5.0)):
        m = np.loadtxt(tmp_path / f"r_{epoch}.mu_mean.gz")
        assert m.shape == (N, 2) and np.all(m == v)
        assert np.all(np.loadtxt(tmp_path / f"r_{epoch}_x_mean.gz") == xm)


class _Fail(OSError):
    pass


def _failing_writes(monkeypatch):
    def fail(p, a):
        time.sleep(0.05)
        raise _Fail(p)

    monkeypatch.setattr(rec_mod, "write_data_file", fail)


def test_write_error_surfaces_at_flush(tmp_path, monkeypatch):
    _failing_writes(monkeypatch)
    rec = LatentRecorder(str(tmp_path / "r"), 9, N, encode_fn=None,
                         async_writes=True)
    rec.update_on_epoch({"x_mean": torch.zeros((1, D))}, 1)
    with pytest.raises(_Fail):
        rec.flush()
    assert rec._pending == []
    rec.flush()  # raised once


def test_write_error_surfaces_from_train_vae_model(mtx, tmp_path,
                                                   monkeypatch):
    _failing_writes(monkeypatch)
    with pytest.raises(_Fail):
        _train(mtx[0], str(tmp_path / "r"), True, epochs=2)


def test_write_error_surfaces_when_an_epoch_raises(mtx, tmp_path,
                                                  monkeypatch):
    """Epoch 2 records (its writes fail on the writer thread) and epoch 3
    raises: the writes are joined in ``train_vae_model``'s ``finally``,
    whose error carries the epoch's as its context."""
    _failing_writes(monkeypatch)
    model = NBVAE(data_dim=D)
    fast = NBFastStep(model, TrainingOptions(nboot=2, seed=0))
    step, calls = fast.batch_step, []

    def batch_step(q, st, x, c, epoch_f, rand, mesh=None):
        calls.append(epoch_f)
        if epoch_f == 2.0:
            raise RuntimeError("epoch 3 failed")
        return step(q, st, x, c, epoch_f, rand, mesh=mesh)

    fast.batch_step = batch_step
    rec = LatentRecorder(str(tmp_path / "r"), 4, N, encode_fn=model.encode_mu,
                         async_writes=True)
    with pytest.raises(_Fail) as e:
        _train(mtx[0], None, True, epochs=4, fast=fast, rec=rec)
    assert isinstance(e.value.__context__, RuntimeError)
    assert rec._pending == [] and 2.0 in calls


def test_update_on_batch_matches_jax(mtx, tmp_path):
    """JAX's host recording path on a wrap-around schedule, the model
    moving between batches: the last visit of a row wins in both."""
    _, x = mtx
    jmodel = JNB(data_dim=D, covar_dim=1)
    jparams = jmodel.init(jax.random.PRNGKey(4))
    jrec = JRecorder(str(tmp_path / "j"), 9, N,
                     encode_fn=lambda p, xx: jmodel.encode_mu(p, xx))
    prec = LatentRecorder(str(tmp_path / "p"), 9, N,
                          encode_fn=NBVAE(data_dim=D).encode_mu,
                          async_writes=True)
    schedule = sequential_batches(N, B)
    assert len(set(np.concatenate(schedule))) < len(schedule) * B  # wraps
    for i, batch in enumerate(schedule):
        jp = jax.tree_util.tree_map(lambda a: a * (1.0 + 0.1 * i), jparams)
        jrec.update_on_batch(jp, jnp.asarray(x[batch]), batch)
        prec.update_on_batch(params_from_numpy(_np(jp)), x[batch], batch)
    prec.flush()
    for attr in ("mean_out", "lnvar_out"):
        np.testing.assert_allclose(getattr(prec, attr), getattr(jrec, attr),
                                   rtol=1e-5, atol=1e-6, err_msg=attr)
    # rows 0-3 were visited twice: their last visit (i = 5) is kept
    p5 = params_from_numpy(_np(jax.tree_util.tree_map(lambda a: a * 1.5,
                                                      jparams)))
    want = NBVAE(data_dim=D).encode_mu(p5, torch.from_numpy(x[:4]))[0]
    np.testing.assert_allclose(prec.mean_out[:4], want.numpy(), rtol=1e-6)


def test_visit_sweeps_match_jax(mtx, tmp_path):
    path, x = mtx

    class Seen:
        def __init__(self):
            self.seen = []

        def update_on_batch(self, *args):
            xb, batch = args[-2], args[-1]
            self.seen.append((np.asarray(batch).copy(), np.asarray(xb).copy()))

    jblk, pblk = JBlock(path, path + ".index", B), _blocks(path)[0]
    for jfn, pfn, pre in ((jloop.visit_data, loop.visit_data, ()),
                          (lambda v, b: jloop.visit_vae_model(None, {}, v, b),
                           lambda v, b: loop.visit_vae_model(None, {}, v, b),
                           ({},))):
        js, ps = Seen(), Seen()
        jfn(js, jblk)
        pfn(ps, pblk)
        assert len(ps.seen) == len(js.seen) == 6
        for (jb, jx), (pb, px) in zip(js.seen, ps.seen):
            np.testing.assert_array_equal(pb, jb)
            np.testing.assert_array_equal(px, jx)
    # a recorder driven by each sweep: the same matrices
    jmodel = JNB(data_dim=D, covar_dim=1)
    jparams = jmodel.init(jax.random.PRNGKey(5))
    jrec = JRecorder(str(tmp_path / "j"), 9, N,
                     encode_fn=lambda p, xx: jmodel.encode_mu(p, xx))
    prec = LatentRecorder(str(tmp_path / "p"), 9, N,
                          encode_fn=NBVAE(data_dim=D).encode_mu)
    jloop.visit_vae_model(None, jparams, jrec, jblk)
    loop.visit_vae_model(None, params_from_numpy(_np(jparams)), prec, pblk)
    for attr in ("mean_out", "lnvar_out"):
        assert getattr(prec, attr).shape == (N, 2)
        np.testing.assert_allclose(getattr(prec, attr), getattr(jrec, attr),
                                   rtol=1e-5, atol=1e-6, err_msg=attr)


class _Terminal(io.StringIO):
    def __init__(self, tty):
        super().__init__()
        self.tty = tty

    def isatty(self):
        return self.tty


@pytest.mark.parametrize("tty", [True, False])
def test_live_batch_line_on_the_streaming_tier(mtx, tmp_path, monkeypatch,
                                               tty):
    """On a terminal the host-streaming tier writes the reference's
    ``\\r[batch] loss`` line, at most about once a second, and clears it
    at each epoch's end; off a terminal it writes none."""
    err = _Terminal(tty)
    monkeypatch.setattr(loop.sys, "stderr", err)
    epochs = 3
    t0 = time.monotonic()
    (_, losses), _ = _train(mtx[0], str(tmp_path / "s"), True, epochs=epochs,
                            stream=True)
    wall = time.monotonic() - t0
    text = err.getvalue()
    if not tty:
        assert "\r" not in text
        return
    lines = re.findall(r"\r\[ *(\d+)\] +(\S+)", text)
    # the first batch of every epoch shows; then one a second at most
    assert epochs <= len(lines) <= epochs + wall + 1
    for b, v in lines:
        assert 1 <= int(b) <= 6 and np.isfinite(float(v))
    # each epoch's line is cleared before its loss line
    assert text.count("\r") == len(lines) + epochs
    assert len(re.findall(r"\r\[[A-Z][a-z]{2} ", text)) == epochs
    assert len(losses) == epochs
