"""The training loop's own timing and spans on the CPU: the epoch rows
``DenseEpochRunner`` leaves in ``SuperbatchGraphs.stats["epochs"]``
(the host clock stands in for the card's timing events in the eager
form), the ``annotate`` spans of the loop's host phases under a running
``torch.profiler``, and that neither changes a result."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from mmvae_tpu_torch.data.block import (MtxDataBlock, MtxMemoryBlock,
                                        create_ones_like)
from mmvae_tpu_torch.io.index import build_mmutil_index
from mmvae_tpu_torch.io.writers import write_matrix_market_file
from mmvae_tpu_torch.models.nb import NBVAE
from mmvae_tpu_torch.ops.nb_fast import NBFastStep
from mmvae_tpu_torch.train import superbatch
from mmvae_tpu_torch.train.config import TrainingOptions
from mmvae_tpu_torch.train.loop import DenseEpochRunner, train_vae_model
from mmvae_tpu_torch.utils import profiling

D, B, N = 50, 10, 66  # 7 batches, the last wrapping around
NBATCH = 7
SPANS = ("epoch.draw", "superbatch.fill", "superbatch.replay", "epoch.state")


def _setup(S, record=False):
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.poisson(1.1, size=(N, D)).astype(np.int16))
    data[::4, :3] += 9  # mixed lgamma regimes
    model = NBVAE(data_dim=D)
    fast = NBFastStep(model, TrainingOptions(nboot=2))
    record_fn = None
    if record:
        enc, _ = model.record_encoder(0, B)

        def record_fn(p, x):
            with torch.no_grad():
                return enc(p, x)
    runner = DenseEpochRunner(fast, data, B, seed=3, record_fn=record_fn,
                              superbatch=S)
    q = fast.pack(model.init(torch.Generator().manual_seed(0)))
    return runner, q, fast.optimizer.init(q)


def _epochs(S, n=3, record=False):
    runner, q, po = _setup(S, record)
    outs = []
    for epoch in range(n):
        q, po, reps, enc = runner(q, po, epoch, record=record)
        outs.append((q, po, reps, enc))
    runner.close()
    return outs


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [tree]


def _assert_bitwise(got, want):
    gl, wl = _leaves(got), _leaves(want)
    assert len(gl) == len(wl) > 0
    for a, b in zip(gl, wl):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("S", [1, 3, 8])
def test_epoch_rows(S, record):
    """One row per epoch, read in the next epoch (the last in
    ``close``): its replays and batches, replay time inside the span, no
    epoch boundary before the first."""
    runner, q, po = _setup(S, record)
    rows = []
    for epoch in range(3):
        q, po, reps, _ = runner(q, po, epoch, record=record)
        float(reps.mean())  # the caller's loss fetch
        rows.append(len(runner.graph_stats["epochs"]))
    assert rows == [0, 1, 2]
    runner.close()
    st = runner.graph_stats
    assert st["rows_dropped"] == 0
    assert [r["epoch"] for r in st["epochs"]] == [0, 1, 2]
    for i, r in enumerate(st["epochs"]):
        assert r["replays"] == -(-NBATCH // S)
        assert r["batches"] == NBATCH
        assert 0 < r["replay_s"] <= r["span_s"]
        assert (r["lead_s"] is None) == (i == 0)
        assert i == 0 or r["lead_s"] >= 0
    if st["form"] != "eager":
        assert st["capture_s"] == pytest.approx(
            st["capture_warm_s"] + st["capture_graph_s"], rel=1e-12)
    else:
        assert st["captures"] == 0 and st["capture_s"] == 0.0


def test_pending_epoch_is_dropped(monkeypatch):
    """An epoch whose events the card has not passed when its row is
    read is counted in ``rows_dropped``, not kept; the next epochs'
    rows are kept as before."""
    runner, q, po = _setup(3)
    q, po, _, _ = runner(q, po, 0)
    monkeypatch.setattr(superbatch._HostEvent, "query", lambda self: False)
    q, po, _, _ = runner(q, po, 1)
    monkeypatch.undo()
    q, po, _, _ = runner(q, po, 2)
    runner.close()
    st = runner.graph_stats
    assert st["rows_dropped"] == 1
    assert [r["epoch"] for r in st["epochs"]] == [1, 2]
    assert st["epochs"][0]["lead_s"] is not None


def test_row_is_read_after_the_first_replay():
    """The last epoch's row is read once this epoch's first replay is
    enqueued, not before its start is marked: the draws see no row yet,
    the first superbatch's callback sees it."""
    runner, q, po = _setup(3)
    q, po, _, _ = runner(q, po, 0)
    seen = []
    draw = runner.draw

    def counted_draw(epoch):
        seen.append(("draw", len(runner.graph_stats["epochs"])))
        return draw(epoch)

    runner.draw = counted_draw
    runner(q, po, 1, on_batch=lambda b, rep: seen.append(
        (b, len(runner.graph_stats["epochs"]))))
    runner.close()
    assert seen == [("draw", 0), (2, 1), (5, 1), (6, 1)]
    assert [r["epoch"] for r in runner.graph_stats["epochs"]] == [0, 1]


def test_per_batch_path_keeps_no_rows():
    runner, q, po = _setup(None)
    runner(q, po, 0)
    runner.close()
    assert runner.graph_stats == {}


def test_profiler_changes_no_result():
    """Reports, record outputs and state are bitwise the same with a
    torch profiler running over the epochs."""
    want = _epochs(3, record=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = _epochs(3, record=True)
    _assert_bitwise(got, want)


def test_spans_under_profiler():
    """A profiled epoch holds the loop's spans: one draw and one state
    copy an epoch, a fill and a replay a superbatch."""
    runner, q, po = _setup(3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        runner(q, po, 0)
    runner.close()
    names = [e.name for e in prof.events()]
    counts = {n: names.count(n) for n in SPANS}
    assert counts == {"epoch.draw": 1, "superbatch.fill": 3,
                      "superbatch.replay": 3, "epoch.state": 1}


def test_annotate_is_null_without_profiler():
    assert isinstance(profiling.annotate("x"), contextlib.nullcontext)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert not isinstance(profiling.annotate("x"),
                              contextlib.nullcontext)
    assert isinstance(profiling.annotate("x"), contextlib.nullcontext)


def test_trace_dir_covers_set_up(tmp_path, monkeypatch):
    """``MMVAE_TRACE_DIR`` traces the whole ``train_vae_model`` call:
    the set-up's feature clustering as well as the epochs' spans."""
    rng = np.random.default_rng(2)
    x = rng.poisson(0.8, size=(40, 32)).astype(np.float32)
    x[:, 5] += 30  # one hot gene, so the clustering engages
    rr, cc = np.nonzero(x.T)
    order = np.lexsort((rr, cc))
    mtx = str(tmp_path / "m.mtx.gz")
    write_matrix_market_file(mtx, rr[order], cc[order],
                             x.T[rr, cc][order], x.T.shape)
    build_mmutil_index(mtx, mtx + ".index")
    data = MtxMemoryBlock(mtx, mtx + ".index", B, count_dtype="auto")
    cov = str(tmp_path / "cov.mtx.gz")
    create_ones_like(data, cov)
    build_mmutil_index(cov, cov + ".index")
    covar = MtxDataBlock(cov, cov + ".index", B)
    covar.auto_ones = True
    model = NBVAE(data_dim=x.shape[1])
    topt = TrainingOptions(nboot=2, max_epoch=2, recording=5, seed=0,
                           superbatch=3)
    monkeypatch.setenv("MMVAE_FEATURE_PERM", "force")
    monkeypatch.setenv("MMVAE_TRACE_DIR", str(tmp_path / "tr"))
    train_vae_model(NBFastStep(model, topt), None, data, covar, topt,
                    model.init(torch.Generator().manual_seed(0)), "cpu",
                    feature_perm=True)
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1
    with open(tmp_path / "tr" / files[0]) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    counts = {n: names.count(n) for n in ("cluster_features", *SPANS)}
    assert counts == {"cluster_features": 1, "epoch.draw": 2,
                      "superbatch.fill": 4, "superbatch.replay": 4,
                      "epoch.state": 2}
