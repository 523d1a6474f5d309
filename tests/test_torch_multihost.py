"""The port's multi-process training (mmvae_tpu_torch/parallel/multihost.py
and the trainer CLIs' ``--num_hosts``), mirroring the JAX package's
tests/test_multihost.py: per-rank slices of the batch schedule, and a real
two-process ``nb_vae --num_hosts 2 --device cpu`` run on gloo.

Without ``--dp_shard`` a multi-process run has ``--data_parallel``
semantics, the single-device trajectory with the single-process run's
draws: its ``scores.gz`` equals the single-process run's (six significant
digits of text) and its recording artifacts (posteriors and parameters)
agree at ``rtol=1e-4, atol=1e-5`` of each file's largest value (the mean
of two ranks' half-batch means reassociates the batch's sums; JAX's test
holds its two-host run to ``rtol=1e-4, atol=2e-6``).  Rank 0 alone writes,
``--resume`` from the epoch-1 checkpoint equals the uninterrupted run
bitwise, and a run repeated gives the same bits; a rank whose peer leaves
mid-run exits non-zero.  Each rank has a 120 s ``timeout`` and
``MMVAE_DIST_TIMEOUT`` bounds its start-up.
"""

import gzip
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mmvae_tpu.io.writers import write_matrix_market_file
from mmvae_tpu_torch.cli import nb_vae
from mmvae_tpu_torch.data.block import MtxDataBlock
from mmvae_tpu_torch.io.index import build_mmutil_index
from mmvae_tpu_torch.parallel.mesh import DataMesh
from mmvae_tpu_torch.parallel.multihost import (choose_backend, host_slice,
                                                sharded_batches)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N_CELLS, B = 30, 90, 20  # 5 batches, the last wrapping around


def test_host_slice_partition():
    batch = np.arange(32)
    parts = [host_slice(batch, h, 4) for h in range(4)]
    assert np.array_equal(np.concatenate(parts), batch)
    assert all(len(p) == 8 for p in parts)
    with pytest.raises(ValueError, match="not divisible"):
        host_slice(np.arange(30), 0, 4)


def test_sharded_batches_union_equals_global(tmp_path):
    """Each rank's block reads its slice of every global batch (the last
    one wrapping around); side by side they are the global batches."""
    rng = np.random.default_rng(3)
    dens = rng.poisson(0.8, size=(D, N_CELLS)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    rr, cc = np.nonzero(dens)
    path = str(tmp_path / "d.mtx.gz")
    write_matrix_market_file(path, rr, cc, dens[rr, cc], (D, N_CELLS))
    idx = build_mmutil_index(path)
    H, GB = 4, 24
    per_host = [sharded_batches(N_CELLS, GB, h, H) for h in range(H)]
    blocks = [MtxDataBlock(path, idx, GB // H) for _ in range(H)]
    for b in range(len(per_host[0])):
        rows = []
        for h in range(H):
            blocks[h].clear()
            rows.append(blocks[h].read(per_host[h][b]).copy())
        gb = np.concatenate([per_host[h][b] for h in range(H)])
        assert np.array_equal(gb, (np.arange(GB) + b * GB) % N_CELLS)
        assert np.array_equal(np.concatenate(rows), dens[:, gb].T)


def test_backend_rule():
    assert choose_backend(["a/cuda:0", "a/cuda:1"])[0] == "nccl"
    assert choose_backend(["a/cuda:0", "b/cuda:0"])[0] == "nccl"
    assert choose_backend(["a/cuda:0", "a/cuda:0"])[0] == "gloo"
    assert choose_backend(["a/cpu", "a/cpu"])[0] == "gloo"
    assert choose_backend(["a/cuda:0", "b/cpu"])[0] == "gloo"


def test_mesh_rows():
    mesh = DataMesh(4, 2, torch.device("cpu"), "dp_shard")
    assert mesh.rows(20) == slice(10, 15) and mesh.shard
    with pytest.raises(ValueError, match="not divisible"):
        mesh.local_batch(30)
    with pytest.raises(ValueError, match="mode"):
        DataMesh(2, 0, torch.device("cpu"), "model")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def prefix_outputs(prefix: str) -> dict:
    """A CLI run's ``scores.gz`` and recording artifacts, decompressed
    (the gzip header holds the file's name), by suffix."""
    d, base = os.path.split(prefix)
    return {f[len(base):]: gzip.open(os.path.join(d, f)).read()
            for f in os.listdir(d)
            if f.startswith(base + "_") or f == base + ".scores.gz"}


def check_dp_flag(main, common, tmp, tmp_path, flags, capsys,
                  monkeypatch, **kw):
    """The data-parallel flags in one process (refused until they were
    ported): ``--data_parallel`` / ``--dp_shard`` log that a world of one
    trains the single-device step and give the bits of the fixture's
    unflagged run ``port``; ``--num_hosts 2`` with no peer raises within
    ``MMVAE_DIST_TIMEOUT`` naming the coordinator, before anything is
    written."""
    out = str(tmp_path / "x")
    if flags[0] == "--num_hosts":
        monkeypatch.setenv("MMVAE_DIST_TIMEOUT", "2")
        coord = f"127.0.0.1:{free_port()}"
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match=f"coordinator {coord} "):
            main(common + ["--out", out, "--device", "cpu", *flags,
                           "--coordinator", coord, "--host_id", "0"])
        assert time.monotonic() - t0 < 30
        assert not os.listdir(tmp_path)
        return
    assert main(common + ["--out", out, "--max_epoch", "2", "--device",
                          "cpu", *flags]) == 0
    assert f"{flags[0]}: one process, so the single-device step" in \
        capsys.readouterr().err
    want = prefix_outputs(str(tmp / "port"))
    assert len(want) == kw["n_outputs"] and prefix_outputs(out) == want


def _start_pair(args, rank1_args=()):
    """Two ``nb_vae --num_hosts 2 --device cpu`` ranks, started."""
    env = dict(os.environ, MMVAE_DIST_TIMEOUT="60",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    coord = f"127.0.0.1:{free_port()}"
    return [subprocess.Popen(
        [sys.executable, "-m", "mmvae_tpu_torch.cli.nb_vae", *args,
         "--device", "cpu", "--num_hosts", "2", "--host_id", str(r),
         "--coordinator", coord, *(rank1_args if r else ())],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]


def _wait_pair(procs, args, rank1_args=(), attempts=3):
    """Wait for a pair (120 s a rank); start it again when the
    coordinator's port was taken in between.  Returns rank 0's log."""
    for attempt in range(attempts):
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=120)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
        if all(p.returncode == 0 for p in procs):
            return outs[0]
        if not any("Address already in use" in o or "EADDRINUSE" in o
                   for o in outs) or attempt == attempts - 1:
            raise AssertionError("ranks failed:\n" + "\n---\n".join(
                o[-3000:] for o in outs))
        procs = _start_pair(args, rank1_args)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A single-process 2-epoch run with recording and a checkpoint; the
    same as two ranks, twice; two ranks for 1 epoch, then resumed to 2."""
    tmp = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(5)
    dens = rng.poisson(1.5, size=(D, N_CELLS)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    rr, cc = np.nonzero(dens)
    mtx = str(tmp / "train.mtx.gz")
    write_matrix_market_file(mtx, rr, cc, dens[rr, cc], (D, N_CELLS))
    build_mmutil_index(mtx, mtx + ".index")
    common = ["--mtx", mtx, "--batch_size", str(B), "--recording", "2"]

    def args(name, epochs, *extra):
        os.makedirs(tmp / name)
        return common + ["--out", str(tmp / name / "run"), "--max_epoch",
                         str(epochs), "--checkpoint_dir",
                         str(tmp / name / "ck"), *extra]

    started = []
    for name, epochs in (("a", 2), ("b", 2), ("r1", 1)):
        a = args(name, epochs)
        r1 = ["--checkpoint_dir", str(tmp / name / "ck_rank1")]
        started.append((_start_pair(a, r1), a, r1))
    assert nb_vae.main(args("single", 2) + ["--device", "cpu"]) == 0
    logs = [_wait_pair(*s) for s in started]
    a = args("r", 2, "--resume", str(tmp / "r1" / "ck"))
    logs.append(_wait_pair(_start_pair(a), a))
    return tmp, logs


def _outputs(d: str) -> dict:
    """A run's files, gzip ones decompressed (the gzip header holds the
    file's name), the checkpoint's arrays by name."""
    got = {}
    for f in sorted(os.listdir(d)):
        p = os.path.join(d, f)
        if f.endswith(".gz") and f.startswith("run"):
            with gzip.open(p) as fh:
                got[f] = fh.read()
        elif f == "ck":
            with np.load(os.path.join(p, "ckpt.npz")) as z:
                got.update({f"ck/{k}": z[k] for k in z.files})
    return got


def test_two_process_cli_matches_single_process(runs):
    tmp, logs = runs
    assert "backend gloo" in logs[0]
    assert "Data-parallel (data_parallel) over 2 processes" in logs[0]
    mh, single = _outputs(str(tmp / "a")), _outputs(str(tmp / "single"))
    assert mh.keys() == single.keys() and len(mh) > 28
    assert mh["run.scores.gz"] == single["run.scores.gz"]
    for k, want in single.items():
        if k.startswith("run_"):
            w = np.loadtxt(want.decode().splitlines(), ndmin=1)
            g = np.loadtxt(mh[k].decode().splitlines(), ndmin=1)
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=k)


def test_rank0_alone_writes(runs):
    """Rank 1's own checkpoint directory stays unmade, and the run's
    files are the single-process run's, one of each."""
    tmp, _ = runs
    for name in ("a", "b", "r1"):
        assert not os.path.exists(tmp / name / "ck_rank1")
    names = {f for f in os.listdir(tmp / "a")}
    assert names == {f for f in os.listdir(tmp / "single")}
    with open(tmp / "a" / "run.metrics.jsonl") as f:
        assert len(f.readlines()) == 2


def test_resume_equals_uninterrupted_bitwise(runs):
    tmp, logs = runs
    assert "Resumed from" in logs[3]
    got, want = _outputs(str(tmp / "r")), _outputs(str(tmp / "a"))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]) if isinstance(
            want[k], np.ndarray) else got[k] == want[k], k


def test_lost_peer_fails_the_run(tmp_path):
    """A rank whose peer leaves mid-run raises in its next collective and
    exits non-zero; it does not carry on alone.  Rank 1 stops after
    epoch 1, rank 0 goes on to epoch 2."""
    rng = np.random.default_rng(7)
    dens = rng.poisson(1.5, size=(D, 40)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    rr, cc = np.nonzero(dens)
    mtx = str(tmp_path / "m.mtx.gz")
    write_matrix_market_file(mtx, rr, cc, dens[rr, cc], (D, 40))
    build_mmutil_index(mtx, mtx + ".index")
    args = ["--mtx", mtx, "--batch_size", "20", "--out",
            str(tmp_path / "run"), "--max_epoch", "2"]
    for attempt in range(3):
        procs = _start_pair(args, ["--max_epoch", "1"])
        outs = [p.communicate(timeout=120)[0] for p in procs]
        if not any("Address already in use" in o for o in outs):
            break
    assert procs[1].returncode == 0, outs[1][-2000:]
    assert procs[0].returncode != 0, outs[0][-2000:]
    assert "[                   2]" not in outs[0]
    assert not os.path.exists(tmp_path / "run.scores.gz")


def test_two_runs_bitwise_equal(runs):
    tmp, _ = runs
    got, want = _outputs(str(tmp / "b")), _outputs(str(tmp / "a"))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]) if isinstance(
            want[k], np.ndarray) else got[k] == want[k], k


@pytest.mark.parametrize("covar", ["file", "auto_ones"])
def test_dp_tier_log_lines_match_jax(tmp_path, capfd, covar):
    """The tier of a ``--dp_shard`` rank and its log lines, against the
    JAX CLI's on the same inputs (two CPU devices there, two ranks' blocks
    here).  With a covariate file JAX logs "Auto-enabling on-device
    epochs" (the dense matrix fits) and then, the covariate not being the
    all-ones one, that it falls back to the host loop; the port's
    ``load_dp_batches`` logs the same two lines and streams.  With the
    all-ones covariate both load the dense-resident DP layout."""
    from mmvae_tpu_torch.data.block import MtxMemoryBlock, create_ones_like
    from mmvae_tpu_torch.train.config import TrainingOptions
    from mmvae_tpu_torch.train.loop import StreamedBatches, load_dp_batches

    N = 80  # a wrap-free schedule of 4 batches of 20
    rng = np.random.default_rng(9)
    dens = rng.poisson(1.5, size=(D, N)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    rr, cc = np.nonzero(dens)
    mtx = str(tmp_path / "m.mtx.gz")
    write_matrix_market_file(mtx, rr, cc, dens[rr, cc], (D, N))
    build_mmutil_index(mtx, mtx + ".index")
    args = ["--mtx", mtx, "--batch_size", "20", "--out",
            str(tmp_path / "jax"), "--max_epoch", "1", "--dp_shard"]
    cov = str(tmp_path / "cov.mtx.gz")
    if covar == "file":
        write_matrix_market_file(cov, np.zeros(N, np.int64),
                                 np.arange(N),
                                 np.full(N, 2.0, np.float32),
                                 (1, N))
        args += ["--covar", cov]
    env = dict(os.environ, JAX_PLATFORMS="cpu", MMVAE_FEATURE_PERM="0",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    r = subprocess.run([sys.executable, "-m", "mmvae_tpu.cli.nb_vae",
                        *args], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]

    def tier_lines(text):
        keys = ("Auto-enabling", "falling back to the host loop",
                "Loading data on device")
        return [ln.split("] ", 1)[1] for ln in text.splitlines()
                if any(k in ln for k in keys)]

    want = tier_lines(r.stderr)
    if covar == "auto_ones":
        create_ones_like(MtxMemoryBlock(mtx, mtx + ".index", 10), cov)
    build_mmutil_index(cov, cov + ".index")
    db = MtxMemoryBlock(mtx, mtx + ".index", 10)
    cb = MtxMemoryBlock(cov, cov + ".index", 10)
    cb.auto_ones = covar == "auto_ones"
    capfd.readouterr()
    source, _, ondevice = load_dp_batches(
        db, cb, TrainingOptions(dp_shard=True), "cpu",
        DataMesh(2, 0, torch.device("cpu"), "dp_shard"))
    got = tier_lines(capfd.readouterr().err)
    if covar == "file":
        assert got == want and len(want) == 2
        assert want[0].startswith("Auto-enabling on-device epochs")
        assert isinstance(source, StreamedBatches) and not ondevice
    else:
        # the same two decisions; the port's dense line also names the
        # rank's share
        assert [g.split(" (")[0] for g in got] == [w.split(" (")[0]
                                                  for w in want]
        assert "DP layout over 2" in got[1] and "DP layout over 2" in want[1]
        assert isinstance(source, torch.Tensor) and ondevice
