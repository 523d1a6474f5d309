"""The port's tensor-parallel CLIs end to end on four gloo ranks:
``nb_vae``, ``vmf_vae``, ``vmfnb_vae`` and ``vmfnb_vae --annot --row``
with ``--tensor_parallel``, and ``encode --tensor_parallel``.

Four processes of this file (``--worker``) meet once for the module and
run every CLI in turn (``--num_hosts 4``; ``--tensor_parallel 2`` makes
the (2, 2) grid, ``--tensor_parallel 4`` the (1, 4) one):

- ``nb_vae`` at (2, 2), 2 epochs with recording and a checkpoint, twice
  (bitwise equal), once for 1 epoch and resumed to 2 (bitwise equal to
  the uninterrupted run), and on the host-streaming tier
  (``--no_auto_ondevice``: the same bits as the dense-resident TP
  layout); rank 0 alone writes;
- ``nb_vae`` at (1, 4) for 2 epochs, held to the port's single-process
  generic ``Trainer`` on the full parameters fed the same draws (data
  index 0) at :data:`TP_TOL`;
- a checkpoint of the JAX package's TP trainer (``mmvae_tpu.cli.nb_vae
  --tensor_parallel 2`` on two CPU devices) resumed by the port, and the
  port's resumed by JAX's TP trainer; each package refuses the other
  chain's layout where it was not asked for;
- ``vmfnb_vae``, ``vmfnb_vae --annot --row`` and ``vmf_vae`` at (2, 2)
  for 1 epoch with a checkpoint;
- ``encode --tensor_parallel 2`` of the four models' checkpoints (a data
  axis of 2), and of the NB one at ``--tensor_parallel 4`` and with one
  batch (JAX's idle-ranks line), against the one-process sweep: the
  posteriors at ``rtol=1e-4, atol=1e-5`` (the TP encoder is the plain
  unfolded one, the one-process sweep the folded one), the mixture's
  assignments equal.
"""

import gzip
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmvae_tpu.io.writers import write_matrix_market_file
from mmvae_tpu_torch.cli import encode as port_encode
from mmvae_tpu_torch.io.writers import read_data_file, read_vector_file
from mmvae_tpu_torch.train import checkpoint as tck
from tests.test_torch_multihost import free_port
from tests.test_torch_tp_train import wait_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N, B, WORLD = 40, 80, 20, 4
# the DP phase's yardstick (chip_smoke.DP_TOL): the TP ranks' kernels and
# sums see D / N columns where the single process sees D
TP_TOL = dict(scores=2e-4, rtol=3e-3, atol=2e-5)


def _env(**kw):
    return dict(os.environ, JAX_PLATFORMS="cpu", MMVAE_DIST_TIMEOUT="60",
                MMVAE_FEATURE_PERM="0",
                PYTHONPATH=os.pathsep.join(
                    p for p in (ROOT, os.environ.get("PYTHONPATH")) if p),
                **kw)


def _run_jax(args):
    r = subprocess.run(
        [sys.executable, "-m", "mmvae_tpu.cli.nb_vae", *args],
        capture_output=True, text=True, timeout=600,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=2"))
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stderr


def plan(tmp):
    """The workers' CLI runs, in order: (name, cli, argv)."""
    mtx, annot, row = (str(tmp / f) for f in ("m.mtx.gz", "annot.txt",
                                              "rows.txt"))
    runs = []

    def run(name, cli, *extra, epochs=2, tp=2):
        os.makedirs(tmp / name)
        runs.append((name, cli, [
            "--mtx", mtx, "--batch_size", str(B), "--recording", "2",
            "--device", "cpu", "--out", str(tmp / name / "run"),
            "--max_epoch", str(epochs), "--tensor_parallel", str(tp),
            "--checkpoint_dir", str(tmp / name / "ck"), *extra]))

    run("a", "nb_vae")
    run("b", "nb_vae")
    run("r1", "nb_vae", epochs=1)
    run("r", "nb_vae", "--resume", str(tmp / "r1" / "ck"))
    run("s", "nb_vae", "--no_auto_ondevice")
    run("q", "nb_vae", tp=4)
    run("jr", "nb_vae", "--resume", str(tmp / "jck"))
    run("joint", "vmfnb_vae", epochs=1)
    run("mixture", "vmfnb_vae", "--annot", annot, "--row", row, epochs=1)
    run("vmf", "vmf_vae", epochs=1)
    os.makedirs(tmp / "enc")
    for model, ck in (("nb", "a"), ("vmfnb", "joint"),
                      ("mixture", "mixture"), ("vmf", "vmf")):
        for tp, bs in ((2, B), (4, B), (2, N)):
            if (tp, bs) != (2, B) and model != "nb":
                continue
            out = tmp / "enc" / f"{model}_{tp}_{bs}"
            runs.append((f"enc_{model}_{tp}_{bs}", "encode", [
                "--model", model, "--mtx", mtx, "--checkpoint",
                str(tmp / ck / "ck"), "--out", str(out), "--batch_size",
                str(bs), "--device", "cpu", "--tensor_parallel", str(tp),
                "--annot", annot, "--row", row, "--seed", "3"]))
    return runs


def _worker(rank: int, coord: str, tmp: str) -> None:
    import contextlib
    import io

    from mmvae_tpu_torch.cli import encode, nb_vae, vmf_vae, vmfnb_vae
    from mmvae_tpu_torch.parallel.multihost import init_multihost

    torch.set_num_threads(1)
    init_multihost(coord, WORLD, rank, torch.device("cpu"))
    clis = {"nb_vae": nb_vae, "vmf_vae": vmf_vae, "vmfnb_vae": vmfnb_vae,
            "encode": encode}
    with open(os.path.join(tmp, "plan.pkl"), "rb") as f:
        runs = pickle.load(f)
    logs = {}
    for name, cli, argv in runs:
        argv = argv + ["--num_hosts", str(WORLD), "--host_id", str(rank),
                       "--coordinator", coord]
        if rank and cli != "encode":
            argv += ["--checkpoint_dir",
                     os.path.join(tmp, name, f"ck_rank{rank}")]
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert clis[cli].main(argv) == 0, name
        logs[name] = err.getvalue()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(logs, f)
    torch.distributed.destroy_process_group()


def _start_ranks(tmp):
    coord = f"127.0.0.1:{free_port()}"
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         coord, str(tmp)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tpcli")
    rng = np.random.default_rng(4)
    dens = rng.poisson(1.5, size=(D, N)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    dens[:3, :2] += 12  # counts of the mixed lgamma regime
    rr, cc = np.nonzero(dens)
    mtx = str(tmp / "m.mtx.gz")
    write_matrix_market_file(mtx, rr, cc, dens[rr, cc], (D, N))
    (tmp / "rows.txt").write_text("".join(f"gene{i}\n" for i in range(D)))
    (tmp / "annot.txt").write_text(
        "".join(f"gene{i} T{i % 3}\n" for i in range(26)))
    # the JAX package's TP trainer: 1 epoch and a checkpoint
    jlog = _run_jax(["--mtx", mtx, "--batch_size", str(B), "--out",
                     str(tmp / "jax"), "--max_epoch", "1",
                     "--tensor_parallel", "2", "--checkpoint_dir",
                     str(tmp / "jck")])
    with open(tmp / "plan.pkl", "wb") as f:
        pickle.dump(plan(tmp), f)
    wait_ranks(_start_ranks, tmp, timeout=500)
    logs = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            logs.append(pickle.load(f))
    return tmp, logs, jlog


def _outputs(d) -> dict:
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


def _same(got, want):
    assert got.keys() == want.keys() and len(want) > 28
    for k in want:
        assert (np.array_equal(got[k], want[k])
                if isinstance(want[k], np.ndarray) else got[k] == want[k]), k


def test_tp_cli_grid_tier_and_rank0_writes(runs):
    tmp, logs, _ = runs
    assert ("Tensor-parallel over (data=2, model=2) processes: rank 3 at "
            "data index 1, model index 1") in logs[3]["a"]
    assert ("Loading data on device (dense-resident, TP layout over "
            "(data=2, model=2)") in logs[0]["a"]
    assert "generic step, tensor parallel" in logs[0]["a"]
    assert "model=4" in logs[0]["q"] and "features [30, 40) of 40" in \
        logs[3]["q"]
    for name in ("a", "b", "r1", "r", "s", "q", "jr", "joint", "mixture",
                 "vmf"):
        for r in range(1, WORLD):
            assert not os.path.exists(tmp / name / f"ck_rank{r}")
        scores = [float(v) for v in read_vector_file(
            str(tmp / name / "run.scores.gz"))]
        assert np.all(np.isfinite(scores)) and len(scores) in (1, 2), name
    with np.load(tmp / "a" / "ck" / "ckpt.npz") as z:
        assert "opt/[1].count" in z.files and "opt/[2].count" not in z.files
        assert z["params/mu_decoding/weight"].shape == (2, D)  # full


def test_tp_runs_repeat_and_resume_bitwise(runs):
    tmp, logs, _ = runs
    want = _outputs(tmp / "a")
    _same(_outputs(tmp / "b"), want)
    assert "Resumed from" in logs[0]["r"]
    _same(_outputs(tmp / "r"), want)


def test_tp_host_streaming_tier_equals_dense_resident(runs):
    tmp, logs, _ = runs
    assert "TP layout" not in logs[0]["s"]
    _same(_outputs(tmp / "s"), _outputs(tmp / "a"))


def test_tp_matches_single_process_trainer(runs):
    """The (1, 4) run against the port's generic ``Trainer`` (the
    non-TP fused step) in one process on the full parameters, the same
    draws (data index 0 of a data axis of 1), the dense-resident epochs
    of ``DenseEpochRunner``."""
    from mmvae_tpu_torch.cli.common import prepare_blocks
    from mmvae_tpu_torch.models.nb import NBVAE
    from mmvae_tpu_torch.train.config import MMVaeOptions, TrainingOptions
    from mmvae_tpu_torch.train.loop import (DenseEpochRunner, Trainer,
                                            build_dense, epoch_generator)

    tmp, _, _ = runs
    topt = TrainingOptions(seed=0)
    model = NBVAE(data_dim=D)
    tr = Trainer(None, None, topt, eps_widths=(2, 1),
                 report_loss_override=lambda p, x, c, e, b:
                 model.fused_step_report(p, x, c, e, b),
                 boot_loss_override=lambda p, x, c, e, b:
                 model.fused_step_boot(p, x, c, e, b, need_value=False))
    db, _ = prepare_blocks(MMVaeOptions(
        mtx=str(tmp / "m.mtx.gz"), idx=str(tmp / "m.mtx.gz.index"),
        out=str(tmp / "single"), batch_size=B))
    runner = DenseEpochRunner(tr, build_dense(db, "cpu"), B, seed=0)
    q = model.init(torch.Generator().manual_seed(0))
    st = tr.optimizer.init(q)
    reps = []
    for epoch in range(2):
        rand = tr.draw_rand(epoch_generator(0, epoch, "cpu", 0),
                            runner.nbatch, B)
        q, st, rep, _ = runner(q, st, epoch, rand=rand)
        reps.append(float(rep.mean()))
    got = [float(v) for v in read_vector_file(str(tmp / "q" /
                                                  "run.scores.gz"))]
    np.testing.assert_allclose(got, reps, rtol=TP_TOL["scores"])
    with np.load(tmp / "q" / "ck" / "ckpt.npz") as z:
        for k, v in q.items():
            leaves = v.items() if isinstance(v, dict) else [(None, v)]
            for kk, t in leaves:
                w = t.numpy()
                g = z[f"params/{k}" + (f"/{kk}" if kk else "")]
                np.testing.assert_allclose(
                    g, w, rtol=TP_TOL["rtol"],
                    atol=TP_TOL["atol"] * np.abs(w).max(), err_msg=k)


def test_tp_checkpoints_resume_across_packages(runs):
    """JAX's TP checkpoint resumes in the port (its epoch-0 score kept)
    and the port's in JAX's TP trainer; neither loads as the other
    chain."""
    import jax

    from mmvae_tpu.models.nb import NBVAE as JNBVAE
    from mmvae_tpu.train.checkpoint import load_checkpoint as jload
    from mmvae_tpu.train.config import TrainingOptions as JOptions
    from mmvae_tpu.train.loop import make_optimizer
    from mmvae_tpu_torch.models.nb import NBVAE

    tmp, logs, _ = runs
    jscores = [float(v) for v in read_vector_file(str(tmp / "jax.scores.gz"))]
    got = [float(v) for v in read_vector_file(str(tmp / "jr" /
                                                  "run.scores.gz"))]
    assert "Resumed from" in logs[0]["jr"]
    assert len(got) == 2 and got[0] == jscores[0] and np.isfinite(got[1])
    # the port reads JAX's TP layout only as the TP chain
    model = NBVAE(data_dim=D)
    opt = tck.load_opt_state(str(tmp / "jck"), model, tp=True)
    assert int(opt["count"]) == 4 * 3
    with pytest.raises(ValueError, match="structure differs"):
        tck.load_opt_state(str(tmp / "jck"), model)
    # JAX's TP trainer resumes the port's TP checkpoint; its non-TP
    # template refuses it
    tmpl = JNBVAE(data_dim=D, covar_dim=1).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="structure changed"):
        jload(str(tmp / "a" / "ck"), tmpl,
              make_optimizer(JOptions()).init(tmpl))
    _, jopt, epoch, losses = jload(str(tmp / "a" / "ck"), tmpl,
                                   make_optimizer(JOptions(), tp=True)
                                   .init(tmpl))
    assert epoch == 2 and int(jopt[1].count) == 2 * 4 * 3
    _run_jax(["--mtx", str(tmp / "m.mtx.gz"), "--batch_size", str(B),
              "--out", str(tmp / "jres"), "--max_epoch", "3",
              "--tensor_parallel", "2", "--resume", str(tmp / "a" / "ck")])
    scores = [float(v) for v in read_vector_file(str(tmp / "jres.scores.gz"))]
    assert len(scores) == 3 and scores[:2] == pytest.approx(losses,
                                                            rel=1e-6)
    assert np.isfinite(scores[2])


@pytest.mark.parametrize("case", ["nb_2_20", "nb_4_20", "nb_2_80",
                                  "vmfnb_2_20", "mixture_2_20",
                                  "vmf_2_20"])
def test_tp_encode_matches_one_process_sweep(runs, case, tmp_path):
    tmp, logs, _ = runs
    model, tp, bs = case.split("_")
    ck = {"nb": "a", "vmfnb": "joint", "mixture": "mixture",
          "vmf": "vmf"}[model]
    args = ["--model", model, "--mtx", str(tmp / "m.mtx.gz"),
            "--checkpoint", str(tmp / ck / "ck"), "--batch_size", bs,
            "--device", "cpu", "--annot", str(tmp / "annot.txt"), "--row",
            str(tmp / "rows.txt"), "--seed", "3"]
    assert port_encode.main(args + ["--out", str(tmp_path / "one")]) == 0
    log = logs[0][f"enc_{case}"]
    ndata = 1 if (tp, bs) != ("2", "20") else 2
    assert f"TP serving over (data={ndata}, model={tp})" in log
    if bs == "80":
        assert "note: 2 of 4 devices idle" in log
    names = {"vmf": ("latent_mean", "latent_lnvar")}.get(
        model, ("mu_mean", "mu_lnvar"))
    names += ("clust",) if model == "mixture" else ()
    for name in names:
        want = read_data_file(f"{tmp_path}/one.{name}.gz")
        got = read_data_file(f"{tmp}/enc/{case}.{name}.gz")
        assert got.shape == want.shape and want.shape[0] == N
        if name == "clust":
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
