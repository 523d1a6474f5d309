"""The port's trainer (mmvae_tpu_torch.train, .cli.nb_vae) against the JAX
package's: the dense-resident epoch runner over two epochs fed JAX's
noise, the CLI's artifacts, and checkpoints with the Adam state resumed
across the two packages in both directions.

Tolerances: the JAX suite's trajectory yardstick (tests/test_nb_fast.py)
— per-batch reports ``rtol=2e-4``, parameters after two epochs
``rtol=3e-3, atol=2e-5``.  Artifact files are ``%g`` text, compared by
name and shape (their values come from differently seeded inits);
``scores.gz`` values carried through a checkpoint ``rel=1e-5`` (six
significant digits of text).
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
from mmvae_tpu.ops.losses import nb_loss
from mmvae_tpu.ops.nb_fast import NBFastStep as JFast
from mmvae_tpu.train import checkpoint as jck
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import Trainer, make_optimizer
from mmvae_tpu_torch.cli import nb_vae
from mmvae_tpu_torch.models.nb import NBVAE, adam_from_numpy, params_from_numpy
from mmvae_tpu_torch.ops.nb_fast import NBFastStep, rand_from_numpy
from mmvae_tpu_torch.train import checkpoint as tck
from mmvae_tpu_torch.train.config import TrainingOptions
from mmvae_tpu_torch.train.loop import DenseEpochRunner
from tests.test_torch_multihost import check_dp_flag

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N_CELLS = 30, 80


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("N,B", [(48, 16), (40, 16)])  # wrap-free / wrap
def test_dense_runner_two_epochs_matches_jax(N, B):
    D = 200
    rng = np.random.default_rng(4)
    x = rng.poisson(0.9, size=(N, D)).astype(np.int16)
    x[:, :3] += 12  # mixed-regime tiles
    jmodel = JNBVAE(data_dim=D, covar_dim=1)
    topt = JOptions(nboot=3, seed=5)
    jfast = JFast(jmodel, topt)
    trainer = Trainer(
        lambda p, xx, c, k, t: jmodel.forward(p, xx, c, k, t),
        lambda xx, o, b: nb_loss(xx, o, b), topt,
        report_loss_override=lambda p, xx, c, k, b: jmodel.fused_step_report(
            p, xx, c, k, b, include_data_const=True),
        boot_loss_override=lambda p, xx, c, k, b: jmodel.fused_step_boot(
            p, xx, c, k, b), fast_step=jfast)
    run = trainer.make_ondevice_epoch(types.SimpleNamespace(D=D), None, N, B,
                                      data_dense=jnp.asarray(x))
    jparams = jmodel.init(jax.random.PRNGKey(2))
    pnp = _np(jparams)
    jstate = trainer.optimizer.init(jparams)

    fast = NBFastStep(NBVAE(data_dim=D), TrainingOptions(nboot=3, seed=5))
    runner = DenseEpochRunner(fast, torch.from_numpy(x), B, seed=5)
    q = fast.pack(params_from_numpy(pnp))
    st = fast.optimizer.init(q)
    nbatch = -(-N // B)
    for epoch in range(2):
        jparams, jstate, jrep = run(jparams, jstate, epoch)
        rand = jax.jit(lambda: jfast.draw_rand(
            jax.random.fold_in(jax.random.PRNGKey(5), jnp.int32(epoch)),
            jnp.arange(nbatch, dtype=jnp.int32), B))()
        q, st, reps, _ = runner(q, st, epoch, rand=rand_from_numpy(_np(rand)))
        np.testing.assert_allclose(reps.numpy(), np.asarray(jrep), rtol=2e-4)
    got = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        lambda t: t.numpy(), fast.unpack(q))))
    for path, want in jax.tree_util.tree_leaves_with_path(_np(jparams)):
        np.testing.assert_allclose(got[path], want, rtol=3e-3, atol=2e-5,
                                   err_msg=str(path))
    assert int(st["count"]) == int(jstate[2].count) == 2 * nbatch * 3


def _run_jax(module, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", module] + args,
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A tiny mtx (D=30, N=80); a 2-epoch run of each CLI with recording
    and a checkpoint; then each package resumes the other's checkpoint."""
    tmp = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(5)
    dens = rng.poisson(1.5, size=(D, N_CELLS)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    rr, cc = np.nonzero(dens)
    mtx = str(tmp / "train.mtx.gz")
    write_matrix_market_file(mtx, rr, cc, dens[rr, cc], (D, N_CELLS))
    common = ["--mtx", mtx, "--batch_size", "40", "--recording", "2"]
    _run_jax("mmvae_tpu.cli.nb_vae", common + [
        "--out", str(tmp / "jax"), "--max_epoch", "2",
        "--checkpoint_dir", str(tmp / "jck")])
    assert nb_vae.main(common + [
        "--out", str(tmp / "port"), "--max_epoch", "2", "--device", "cpu",
        "--checkpoint_dir", str(tmp / "pck")]) == 0
    return tmp, common


def _artifacts(tmp, prefix):
    return {f[len(prefix):]: read_data_file(str(tmp / f)).shape
            for f in os.listdir(tmp)
            if f.startswith(prefix + "_") and f.endswith(".gz")}


def test_cli_artifacts_match_jax_cli(runs):
    tmp, _ = runs
    port, jx = _artifacts(tmp, "port"), _artifacts(tmp, "jax")
    assert port == jx and len(port) == 28
    assert port["_1.mu_mean.gz"] == (N_CELLS, 2)
    for name in ("port", "jax"):
        scores = [float(v) for v in read_vector_file(
            str(tmp / f"{name}.scores.gz"))]
        assert len(scores) == 2 and np.all(np.isfinite(scores))


def test_cli_metrics_keys_match_jax_cli(runs):
    """Every ``.metrics.jsonl`` row of the port has the keys the JAX CLI
    writes for the same flags: ``time_step`` each epoch, and
    ``time_record_submit`` on the recording epoch."""
    tmp, _ = runs
    rows = {}
    for name in ("port", "jax"):
        with open(tmp / f"{name}.metrics.jsonl") as f:
            rows[name] = [json.loads(ln) for ln in f]
    assert [set(r) for r in rows["port"]] == [set(r) for r in rows["jax"]]
    assert [r["epoch"] for r in rows["port"]] == [0, 1]
    assert "time_record_submit" in rows["port"][1]
    assert all(r["time_step"] >= 0 for r in rows["port"])


def test_port_checkpoint_loads_in_jax(runs):
    tmp, common = runs
    jmodel = JNBVAE(data_dim=D, covar_dim=1)
    tmpl = jmodel.init(jax.random.PRNGKey(0))
    params, opt, epoch, losses = jck.load_checkpoint(
        str(tmp / "pck"), tmpl, make_optimizer(JOptions()).init(tmpl))
    assert epoch == 2 and len(losses) == 2
    assert int(opt[2].count) == 2 * 2 * 3  # epochs x batches x nboot
    with np.load(str(tmp / "pck" / "ckpt.npz")) as z:
        np.testing.assert_array_equal(
            np.asarray(opt[2].mu["mu_decoding"]["weight"]),
            z["opt/[2].mu['mu_decoding']['weight']"])
        np.testing.assert_array_equal(np.asarray(params["x_mean"]),
                                      z["params/x_mean"])
    # and the JAX trainer resumes it for one more epoch
    _run_jax("mmvae_tpu.cli.nb_vae", common + [
        "--out", str(tmp / "jres"), "--max_epoch", "3",
        "--resume", str(tmp / "pck")])
    scores = [float(v) for v in read_vector_file(str(tmp / "jres.scores.gz"))]
    assert len(scores) == 3 and scores[:2] == pytest.approx(losses, rel=1e-5)


def test_jax_checkpoint_resumes_in_port(runs):
    tmp, common = runs
    model = NBVAE(data_dim=D)
    jmodel = JNBVAE(data_dim=D, covar_dim=1)
    tmpl = jmodel.init(jax.random.PRNGKey(0))
    _, jopt, _, jlosses = jck.load_checkpoint(
        str(tmp / "jck"), tmpl, make_optimizer(JOptions()).init(tmpl))
    opt = tck.load_opt_state(str(tmp / "jck"), model)
    assert int(opt["count"]) == int(jopt[2].count) == 12
    port = adam_from_numpy(opt)
    for path, want in jax.tree_util.tree_leaves_with_path(_np(jopt[2].nu)):
        got = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
            lambda t: t.numpy(), port["nu"])))[path]
        np.testing.assert_array_equal(got, want)
    assert nb_vae.main(common + [
        "--out", str(tmp / "pres"), "--max_epoch", "3", "--device", "cpu",
        "--resume", str(tmp / "jck")]) == 0
    scores = [float(v) for v in read_vector_file(str(tmp / "pres.scores.gz"))]
    assert len(scores) == 3 and scores[:2] == pytest.approx(jlosses, rel=1e-5)
    assert np.isfinite(scores[2])


def test_opt_checkpoint_keys_match_jax(tmp_path):
    """Same parameters and Adam state: the port writes exactly the npz
    keys and treedef text that the JAX checkpoint writer does."""
    jmodel = JNBVAE(data_dim=7, covar_dim=1)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jstate = make_optimizer(JOptions()).init(jparams)
    jck.save_checkpoint(str(tmp_path / "j"), jparams, jstate, 0, 0, [1.0])
    named = {"count": np.int32(0), "mu": _np(jstate[2].mu),
             "nu": _np(jstate[2].nu)}
    tck.save_checkpoint(str(tmp_path / "p"), params_from_numpy(_np(jparams)),
                        0, 0, [1.0], opt_state=named)
    with np.load(str(tmp_path / "j" / "ckpt.npz")) as a, \
            np.load(str(tmp_path / "p" / "ckpt.npz")) as b:
        assert set(a.files) == set(b.files)
        meta_a = a["__meta__"].tobytes()
        meta_b = b["__meta__"].tobytes()
    assert meta_a == meta_b


def test_device_cuda_without_gpu_fails(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")
    _, common = runs
    assert nb_vae.main(common + ["--out", str(tmp_path / "x"),
                                 "--device", "cuda"]) == 2
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flags", [["--data_parallel"],
                                   ["--num_hosts", "2"], ["--dp_shard"],
                                   ["--tensor_parallel", "2"]])
def test_unported_options_raise(runs, tmp_path, flags, capsys,
                                monkeypatch):
    """``--tensor_parallel 2`` raises naming its ROADMAP.md item; the
    data-parallel flags as
    :func:`tests.test_torch_multihost.check_dp_flag` says."""
    tmp, common = runs
    if flags[0] != "--tensor_parallel":
        check_dp_flag(nb_vae.main, common, tmp, tmp_path, flags, capsys,
                       monkeypatch, n_outputs=29)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        nb_vae.main(common + ["--out", str(tmp_path / "x"), "--device",
                              "cpu", *flags])


def test_beyond_dense_budget_raises(runs, tmp_path, monkeypatch, capfd):
    """Beyond ``MMVAE_DENSE_BYTES`` the run no longer raises: it trains on
    the rotating tier and gives the dense-resident run's ``scores.gz``
    bits.  (The name is the test's from before the tier was ported.)"""
    _, common = runs
    args = common + ["--max_epoch", "2", "--device", "cpu"]
    assert nb_vae.main(args + ["--out", str(tmp_path / "d")]) == 0
    monkeypatch.setenv("MMVAE_DENSE_BYTES", "1")
    capfd.readouterr()
    assert nb_vae.main(args + ["--out", str(tmp_path / "r")]) == 0
    assert "host-resident shards through HBM" in capfd.readouterr().err
    scores = [gzip.open(tmp_path / f"{t}.scores.gz").read() for t in "dr"]
    assert scores[0] == scores[1]


def test_covariate_file_reaches_the_step(runs, tmp_path):
    """``--covar`` with an all-ones file goes through the dense covariate
    path and trains exactly like the generated all-ones covariate; a
    covariate of twos trains differently."""
    _, common = runs
    scores = []
    for value in (None, 1.0, 2.0):
        args = common + ["--out", str(tmp_path / f"c{value}"),
                         "--max_epoch", "1", "--device", "cpu"]
        if value is not None:
            cov = str(tmp_path / f"cov{value}.mtx.gz")
            write_matrix_market_file(cov, np.zeros(N_CELLS, np.int64),
                                     np.arange(N_CELLS),
                                     np.full(N_CELLS, value, np.float32),
                                     (1, N_CELLS))
            args += ["--covar", cov]
        assert nb_vae.main(args) == 0
        scores.append(read_vector_file(str(tmp_path / f"c{value}.scores.gz")))
    assert scores[0] == scores[1] and scores[2] != scores[0]
