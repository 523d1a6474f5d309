"""The port's joint trainer and serving CLIs (``mmvae_tpu_torch.cli.
vmfnb_vae``, ``encode --model vmfnb``) against the JAX package's: the
artifacts, checkpoints with the Adam state resumed across the two
packages in both directions, and the encoded posteriors of one
checkpoint.

Tolerances: artifact files are ``%g`` text, compared by name and shape
(their values come from differently seeded inits); ``scores.gz`` values
carried through a checkpoint ``rel=1e-5`` (six significant digits of
text); encoded posteriors ``rtol=1e-4, atol=1e-5`` (six-digit text, and
the port folds the row norm into the contraction).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mmvae_tpu.io.writers import (read_data_file, read_vector_file,
                                  write_matrix_market_file)
from mmvae_tpu.models.vmfnb import VMFNBVAE as JVAE
from mmvae_tpu.train import checkpoint as jck
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import make_optimizer
from mmvae_tpu_torch.cli import encode as port_encode
from mmvae_tpu_torch.cli import vmfnb_vae
from mmvae_tpu_torch.models.nb import adam_from_numpy
from mmvae_tpu_torch.models.vmfnb import VMFNBVAE
from mmvae_tpu_torch.train import checkpoint as tck
from tests.test_torch_multihost import check_dp_flag

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N_CELLS = 30, 80


def _run_jax(module, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               MMVAE_FEATURE_PERM="0")
    r = subprocess.run([sys.executable, "-m", module] + args,
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A tiny mtx (D=30, N=80); a 2-epoch run of each joint CLI with
    recording and a checkpoint; the JAX encode of the JAX checkpoint."""
    tmp = tmp_path_factory.mktemp("joint")
    rng = np.random.default_rng(6)
    dens = rng.poisson(1.5, size=(D, N_CELLS)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    rr, cc = np.nonzero(dens)
    mtx = str(tmp / "train.mtx.gz")
    write_matrix_market_file(mtx, rr, cc, dens[rr, cc], (D, N_CELLS))
    common = ["--mtx", mtx, "--batch_size", "40", "--recording", "2"]
    _run_jax("mmvae_tpu.cli.vmfnb_vae", common + [
        "--out", str(tmp / "jax"), "--max_epoch", "2",
        "--checkpoint_dir", str(tmp / "jck")])
    _run_jax("mmvae_tpu.cli.encode", [
        "--model", "vmfnb", "--mtx", mtx, "--checkpoint", str(tmp / "jck"),
        "--out", str(tmp / "jenc"), "--batch_size", "40"])
    assert vmfnb_vae.main(common + [
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
    assert port["_1_vmf_mu_decoding.weight.gz"] == (D, 2)
    for name in ("port", "jax"):
        scores = [float(v) for v in read_vector_file(
            str(tmp / f"{name}.scores.gz"))]
        assert len(scores) == 2 and np.all(np.isfinite(scores))


def _jax_template():
    tmpl = JVAE(data_dim=D).init(jax.random.PRNGKey(0))
    return tmpl, make_optimizer(JOptions()).init(tmpl)


def test_port_checkpoint_loads_in_jax(runs):
    tmp, common = runs
    params, opt, epoch, losses = jck.load_checkpoint(str(tmp / "pck"),
                                                     *_jax_template())
    assert epoch == 2 and len(losses) == 2
    assert int(opt[2].count) == 2 * 2 * 3  # epochs x batches x nboot
    with np.load(str(tmp / "pck" / "ckpt.npz")) as z:
        np.testing.assert_array_equal(
            np.asarray(opt[2].mu["ln_kappa"]["weight"]),
            z["opt/[2].mu['ln_kappa']['weight']"])
        np.testing.assert_array_equal(np.asarray(params["mu_bias"]),
                                      z["params/mu_bias"])
    # and the JAX trainer resumes it for one more epoch
    _run_jax("mmvae_tpu.cli.vmfnb_vae", common + [
        "--out", str(tmp / "jres"), "--max_epoch", "3",
        "--resume", str(tmp / "pck")])
    scores = [float(v) for v in read_vector_file(str(tmp / "jres.scores.gz"))]
    assert len(scores) == 3 and scores[:2] == pytest.approx(losses, rel=1e-5)


def test_jax_checkpoint_resumes_in_port(runs):
    tmp, common = runs
    model = VMFNBVAE(data_dim=D)
    _, jopt, _, jlosses = jck.load_checkpoint(str(tmp / "jck"),
                                              *_jax_template())
    opt = tck.load_opt_state(str(tmp / "jck"), model)
    assert int(opt["count"]) == int(jopt[2].count) == 12
    port = adam_from_numpy(opt)
    np.testing.assert_array_equal(
        port["nu"]["vmf_mu_decoding"]["bias"].numpy(),
        np.asarray(jopt[2].nu["vmf_mu_decoding"]["bias"]))
    assert vmfnb_vae.main(common + [
        "--out", str(tmp / "pres"), "--max_epoch", "3", "--device", "cpu",
        "--resume", str(tmp / "jck")]) == 0
    scores = [float(v) for v in read_vector_file(str(tmp / "pres.scores.gz"))]
    assert len(scores) == 3 and scores[:2] == pytest.approx(jlosses, rel=1e-5)
    assert np.isfinite(scores[2])


@pytest.mark.parametrize("branch", ["resident", "streaming"])
def test_port_encode_matches_jax(runs, tmp_path, monkeypatch, capfd, branch):
    """``encode --model vmfnb`` of the JAX checkpoint, both sweeps, against
    the JAX CLI's output."""
    tmp, common = runs
    if branch == "streaming":
        monkeypatch.setenv("MMVAE_DENSE_BYTES", "1")
    out = str(tmp_path / "port")
    assert port_encode.main([
        "--model", "vmfnb", "--mtx", common[1], "--checkpoint",
        str(tmp / "jck"), "--out", out, "--batch_size", "40",
        "--device", "cpu"]) == 0
    err = capfd.readouterr().err
    assert ("dense-resident" in err) == (branch == "resident")
    for key in ("mean", "lnvar"):
        got = read_data_file(f"{out}.mu_{key}.gz")
        want = read_data_file(str(tmp / f"jenc.mu_{key}.gz"))
        assert got.shape == want.shape == (N_CELLS, 2)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_device_cuda_without_gpu_fails(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")
    _, common = runs
    assert vmfnb_vae.main(common + ["--out", str(tmp_path / "x"),
                                    "--device", "cuda"]) == 2
    assert not os.listdir(tmp_path)


def _annotation(tmp):
    """``--annot`` / ``--row`` files over the D genes: 3 labels, a third of
    the genes uncovered."""
    (tmp / "rows.txt").write_text("".join(f"gene{i}\n" for i in range(D)))
    (tmp / "annot.txt").write_text(
        "".join(f"gene{i} T{i % 3}\n" for i in range(20)))
    return ["--annot", str(tmp / "annot.txt"), "--row",
            str(tmp / "rows.txt")]


@pytest.mark.parametrize("flags,expect", [
    (["--no_fused"], "forward + composite loss"),
    (["--mean_encoding", "8"], "v2 step kernels"),
    (["--vmf_decoding", "8"], "v2 step kernels"),
    (["--no_fused_step"], "forward + composite loss"),
    (["--dp_shard"], "item 13"),
    (["--tensor_parallel", "2"], "item 13")])
def test_unported_options_raise(runs, tmp_path, capsys, flags, expect,
                                monkeypatch):
    """The generic step's flags (once refused) train one epoch on the
    route the JAX CLI takes, logged in one ``Step:`` line; ``--dp_shard``
    (once refused) as :func:`tests.test_torch_multihost.check_dp_flag`
    says; ``--tensor_parallel`` (once refused; its runs are
    tests/test_torch_tp_*.py's) raises JAX's own errors in one process,
    for the joint model and the mixture: N not dividing D = 30, a hidden
    mu decoder, N not dividing the processes; and ``encode
    --tensor_parallel 2`` in one process raises JAX's device error."""
    tmp, common = runs
    args = common + ["--out", str(tmp_path / "x"), "--device", "cpu",
                     "--max_epoch", "1", *flags]
    if flags == ["--dp_shard"]:
        check_dp_flag(vmfnb_vae.main, common, tmp, tmp_path, flags, capsys,
                       monkeypatch, n_outputs=29)
    elif expect == "item 13":
        annot = _annotation(tmp)
        for extra in ([], annot):
            with pytest.raises(ValueError,
                               match="must divide the feature dim 30"):
                vmfnb_vae.main(args[:-2] + ["--tensor_parallel", "4"]
                               + extra)
            with pytest.raises(ValueError, match="needs the fused step"):
                vmfnb_vae.main(args + ["--mean_decoding", "4"] + extra)
            with pytest.raises(ValueError, match="--num_hosts, --host_id "
                                                 "and --coordinator"):
                vmfnb_vae.main(args + extra)
    else:
        assert vmfnb_vae.main(args) == 0
        steps = [ln for ln in capsys.readouterr().err.splitlines()
                 if "Step: " in ln]
        assert len(steps) == 1 and expect in steps[0]
        scores = [float(v) for v in read_vector_file(
            str(tmp_path / "x.scores.gz"))]
        assert len(scores) == 1 and np.isfinite(scores[0])
    if expect == "item 13":
        with pytest.raises(ValueError, match="does not divide 1 devices"):
            port_encode.main(["--model", "vmfnb", "--mtx", common[1],
                              "--checkpoint", str(tmp / "pck"), "--out",
                              str(tmp_path / "enc"), "--batch_size", "40",
                              "--device", "cpu", "--tensor_parallel", "2"])
