"""The port's vMF-VAE trainer and serving CLIs (``mmvae_tpu_torch.cli.
vmf_vae``, ``encode --model vmf``) against the JAX package's: the
artifacts of a run from its own init, and of a run fed the JAX CLI's init
and draws; checkpoints with the Adam state resumed across the two
packages in both directions; the encoded posteriors of one checkpoint;
the generic route of a hidden-layer architecture; and the refusals.

Tolerances: artifacts of a run from the port's own init are ``%g`` text
compared by name and shape (their values come from differently seeded
inits); the run fed the JAX CLI's init and draws is held to the JAX
suite's trajectory yardstick (tests/test_vmf_fast.py): scores
``rtol=2e-4``, parameters and posteriors ``rtol=3e-3, atol=1e-4``;
``scores.gz`` values carried through a checkpoint ``rel=1e-5`` (six
significant digits of text); encoded posteriors ``rtol=1e-4, atol=1e-5``
(six-digit text, and the port folds the standardization into the
product); the resident and streaming sweeps bitwise.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.io.writers import (read_data_file, read_vector_file,
                                  write_matrix_market_file)
from mmvae_tpu.models.vmf import VMFVAE as JVAE
from mmvae_tpu.ops.vmf_fast import VMFFastStep as JFast
from mmvae_tpu.train import checkpoint as jck
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import make_optimizer
from mmvae_tpu.train.recorder import flatten_params as jflatten
from mmvae_tpu_torch.cli import encode as port_encode
from mmvae_tpu_torch.cli import vmf_vae
from mmvae_tpu_torch.models.nb import adam_from_numpy, params_from_numpy
from mmvae_tpu_torch.models.vmf import VMFVAE
from mmvae_tpu_torch.ops.nb_fast import rand_from_numpy
from mmvae_tpu_torch.train import checkpoint as tck
from mmvae_tpu_torch.train.loop import DenseEpochRunner
from tests.test_torch_multihost import check_dp_flag

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N_CELLS = 30, 80
HIDDEN = ["--encoding", "8", "--decoding", "6"]


def _run_jax(module, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               MMVAE_FEATURE_PERM="0")
    r = subprocess.run([sys.executable, "-m", module] + args,
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]


def _jax_init_and_draws(mp):
    """Patch the port so a run starts from the JAX CLI's init
    (``VMFVAE.init(PRNGKey(seed))``) and draws the JAX trainer's epoch
    noise (``draw_rand(fold_in(PRNGKey(seed), epoch), batches)``)."""
    jmodel = JVAE(data_dim=D, covar_dim=1)
    jfast = JFast(jmodel, JOptions(nboot=3))
    jinit = jax.tree_util.tree_map(np.asarray,
                                   jmodel.init(jax.random.PRNGKey(0)))

    def draw(self, epoch):
        rand = jfast.draw_rand(
            jax.random.fold_in(jax.random.PRNGKey(self.seed),
                               jnp.int32(epoch)),
            jnp.arange(self.nbatch, dtype=jnp.int32), self.B)
        return rand_from_numpy(jax.tree_util.tree_map(np.asarray, rand),
                               self.device)

    mp.setattr(VMFVAE, "init", lambda self, generator, device="cpu":
               params_from_numpy(jinit, device))
    mp.setattr(DenseEpochRunner, "draw", draw)


def _dense():
    """The (D, N) counts of the test matrix, every cell non-empty."""
    rng = np.random.default_rng(6)
    dens = rng.poisson(1.5, size=(D, N_CELLS)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    return dens

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A tiny mtx (D=30, N=80); a 2-epoch run of each CLI with recording
    and a checkpoint; the port's run fed the JAX CLI's init and draws;
    the JAX encode of the JAX checkpoint."""
    tmp = tmp_path_factory.mktemp("vmf")
    dens = _dense()
    rr, cc = np.nonzero(dens)
    mtx = str(tmp / "train.mtx.gz")
    write_matrix_market_file(mtx, rr, cc, dens[rr, cc], (D, N_CELLS))
    common = ["--mtx", mtx, "--batch_size", "40", "--recording", "2"]
    _run_jax("mmvae_tpu.cli.vmf_vae", common + [
        "--out", str(tmp / "jax"), "--max_epoch", "2",
        "--checkpoint_dir", str(tmp / "jck")])
    _run_jax("mmvae_tpu.cli.encode", [
        "--model", "vmf", "--mtx", mtx, "--checkpoint", str(tmp / "jck"),
        "--out", str(tmp / "jenc"), "--batch_size", "40"])
    assert vmf_vae.main(common + [
        "--out", str(tmp / "port"), "--max_epoch", "2", "--device", "cpu",
        "--checkpoint_dir", str(tmp / "pck")]) == 0
    with pytest.MonkeyPatch.context() as mp:
        _jax_init_and_draws(mp)
        assert vmf_vae.main(common + [
            "--out", str(tmp / "pj"), "--max_epoch", "2",
            "--device", "cpu"]) == 0
    return tmp, common


def _artifacts(tmp, prefix):
    return {f[len(prefix):]: read_data_file(str(tmp / f)).shape
            for f in os.listdir(tmp)
            if f.startswith(prefix + "_") and f.endswith(".gz")}


def _scores(path):
    return [float(v) for v in read_vector_file(str(path))]


def test_cli_artifacts_match_jax_cli(runs):
    tmp, _ = runs
    port, jx = _artifacts(tmp, "port"), _artifacts(tmp, "jax")
    assert port == jx and len(port) == 16
    assert port["_1.latent_mean.gz"] == port["_1.latent_lnvar.gz"] == (
        N_CELLS, 2)
    assert port["_1_encoding.weight.gz"] == (2, D)
    assert port["_1_covar_decoding_.weight.gz"] == (D, 1)
    assert port["_1_ln_kappa.gz"] == (1, 1)
    for name in ("port", "jax"):
        scores = _scores(tmp / f"{name}.scores.gz")
        assert len(scores) == 2 and np.all(np.isfinite(scores))


def test_cli_artifact_values_match_jax_cli(runs):
    """The port's CLI from the JAX CLI's init with the JAX trainer's draws:
    scores, the recorded posteriors and every parameter dump."""
    tmp, _ = runs
    np.testing.assert_allclose(_scores(tmp / "pj.scores.gz"),
                               _scores(tmp / "jax.scores.gz"), rtol=2e-4)
    names = _artifacts(tmp, "jax")
    assert _artifacts(tmp, "pj") == names
    for name in names:
        np.testing.assert_allclose(read_data_file(str(tmp / f"pj{name}")),
                                   read_data_file(str(tmp / f"jax{name}")),
                                   rtol=3e-3, atol=1e-4, err_msg=name)


def _jax_template():
    tmpl = JVAE(data_dim=D, covar_dim=1).init(jax.random.PRNGKey(0))
    return tmpl, make_optimizer(JOptions()).init(tmpl)


def test_port_checkpoint_loads_in_jax(runs):
    tmp, common = runs
    params, opt, epoch, losses = jck.load_checkpoint(str(tmp / "pck"),
                                                     *_jax_template())
    assert epoch == 2 and len(losses) == 2
    assert int(opt[2].count) == 2 * 2 * 3  # epochs x batches x nboot
    with np.load(str(tmp / "pck" / "ckpt.npz")) as z:
        np.testing.assert_array_equal(np.asarray(opt[2].mu["ln_kappa"]),
                                      z["opt/[2].mu['ln_kappa']"])
        np.testing.assert_array_equal(
            np.asarray(params["encoding"]["weight"]),
            z["params/encoding/weight"])
        assert "params/encoding/bias" not in z.files
    # and the JAX trainer resumes it for one more epoch
    _run_jax("mmvae_tpu.cli.vmf_vae", common + [
        "--out", str(tmp / "jres"), "--max_epoch", "3",
        "--resume", str(tmp / "pck")])
    scores = _scores(tmp / "jres.scores.gz")
    assert len(scores) == 3 and scores[:2] == pytest.approx(losses, rel=1e-5)


def test_jax_checkpoint_resumes_in_port(runs):
    tmp, common = runs
    model = VMFVAE(data_dim=D, covar_dim=1)
    _, jopt, _, jlosses = jck.load_checkpoint(str(tmp / "jck"),
                                              *_jax_template())
    opt = tck.load_opt_state(str(tmp / "jck"), model)
    assert int(opt["count"]) == int(jopt[2].count) == 12
    port = adam_from_numpy(opt)
    np.testing.assert_array_equal(port["nu"]["ln_kappa"].numpy(),
                                  np.asarray(jopt[2].nu["ln_kappa"]))
    assert vmf_vae.main(common + [
        "--out", str(tmp / "pres"), "--max_epoch", "3", "--device", "cpu",
        "--resume", str(tmp / "jck")]) == 0
    scores = _scores(tmp / "pres.scores.gz")
    assert len(scores) == 3 and scores[:2] == pytest.approx(jlosses, rel=1e-5)
    assert np.isfinite(scores[2])


@pytest.mark.parametrize("branch", ["resident", "streaming"])
def test_port_encode_matches_jax(runs, tmp_path, monkeypatch, capfd, branch):
    """``encode --model vmf`` of the JAX checkpoint, both sweeps, against
    the JAX CLI's output."""
    tmp, common = runs
    if branch == "streaming":
        monkeypatch.setenv("MMVAE_DENSE_BYTES", "1")
    out = str(tmp_path / "port")
    assert port_encode.main([
        "--model", "vmf", "--mtx", common[1], "--checkpoint",
        str(tmp / "jck"), "--out", out, "--batch_size", "40",
        "--device", "cpu"]) == 0
    err = capfd.readouterr().err
    assert ("dense-resident" in err) == (branch == "resident")
    for key in ("mean", "lnvar"):
        got = read_data_file(f"{out}.latent_{key}.gz")
        want = read_data_file(str(tmp / f"jenc.latent_{key}.gz"))
        assert got.shape == want.shape == (N_CELLS, 2)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert not os.path.exists(f"{out}.mu_mean.gz")


def test_encode_resident_equals_streaming(runs, tmp_path, monkeypatch):
    """The two sweeps of the port's checkpoint agree bitwise."""
    tmp, common = runs
    args = ["--model", "vmf", "--mtx", common[1], "--checkpoint",
            str(tmp / "pck"), "--batch_size", "40", "--device", "cpu"]
    assert port_encode.main(args + ["--out", str(tmp_path / "r")]) == 0
    monkeypatch.setenv("MMVAE_DENSE_BYTES", "1")
    assert port_encode.main(args + ["--out", str(tmp_path / "s")]) == 0
    for key in ("mean", "lnvar"):
        np.testing.assert_array_equal(
            read_data_file(str(tmp_path / f"r.latent_{key}.gz")),
            read_data_file(str(tmp_path / f"s.latent_{key}.gz")))


def test_hidden_layers_train_on_generic_step(runs, tmp_path, capsys):
    """``--encoding 8 --decoding 6`` trains on the generic step, writes
    the JAX recorder's artifact names and a checkpoint that ``encode
    --model vmf`` serves like the model's unfolded encoder."""
    _, common = runs
    out, ck = str(tmp_path / "h"), str(tmp_path / "hck")
    assert vmf_vae.main(common + HIDDEN + [
        "--out", out, "--max_epoch", "2", "--device", "cpu",
        "--checkpoint_dir", ck]) == 0
    steps = [ln for ln in capsys.readouterr().err.splitlines()
             if "Step: " in ln]
    assert len(steps) == 1 and "generic step, forward + vmf_loss" in steps[0]
    jtree = JVAE(data_dim=D, covar_dim=1, encoding=(8,),
                 decoding=(6,)).init(jax.random.PRNGKey(0))
    want = {f"_1_{k}.gz" for k in jflatten(jtree)}
    got = _artifacts(tmp_path, "h")
    assert got.keys() == want | {"_1.latent_mean.gz", "_1.latent_lnvar.gz"}
    assert got["_1.latent_mean.gz"] == (N_CELLS, 2)
    assert got["_1_encoding_1.weight.gz"] == (8, D)
    assert got["_1_decoding_1.weight.gz"] == (6, 2)
    scores = _scores(out + ".scores.gz")
    assert len(scores) == 2 and np.all(np.isfinite(scores))
    assert port_encode.main([
        "--model", "vmf", "--mtx", common[1], "--checkpoint", ck,
        "--out", str(tmp_path / "e"), "--batch_size", "40",
        "--device", "cpu", *HIDDEN]) == 0
    model = VMFVAE(data_dim=D, covar_dim=1, encoding=(8,), decoding=(6,))
    params = params_from_numpy(tck.load_checkpoint(ck, model)[0])
    with torch.no_grad():
        want = model.encode(params, torch.from_numpy(_dense().T.copy()))
    for key, w in zip(("mean", "lnvar"), want):
        np.testing.assert_allclose(
            read_data_file(str(tmp_path / f"e.latent_{key}.gz")), w.numpy(),
            rtol=1e-4, atol=1e-5)


def test_no_fused_step_takes_generic_route(runs, tmp_path, capsys):
    _, common = runs
    assert vmf_vae.main(common + [
        "--out", str(tmp_path / "g"), "--max_epoch", "1", "--device", "cpu",
        "--no_fused_step"]) == 0
    steps = [ln for ln in capsys.readouterr().err.splitlines()
             if "Step: " in ln]
    assert len(steps) == 1 and "generic step" in steps[0]
    scores = _scores(tmp_path / "g.scores.gz")
    assert len(scores) == 1 and np.isfinite(scores[0])


def test_device_cuda_without_gpu_fails(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")
    _, common = runs
    assert vmf_vae.main(common + ["--out", str(tmp_path / "x"),
                                  "--device", "cuda"]) == 2
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flags", [["--dp_shard"], ["--data_parallel"],
                                   ["--tensor_parallel", "2"],
                                   ["--num_hosts", "2"]])
def test_unported_options_raise(runs, tmp_path, flags, capsys,
                                monkeypatch):
    """``--tensor_parallel 2`` raises naming its ROADMAP.md item, before
    anything is written; the data-parallel flags as
    :func:`tests.test_torch_multihost.check_dp_flag` says."""
    tmp, common = runs
    if flags[0] != "--tensor_parallel":
        check_dp_flag(vmf_vae.main, common, tmp, tmp_path, flags, capsys,
                       monkeypatch, n_outputs=17)
        return
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md Queue 1 item 13"):
        vmf_vae.main(common + ["--out", str(tmp_path / "x"), "--device",
                               "cpu", *flags])
    assert not os.listdir(tmp_path)
