"""The port's ``nb_vae`` CLI on the generic step path (hidden layers,
``--no_fused_step``, ``--no_fused``) against the JAX CLI: the route each
flag set takes, the recording artifacts of a hidden-layer run, and its
checkpoints (parameters and the named Adam state, ``mu_encoding_1``,
``mu_decoding_1``, ...) read and resumed across the two packages in both
directions.

Tolerances: artifact files are ``%g`` text, compared by name and shape
(their values come from differently seeded inits); checkpoint arrays
bitwise (pure data movement); ``scores.gz`` values carried through a
checkpoint ``rel=1e-5`` (six significant digits of text).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from mmvae_tpu.io.writers import read_data_file, read_vector_file
from mmvae_tpu.io.writers import write_matrix_market_file
from mmvae_tpu.models.nb import NBVAE as JNBVAE
from mmvae_tpu.train import checkpoint as jck
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import make_optimizer
from mmvae_tpu_torch.cli import nb_vae
from mmvae_tpu_torch.models.nb import NBVAE
from mmvae_tpu_torch.train import checkpoint as tck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N_CELLS = 30, 80
HIDDEN = ["--mean_encoding", "4", "--mean_decoding", "3"]
ARCH = dict(mean_encoding=(4,), mean_decoding=(3,))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A tiny mtx (D=30, N=80); a 2-epoch hidden-layer run of each CLI
    with recording and a checkpoint."""
    tmp = tmp_path_factory.mktemp("generic")
    rng = np.random.default_rng(6)
    dens = rng.poisson(1.5, size=(D, N_CELLS)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    rr, cc = np.nonzero(dens)
    mtx = str(tmp / "train.mtx.gz")
    write_matrix_market_file(mtx, rr, cc, dens[rr, cc], (D, N_CELLS))
    common = ["--mtx", mtx, "--batch_size", "40", "--recording", "2"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "mmvae_tpu.cli.nb_vae",
                        *common, *HIDDEN, "--out", str(tmp / "jax"),
                        "--max_epoch", "2", "--checkpoint_dir",
                        str(tmp / "jck")], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert nb_vae.main(common + HIDDEN + [
        "--out", str(tmp / "port"), "--max_epoch", "2", "--device", "cpu",
        "--checkpoint_dir", str(tmp / "pck")]) == 0
    return tmp, common


def _artifacts(tmp, prefix):
    return {f[len(prefix):]: read_data_file(str(tmp / f)).shape
            for f in os.listdir(tmp)
            if f.startswith(prefix + "_") and f.endswith(".gz")}


def _scores(path):
    return [float(v) for v in read_vector_file(str(path))]


def test_hidden_layer_artifacts_match_jax_cli(runs):
    tmp, _ = runs
    port, jx = _artifacts(tmp, "port"), _artifacts(tmp, "jax")
    assert port == jx
    assert port["_1_mu_encoding_1.weight.gz"] == (4, D)
    assert port["_1_mu_decoding_1.weight.gz"] == (3, 2)
    assert port["_1.mu_mean.gz"] == (N_CELLS, 2)
    for name in ("port", "jax"):
        scores = _scores(tmp / f"{name}.scores.gz")
        assert len(scores) == 2 and np.all(np.isfinite(scores))


def _jax_template():
    tmpl = JNBVAE(data_dim=D, covar_dim=1, **ARCH).init(
        jax.random.PRNGKey(0))
    return tmpl, make_optimizer(JOptions()).init(tmpl)


def test_port_hidden_checkpoint_loads_in_jax(runs):
    tmp, _ = runs
    params, opt, epoch, losses = jck.load_checkpoint(str(tmp / "pck"),
                                                     *_jax_template())
    assert epoch == 2 and len(losses) == 2
    assert int(opt[2].count) == 2 * 2 * 3  # epochs x batches x nboot
    with np.load(str(tmp / "pck" / "ckpt.npz")) as z:
        for m in ("mu", "nu"):
            for layer in ("mu_encoding_1", "mu_decoding_1", "mu_decoding"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(opt[2], m)[layer]["weight"]),
                    z[f"opt/[2].{m}['{layer}']['weight']"])
        np.testing.assert_array_equal(
            np.asarray(params["mu_encoding_1"]["bias"]),
            z["params/mu_encoding_1/bias"])


@pytest.mark.parametrize("source", ["jck", "pck"])
def test_hidden_checkpoint_resumes_in_port(runs, tmp_path, source):
    """The port's Adam state read from either package's hidden-layer
    checkpoint equals JAX's reading, and ``--resume`` runs epoch 3."""
    tmp, common = runs
    _, jopt, _, losses = jck.load_checkpoint(str(tmp / source),
                                             *_jax_template())
    opt = tck.load_opt_state(str(tmp / source), NBVAE(data_dim=D, **ARCH))
    assert int(opt["count"]) == int(jopt[2].count) == 12
    got = dict(jax.tree_util.tree_leaves_with_path(opt["nu"]))
    for path, want in jax.tree_util.tree_leaves_with_path(jopt[2].nu):
        np.testing.assert_array_equal(got[path], np.asarray(want))
    assert nb_vae.main(common + HIDDEN + [
        "--out", str(tmp_path / "res"), "--max_epoch", "3", "--device",
        "cpu", "--resume", str(tmp / source)]) == 0
    scores = _scores(tmp_path / "res.scores.gz")
    assert len(scores) == 3 and scores[:2] == pytest.approx(losses, rel=1e-5)
    assert np.isfinite(scores[2])


@pytest.mark.parametrize("flags,route", [
    (["--mean_encoding", "4"], "v2 step kernels"),
    (["--mean_decoding", "3"], "v1 ELBO kernels"),
    (["--no_fused_step"], "v1 ELBO kernels"),
    (["--no_fused", "--mean_encoding", "4"], "forward + nb_loss"),
    ([], "packed step")])
def test_cli_route_matches_jax_choice(runs, tmp_path, capsys, flags, route):
    """Each flag set trains one epoch on the step the JAX CLI would pick,
    logged in one line."""
    tmp, common = runs
    assert nb_vae.main(common[:4] + flags + [
        "--out", str(tmp_path / "r"), "--max_epoch", "1", "--device",
        "cpu"]) == 0
    steps = [ln for ln in capsys.readouterr().err.splitlines()
             if "Step: " in ln]
    assert len(steps) == 1 and route in steps[0]
    scores = _scores(tmp_path / "r.scores.gz")
    assert len(scores) == 1 and np.isfinite(scores[0])
