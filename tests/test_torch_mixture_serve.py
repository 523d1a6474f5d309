"""The port's labeled-mixture CLIs (``mmvae_tpu_torch.cli.vmfnb_vae
--annot --row``, ``encode --model mixture``) against the JAX package's:
the artifacts (``.clust.gz`` included), checkpoints with the Adam state
resumed across the two packages in both directions, the per-mode kappa
defaults, and the encoded posteriors and assignments of one checkpoint,
resident and streaming.

The encode comparison hands the port JAX's Gumbel uniforms
(``uniform(PRNGKey(seed), (B, K), 1e-20, 1)``, which the JAX CLI draws
for every batch) in place of its own seeded draw, so the two CLIs make
the same hard draw.

Tolerances: artifact files are ``%g`` text, compared by name and shape
(their values come from differently seeded inits); ``scores.gz`` values
carried through a checkpoint ``rel=1e-5`` (six significant digits of
text); encoded posteriors ``rtol=1e-4, atol=1e-5`` (six-digit text, and
the port folds the row norms into the contraction).  The assignments
must agree on every row, except at most one near-tie row (the top two of
``logits + g`` within float error), where the mean is not compared; the
log-variance does not depend on the assignment and is compared on every
row.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mmvae_tpu.cli.vmfnb_vae import resolve_kappa_defaults as jresolve
from mmvae_tpu.io.writers import (read_data_file, read_vector_file,
                                  write_matrix_market_file)
from mmvae_tpu.models.vmfnb_mixture import VMFNBMixtureVAE as JVAE
from mmvae_tpu.train import checkpoint as jck
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import make_optimizer
from mmvae_tpu_torch.cli import encode as port_encode
from mmvae_tpu_torch.cli import vmfnb_vae
from mmvae_tpu_torch.data.annotation import Annotation
from mmvae_tpu_torch.models.nb import adam_from_numpy
from mmvae_tpu_torch.models.vmfnb_mixture import VMFNBMixtureVAE
from mmvae_tpu_torch.train import checkpoint as tck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N_CELLS, K, BATCH = 30, 80, 3, 40


def _run_jax(module, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               MMVAE_FEATURE_PERM="0")
    r = subprocess.run([sys.executable, "-m", module] + args,
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A tiny mtx (D=30, N=80) with a 3-label marker annotation (a third
    of the genes uncovered, one gene in two labels, one unlisted gene); a
    2-epoch run of each mixture CLI with recording and a checkpoint; the
    JAX encode of the JAX checkpoint."""
    tmp = tmp_path_factory.mktemp("mixture")
    rng = np.random.default_rng(8)
    dens = rng.poisson(1.5, size=(D, N_CELLS)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    rr, cc = np.nonzero(dens)
    mtx = str(tmp / "train.mtx.gz")
    write_matrix_market_file(mtx, rr, cc, dens[rr, cc], (D, N_CELLS))
    (tmp / "rows.txt").write_text("".join(f"gene{i}\n" for i in range(D)))
    pairs = [f"gene{i} T{i % K}" for i in range(20)] + ["gene4 T2",
                                                        "other T0"]
    (tmp / "annot.txt").write_text("\n".join(pairs) + "\n")
    common = ["--mtx", mtx, "--batch_size", str(BATCH), "--recording", "2",
              "--annot", str(tmp / "annot.txt"), "--row",
              str(tmp / "rows.txt")]
    _run_jax("mmvae_tpu.cli.vmfnb_vae", common + [
        "--out", str(tmp / "jax"), "--max_epoch", "2",
        "--checkpoint_dir", str(tmp / "jck")])
    _run_jax("mmvae_tpu.cli.encode", [
        "--model", "mixture", "--mtx", mtx, "--checkpoint", str(tmp / "jck"),
        "--out", str(tmp / "jenc"), "--batch_size", str(BATCH), "--annot",
        common[7], "--row", common[9], "--seed", "3"])
    assert vmfnb_vae.main(common + [
        "--out", str(tmp / "port"), "--max_epoch", "2", "--device", "cpu",
        "--checkpoint_dir", str(tmp / "pck")]) == 0
    return tmp, common


def _label(runs):
    tmp, common = runs
    return Annotation(common[7], common[9]).matrix()


def _artifacts(tmp, prefix):
    return {f[len(prefix):]: read_data_file(str(tmp / f)).shape
            for f in os.listdir(tmp)
            if f.startswith(prefix + "_") and f.endswith(".gz")}


def test_cli_artifacts_match_jax_cli(runs):
    tmp, _ = runs
    port, jx = _artifacts(tmp, "port"), _artifacts(tmp, "jax")
    assert port == jx
    assert port["_1.mu_mean.gz"] == (N_CELLS, 2)
    assert port["_1.clust.gz"] == (N_CELLS, K)
    assert port["_1_ln_vmf_mu.gz"] == (D, K)
    assert port["_1_nb_mu_representation_mean_k.2.weight.gz"] == (2, 2)
    clust = read_data_file(str(tmp / "port_1.clust.gz"))
    np.testing.assert_allclose(clust.sum(1), 1.0, atol=1e-5)
    assert np.all(np.abs(clust - np.round(clust)) < 1e-5)  # one-hot draws
    for name in ("port", "jax"):
        scores = [float(v) for v in read_vector_file(
            str(tmp / f"{name}.scores.gz"))]
        assert len(scores) == 2 and np.all(np.isfinite(scores))


def _jax_template(label):
    tmpl = JVAE(label=label).init(jax.random.PRNGKey(0))
    return tmpl, make_optimizer(JOptions()).init(tmpl)


def test_port_checkpoint_loads_in_jax(runs):
    tmp, common = runs
    params, opt, epoch, losses = jck.load_checkpoint(
        str(tmp / "pck"), *_jax_template(_label(runs)))
    assert epoch == 2 and len(losses) == 2
    assert int(opt[2].count) == 2 * 2 * 3  # epochs x batches x nboot
    with np.load(str(tmp / "pck" / "ckpt.npz")) as z:
        np.testing.assert_array_equal(
            np.asarray(opt[2].mu["nb_mu_representation_mean_k"]["weight"]),
            z["opt/[2].mu['nb_mu_representation_mean_k']['weight']"])
        np.testing.assert_array_equal(np.asarray(params["ln_vmf_mu"]),
                                      z["params/ln_vmf_mu"])
    # and the JAX trainer resumes it for one more epoch
    _run_jax("mmvae_tpu.cli.vmfnb_vae", common + [
        "--out", str(tmp / "jres"), "--max_epoch", "3",
        "--resume", str(tmp / "pck")])
    scores = [float(v) for v in read_vector_file(str(tmp / "jres.scores.gz"))]
    assert len(scores) == 3 and scores[:2] == pytest.approx(losses, rel=1e-5)


def test_jax_checkpoint_resumes_in_port(runs):
    tmp, common = runs
    model = VMFNBMixtureVAE(label=_label(runs))
    _, jopt, _, jlosses = jck.load_checkpoint(
        str(tmp / "jck"), *_jax_template(_label(runs)))
    opt = tck.load_opt_state(str(tmp / "jck"), model)
    assert int(opt["count"]) == int(jopt[2].count) == 12
    port = adam_from_numpy(opt)
    np.testing.assert_array_equal(
        port["nu"]["nb_mu_representation_mean_k"]["bias"].numpy(),
        np.asarray(jopt[2].nu["nb_mu_representation_mean_k"]["bias"]))
    assert vmfnb_vae.main(common + [
        "--out", str(tmp / "pres"), "--max_epoch", "3", "--device", "cpu",
        "--resume", str(tmp / "jck")]) == 0
    scores = [float(v) for v in read_vector_file(str(tmp / "pres.scores.gz"))]
    assert len(scores) == 3 and scores[:2] == pytest.approx(jlosses, rel=1e-5)
    assert np.isfinite(scores[2])


def _jax_uniforms(self, B, seed):
    """JAX's uniforms of the hard draw: what the JAX CLI draws per batch."""
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(seed), (B, self.n_components), minval=1e-20,
        maxval=1.0)))


@pytest.mark.parametrize("branch", ["resident", "streaming"])
def test_port_encode_matches_jax(runs, tmp_path, monkeypatch, capfd, branch):
    """``encode --model mixture`` of the JAX checkpoint with JAX's
    uniforms, both sweeps, against the JAX CLI's output."""
    tmp, common = runs
    if branch == "streaming":
        monkeypatch.setenv("MMVAE_DENSE_BYTES", "1")
    monkeypatch.setattr(VMFNBMixtureVAE, "gumbel_uniforms", _jax_uniforms)
    out = str(tmp_path / "port")
    assert port_encode.main([
        "--model", "mixture", "--mtx", common[1], "--checkpoint",
        str(tmp / "jck"), "--out", out, "--batch_size", str(BATCH),
        "--annot", common[7], "--row", common[9], "--seed", "3",
        "--device", "cpu"]) == 0
    err = capfd.readouterr().err
    assert ("dense-resident" in err) == (branch == "resident")
    got = {k: read_data_file(f"{out}.{k}.gz")
           for k in ("mu_mean", "mu_lnvar", "clust")}
    want = {k: read_data_file(str(tmp / f"jenc.{k}.gz"))
            for k in ("mu_mean", "mu_lnvar", "clust")}
    assert got["clust"].shape == want["clust"].shape == (N_CELLS, K)
    same = got["clust"].argmax(1) == want["clust"].argmax(1)
    assert (~same).sum() <= 1
    np.testing.assert_allclose(got["clust"][same], want["clust"][same],
                               atol=1e-5)
    np.testing.assert_allclose(got["mu_mean"][same], want["mu_mean"][same],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["mu_lnvar"], want["mu_lnvar"], rtol=1e-4,
                               atol=1e-5)


def test_port_encode_resident_equals_streaming(runs, tmp_path, monkeypatch):
    """With the port's own seeded uniforms: the two sweeps write the same
    files, and another seed draws other uniforms."""
    tmp, common = runs
    args = ["--model", "mixture", "--mtx", common[1], "--checkpoint",
            str(tmp / "pck"), "--batch_size", str(BATCH), "--annot",
            common[7], "--row", common[9], "--device", "cpu"]
    assert port_encode.main(args + ["--out", str(tmp_path / "res")]) == 0
    monkeypatch.setenv("MMVAE_DENSE_BYTES", "1")
    assert port_encode.main(args + ["--out", str(tmp_path / "str")]) == 0
    for k in ("mu_mean", "mu_lnvar", "clust"):
        a = read_data_file(str(tmp_path / f"res.{k}.gz"))
        np.testing.assert_array_equal(
            a, read_data_file(str(tmp_path / f"str.{k}.gz")))
    model = VMFNBMixtureVAE(label=_label(runs))
    assert not torch.equal(model.gumbel_uniforms(BATCH, 0),
                           model.gumbel_uniforms(BATCH, 1))


@pytest.mark.parametrize("kmin,kmax", [(None, None), (0.5, None),
                                       (None, 7.0), (0.2, 30.0)])
@pytest.mark.parametrize("mixture", [False, True])
def test_kappa_defaults_per_mode_match_jax(kmin, kmax, mixture):
    """Joint .1/10, mixture .1/100, unless given."""
    assert vmfnb_vae.resolve_kappa_defaults(kmin, kmax, mixture) == \
        jresolve(kmin, kmax, mixture)


def test_trainer_builds_each_mode_with_its_kappa(runs, tmp_path,
                                                 monkeypatch):
    """The CLI hands the model the mode's kappa range."""
    _, common = runs
    seen = []

    def capture(opts, topt, model, fast, *rest, **kw):
        seen.append((type(model).__name__, model.kappa_min,
                     model.kappa_max, type(fast).__name__))
        return 0

    monkeypatch.setattr(vmfnb_vae, "run_training", capture)
    base = common[:6] + ["--device", "cpu", "--out", str(tmp_path / "k")]
    assert vmfnb_vae.main(base) == 0
    assert vmfnb_vae.main(common + ["--device", "cpu", "--out",
                                    str(tmp_path / "k")]) == 0
    assert vmfnb_vae.main(common + ["--device", "cpu", "--out",
                                    str(tmp_path / "k"), "--kappa_max",
                                    "20"]) == 0
    assert seen == [("VMFNBVAE", 0.1, 10.0, "VMFNBFastStep"),
                    ("VMFNBMixtureVAE", 0.1, 100.0, "VMFNBMixtureFastStep"),
                    ("VMFNBMixtureVAE", 0.1, 20.0, "VMFNBMixtureFastStep")]


def test_annot_needs_row_and_matching_width(runs, tmp_path):
    tmp, common = runs
    with pytest.raises(ValueError, match="--row"):
        vmfnb_vae.main(common[:8] + ["--device", "cpu", "--out",
                                     str(tmp_path / "x")])
    (tmp_path / "short.txt").write_text("gene0\ngene1\n")
    with pytest.raises(ValueError, match="covers 2 features"):
        vmfnb_vae.main(common[:9] + [str(tmp_path / "short.txt"),
                                     "--device", "cpu", "--out",
                                     str(tmp_path / "x")])
    with pytest.raises(ValueError, match="--annot and --row"):
        port_encode.main(["--model", "mixture", "--mtx", common[1],
                          "--checkpoint", str(tmp / "pck"), "--out",
                          str(tmp_path / "x"), "--device", "cpu"])


def test_device_cuda_without_gpu_fails(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")
    tmp, common = runs
    assert vmfnb_vae.main(common + ["--out", str(tmp_path / "x"),
                                    "--device", "cuda"]) == 2
    assert port_encode.main([
        "--model", "mixture", "--mtx", common[1], "--checkpoint",
        str(tmp / "pck"), "--out", str(tmp_path / "y"), "--annot",
        common[7], "--row", common[9], "--device", "cuda"]) == 2
    assert not os.listdir(tmp_path)
