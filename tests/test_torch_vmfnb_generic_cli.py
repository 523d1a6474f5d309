"""The port's ``vmfnb_vae`` CLI on the generic step (hidden layers,
``--vmf_decoding``, ``--no_fused_step``, ``--no_fused``), joint and
``--annot`` mixture, against the JAX CLI: the route each flag set takes,
the recording artifacts of a hidden-layer run, its checkpoints
(parameters and the named Adam state, ``nb_mu_encoding_1``,
``vmf_mu_decoding_1``, ...) read and resumed across the two packages,
and ``encode --model vmfnb|mixture --mean_encoding`` of a hidden-layer
checkpoint against JAX's encoders.

Tolerances: artifact files are ``%g`` text, compared by name and shape
(their values come from differently seeded inits); checkpoint arrays
bitwise (pure data movement); ``scores.gz`` values carried through a
checkpoint ``rel=1e-5`` (six significant digits of text); encoded
posteriors ``rtol=1e-4, atol=1e-5`` (six-digit text, and the port folds
the row norms into the contraction); the mixture's assignments must
agree on every row but at most one near-tie, where the mean is not
compared (tests/test_torch_mixture_serve.py's rule).
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
from mmvae_tpu.models.vmfnb import VMFNBVAE as JVAE
from mmvae_tpu.models.vmfnb_mixture import VMFNBMixtureVAE as JMix
from mmvae_tpu.train import checkpoint as jck
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import make_optimizer
from mmvae_tpu_torch.cli import encode as port_encode
from mmvae_tpu_torch.cli import vmfnb_vae
from mmvae_tpu_torch.data.annotation import Annotation
from mmvae_tpu_torch.models.vmfnb import VMFNBVAE
from mmvae_tpu_torch.models.vmfnb_mixture import VMFNBMixtureVAE
from mmvae_tpu_torch.train import checkpoint as tck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N_CELLS, K, BATCH = 30, 80, 3, 40
HIDDEN = {"joint": ["--mean_encoding", "4", "--mean_decoding", "3",
                    "--vmf_decoding", "3"],
          "mixture": ["--mean_encoding", "4"]}
ARCH = {"joint": dict(mean_encoding=(4,), mean_decoding=(3,),
                      vmf_decoding=(3,)),
        "mixture": dict(mean_encoding=(4,))}


def _run_jax(module, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               MMVAE_FEATURE_PERM="0")
    r = subprocess.run([sys.executable, "-m", module] + args,
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A tiny mtx (D=30, N=80) and a 3-label annotation; a 2-epoch
    hidden-layer run of each CLI, joint and mixture, with recording and a
    checkpoint."""
    tmp = tmp_path_factory.mktemp("vmfnb_generic")
    rng = np.random.default_rng(9)
    dens = rng.poisson(1.5, size=(D, N_CELLS)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    rr, cc = np.nonzero(dens)
    mtx = str(tmp / "train.mtx.gz")
    write_matrix_market_file(mtx, rr, cc, dens[rr, cc], (D, N_CELLS))
    (tmp / "rows.txt").write_text("".join(f"gene{i}\n" for i in range(D)))
    (tmp / "annot.txt").write_text("".join(f"gene{i} T{i % K}\n"
                                           for i in range(20)))
    common = {"joint": ["--mtx", mtx, "--batch_size", str(BATCH),
                        "--recording", "2"]}
    common["mixture"] = common["joint"] + [
        "--annot", str(tmp / "annot.txt"), "--row", str(tmp / "rows.txt")]
    for kind in ("joint", "mixture"):
        args = common[kind] + HIDDEN[kind] + ["--max_epoch", "2"]
        _run_jax("mmvae_tpu.cli.vmfnb_vae", args + [
            "--out", str(tmp / f"jax_{kind}"), "--checkpoint_dir",
            str(tmp / f"jck_{kind}")])
        assert vmfnb_vae.main(args + [
            "--out", str(tmp / f"port_{kind}"), "--device", "cpu",
            "--checkpoint_dir", str(tmp / f"pck_{kind}")]) == 0
    return tmp, common, dens.T.copy()


def _label(common):
    return Annotation(common["mixture"][7], common["mixture"][9]).matrix()


def _models(kind, common):
    if kind == "joint":
        return JVAE(data_dim=D, **ARCH[kind]), VMFNBVAE(data_dim=D,
                                                       **ARCH[kind])
    label = _label(common)
    return (JMix(label=label, **ARCH[kind]),
            VMFNBMixtureVAE(label=label, **ARCH[kind]))


def _artifacts(tmp, prefix):
    return {f[len(prefix):]: read_data_file(str(tmp / f)).shape
            for f in os.listdir(tmp)
            if f.startswith(prefix + "_") and f.endswith(".gz")}


def _scores(path):
    return [float(v) for v in read_vector_file(str(path))]


@pytest.mark.parametrize("kind", ["joint", "mixture"])
def test_hidden_layer_artifacts_match_jax_cli(runs, kind):
    tmp, _, _ = runs
    port = _artifacts(tmp, f"port_{kind}")
    assert port == _artifacts(tmp, f"jax_{kind}")
    assert port["_1_nb_mu_encoding_1.weight.gz"] == (4, D)
    assert port["_1.mu_mean.gz"] == (N_CELLS, 2)
    if kind == "joint":
        assert port["_1_vmf_mu_decoding_1.weight.gz"] == (3, 2)
        assert port["_1_nb_mu_decoding_1.weight.gz"] == (3, 2)
    else:
        assert port["_1.clust.gz"] == (N_CELLS, K)
    for name in ("port", "jax"):
        scores = _scores(tmp / f"{name}_{kind}.scores.gz")
        assert len(scores) == 2 and np.all(np.isfinite(scores))


def _jax_template(jmodel):
    tmpl = jmodel.init(jax.random.PRNGKey(0))
    return tmpl, make_optimizer(JOptions()).init(tmpl)


@pytest.mark.parametrize("kind", ["joint", "mixture"])
def test_port_hidden_checkpoint_loads_in_jax(runs, kind):
    tmp, common, _ = runs
    jmodel, _ = _models(kind, common)
    params, opt, epoch, losses = jck.load_checkpoint(
        str(tmp / f"pck_{kind}"), *_jax_template(jmodel))
    assert epoch == 2 and len(losses) == 2
    assert int(opt[2].count) == 2 * 2 * 3  # epochs x batches x nboot
    layers = (["nb_mu_encoding_1", "vmf_mu_decoding_1", "nb_mu_decoding_1"]
              if kind == "joint" else ["nb_mu_encoding_1",
                                       "nb_mu_representation_mean_k"])
    with np.load(str(tmp / f"pck_{kind}" / "ckpt.npz")) as z:
        for m in ("mu", "nu"):
            for layer in layers:
                np.testing.assert_array_equal(
                    np.asarray(getattr(opt[2], m)[layer]["weight"]),
                    z[f"opt/[2].{m}['{layer}']['weight']"])
        np.testing.assert_array_equal(
            np.asarray(params["nb_mu_encoding_1"]["bias"]),
            z["params/nb_mu_encoding_1/bias"])


@pytest.mark.parametrize("source", ["jck", "pck"])
@pytest.mark.parametrize("kind", ["joint", "mixture"])
def test_hidden_checkpoint_resumes_in_port(runs, tmp_path, kind, source):
    """The port's Adam state read from either package's hidden-layer
    checkpoint equals JAX's reading, and ``--resume`` runs epoch 3."""
    tmp, common, _ = runs
    jmodel, model = _models(kind, common)
    ck = str(tmp / f"{source}_{kind}")
    _, jopt, _, losses = jck.load_checkpoint(ck, *_jax_template(jmodel))
    opt = tck.load_opt_state(ck, model)
    assert int(opt["count"]) == int(jopt[2].count) == 12
    got = dict(jax.tree_util.tree_leaves_with_path(opt["nu"]))
    for path, want in jax.tree_util.tree_leaves_with_path(jopt[2].nu):
        np.testing.assert_array_equal(got[path], np.asarray(want))
    assert vmfnb_vae.main(common[kind] + HIDDEN[kind] + [
        "--out", str(tmp_path / "res"), "--max_epoch", "3", "--device",
        "cpu", "--resume", ck]) == 0
    scores = _scores(tmp_path / "res.scores.gz")
    assert len(scores) == 3 and scores[:2] == pytest.approx(losses, rel=1e-5)
    assert np.isfinite(scores[2])


@pytest.mark.parametrize("kind,flags,route", [
    ("joint", [], "packed step (VMFNBFastStep)"),
    ("joint", ["--mean_decoding", "3"], "forward + composite loss"),
    ("joint", ["--mean_encoding", "4", "--vmf_decoding", "3"],
     "v2 step kernels"),
    ("mixture", [], "packed step (VMFNBMixtureFastStep)"),
    ("mixture", ["--mean_encoding", "4"], "v2 step kernels"),
    ("mixture", ["--mean_decoding", "3"], "forward + composite loss"),
    ("mixture", ["--no_fused_step"], "forward + composite loss"),
    ("mixture", ["--no_fused"], "forward + composite loss"),
    ("mixture", ["--vmf_decoding", "3"],
     "packed step (VMFNBMixtureFastStep)")])
def test_cli_route_matches_jax_choice(runs, tmp_path, capsys, kind, flags,
                                      route):
    """Each flag set trains one epoch on the step the JAX CLI would pick,
    logged in one line; the mixture ignores ``--vmf_decoding`` (it has no
    vMF decoder) and says so."""
    _, common, _ = runs
    args = [a for a in common[kind] if a not in ("--recording", "2")]
    assert vmfnb_vae.main(args + flags + [
        "--out", str(tmp_path / "r"), "--max_epoch", "1", "--device",
        "cpu"]) == 0
    err = capsys.readouterr().err
    steps = [ln for ln in err.splitlines() if "Step: " in ln]
    assert len(steps) == 1 and route in steps[0]
    assert ("--vmf_decoding is ignored" in err) == (
        kind == "mixture" and "--vmf_decoding" in flags)
    scores = _scores(tmp_path / "r.scores.gz")
    assert len(scores) == 1 and np.isfinite(scores[0])


def _jax_uniforms(self, B, seed):
    """JAX's uniforms of the hard draw: what the JAX CLI draws per batch."""
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(seed), (B, self.n_components), minval=1e-20,
        maxval=1.0)))


@pytest.mark.parametrize("kind", ["joint", "mixture"])
def test_encode_hidden_checkpoint_matches_jax(runs, tmp_path, monkeypatch,
                                              kind):
    """``encode --model vmfnb|mixture --mean_encoding 4`` of a hidden-layer
    checkpoint against JAX's encoders on its parameters
    (``shared_encode_mu``; the mixture's eval-mode ``vmf_forward`` with
    the CLI's key for every batch, then ``nb_encode_mu``), the port
    handed JAX's uniforms.  The mixture's is the JAX CLI's checkpoint;
    the joint one comes from a port run without ``--vmf_decoding``,
    since neither package's encode reads a vMF decoder's hidden layers
    (the serving model's template has none)."""
    tmp, common, x = runs
    if kind == "joint":
        hidden = ["--mean_encoding", "4", "--mean_decoding", "3"]
        ck = str(tmp_path / "ck")
        assert vmfnb_vae.main(common[kind][:4] + hidden + [
            "--out", str(tmp_path / "t"), "--max_epoch", "1", "--device",
            "cpu", "--checkpoint_dir", ck]) == 0
        jmodel = JVAE(data_dim=D, mean_encoding=(4,), mean_decoding=(3,))
    else:
        hidden = HIDDEN[kind]
        ck = str(tmp / f"jck_{kind}")
        jmodel = _models(kind, common)[0]
    jparams = jck.load_checkpoint(ck, *_jax_template(jmodel))[0]
    monkeypatch.setattr(VMFNBMixtureVAE, "gumbel_uniforms", _jax_uniforms)
    out = str(tmp_path / "enc")
    extra = common[kind][6:] + ["--seed", "3"] if kind == "mixture" else []
    assert port_encode.main([
        "--model", "vmfnb" if kind == "joint" else "mixture", "--mtx",
        common[kind][1], "--checkpoint", ck, "--out", out, "--batch_size",
        str(BATCH), "--device", "cpu", *hidden, *extra]) == 0
    got = {k: read_data_file(f"{out}.{k}.gz")
           for k in ("mu_mean", "mu_lnvar")}
    if kind == "joint":
        want = [np.asarray(a) for a in jmodel.shared_encode_mu(
            jparams, jnp.asarray(x))]
        same = np.ones(N_CELLS, bool)
    else:
        key = jax.random.PRNGKey(3)
        parts = []
        for b in range(N_CELLS // BATCH):
            xb = jnp.asarray(x[b * BATCH:(b + 1) * BATCH])
            vmf = jmodel.vmf_forward(jparams, xb, key, False)
            parts.append([np.asarray(a) for a in (
                *jmodel.nb_encode_mu(jparams, xb, vmf.latent), vmf.latent)])
        want = [np.concatenate(p) for p in zip(*parts)]
        clust = read_data_file(f"{out}.clust.gz")
        same = clust.argmax(1) == want[2].argmax(1)
        assert (~same).sum() <= 1
        np.testing.assert_allclose(clust[same], want[2][same], atol=1e-5)
    np.testing.assert_allclose(got["mu_mean"][same], want[0][same],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["mu_lnvar"], want[1], rtol=1e-4,
                               atol=1e-5)
