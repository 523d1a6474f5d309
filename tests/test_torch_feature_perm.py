"""The port's feature clustering (``train.loop.cluster_features``,
``permute_d_axes`` and ``train_vae_model(feature_perm=...)``) against
the JAX package's (``_permute_d_axes`` and ``feature_perm`` of
``mmvae_tpu/train/loop.py``), and what ``benchmarks/perm_probe.py``
counts.

Tolerances: the permutation itself is an exact gather (bitwise); the
port's epoch runner on permuted data against JAX's, fed JAX's draws,
as ``tests/test_torch_train.py`` holds it (reports ``rtol=2e-4``,
parameters ``rtol=3e-3, atol=2e-5``); a clustered run against an
unclustered one, as ``tests/test_feature_perm.py`` holds JAX's (losses
``rtol=2e-4``; parameters and artifacts ``rtol=2e-3, atol=2e-4``;
``.clust.gz`` 95% equal: a hard one-hot may flip on a near-tie).
"""

import gzip
import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.models.nb import NBVAE as JNB
from mmvae_tpu.models.vmfnb import VMFNBVAE as JJoint
from mmvae_tpu.models.vmfnb_mixture import VMFNBMixtureVAE as JMix
from mmvae_tpu.ops.losses import nb_loss
from mmvae_tpu.ops.nb_fast import NBFastStep as JFast
from mmvae_tpu.train.config import TrainingOptions as JOptions
from mmvae_tpu.train.loop import Trainer as JTrainer
from mmvae_tpu.train.loop import _permute_d_axes
from mmvae_tpu_torch.benchmarks import perm_probe
from mmvae_tpu_torch.cli import nb_vae, vmfnb_vae
from mmvae_tpu_torch.data.block import (MtxDataBlock, MtxMemoryBlock,
                                        create_ones_like)
from mmvae_tpu_torch.io.index import build_mmutil_index
from mmvae_tpu_torch.models.nb import NBVAE, adam_from_numpy, params_from_numpy
from mmvae_tpu_torch.models.vmfnb_mixture import VMFNBMixtureVAE
from mmvae_tpu_torch.ops.nb_fast import NBFastStep, rand_from_numpy
from mmvae_tpu_torch.train.checkpoint import (load_checkpoint, load_opt_state,
                                              save_checkpoint)
from mmvae_tpu_torch.train.config import TrainingOptions
from mmvae_tpu_torch.train.loop import (DenseEpochRunner, cluster_features,
                                        permute_d_axes, train_vae_model)
from mmvae_tpu_torch.train.recorder import LatentRecorder
from tests.test_feature_perm import hot_setup  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"\] (Feature clustering: .*)$", re.M)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _label(D, K=4):
    lab = np.zeros((D, K), np.float32)
    lab[np.arange(D), np.arange(D) % K] = 1.0
    return lab


def _jax_tree(kind, D):
    key = jax.random.PRNGKey(1)
    model = {"nb": lambda: JNB(data_dim=D, covar_dim=1),
             "joint": lambda: JJoint(data_dim=D),
             "mixture": lambda: JMix(label=_label(D))}[kind]()
    params = model.init(key)
    # an Adam state of the same tree, moments distinct from the params
    return {"count": np.int32(7), "mu": _np(params),
            "nu": jax.tree_util.tree_map(lambda a: np.asarray(a) ** 2 + 1.0,
                                         params)}


def _torch_tree(tree):
    return {"count": torch.tensor(int(tree["count"])),
            "mu": params_from_numpy(tree["mu"]),
            "nu": params_from_numpy(tree["nu"])}


def _flat(tree):
    """{path: array} of a nested dict of tensors or arrays."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out[path] = np.asarray(t.numpy() if torch.is_tensor(t) else t)

    walk(tree, ())
    return out


@pytest.mark.parametrize("D", [40, 600])
@pytest.mark.parametrize("kind", ["nb", "joint", "mixture"])
def test_permute_d_axes_matches_jax(kind, D):
    tree = _jax_tree(kind, D)
    perm = np.random.default_rng(D).permutation(D)
    want = _flat(_np(_permute_d_axes(
        {"mu": tree["mu"], "nu": tree["nu"]}, jnp.asarray(perm, jnp.int32),
        D)))
    port = _torch_tree(tree)
    got = permute_d_axes(port, perm, D)
    flat = _flat(got)
    for path, w in want.items():
        np.testing.assert_array_equal(flat[path], w, err_msg=str(path))
    assert int(got["count"]) == 7
    # some leaf really moved, and the inverse restores every leaf bitwise
    assert any(not np.array_equal(flat[p], v)
               for p, v in _flat(port).items())
    back = _flat(permute_d_axes(got, np.argsort(perm), D))
    for path, v in _flat(port).items():
        np.testing.assert_array_equal(back[path], v, err_msg=str(path))


def _hot(D=40, N=64, seed=3, hot=(3, 17, 31)):
    """(N, D) counts of tests/test_feature_perm.py's generator."""
    rng = np.random.default_rng(seed)
    dens = rng.poisson(0.8, size=(D, N)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    for g in hot:
        dens[g] += rng.poisson(30, size=N)
    return dens.T.copy()


def test_hot_gene_order_matches_jax(monkeypatch, capsys):
    """The order is JAX's ``np.argsort(gmax > 7, kind="stable")`` (its
    rule at train/loop.py:1464-1468, reproduced from JAX's own max)."""
    x = _hot(D=60, hot=(0, 5, 17, 31, 59))
    gmax = np.asarray(jnp.max(jnp.asarray(x), axis=0))
    want = np.argsort(gmax > 7, kind="stable")
    monkeypatch.setenv("MMVAE_FEATURE_PERM", "force")
    data, perm = cluster_features(torch.from_numpy(x).to(torch.int16), 1)
    np.testing.assert_array_equal(perm, want)
    assert list(perm[-5:]) == [0, 5, 17, 31, 59]
    np.testing.assert_array_equal(data.numpy(), x[:, want])
    assert "Feature clustering: 5 hot genes (count>7, 8.3%)" in \
        capsys.readouterr().err


@pytest.mark.parametrize("case", ["more than half hot", "no hot gene",
                                  "covar_dim == D", "MMVAE_FEATURE_PERM=0",
                                  "cpu without force"])
def test_cluster_gates_decline_silently(case, monkeypatch, capsys):
    D = 40
    x = _hot(D=D)
    covar_dim = 1
    monkeypatch.setenv("MMVAE_FEATURE_PERM", "force")
    if case == "more than half hot":
        x = _hot(D=D, hot=tuple(range(21)))
    elif case == "no hot gene":
        x = np.minimum(x, 7.0)
    elif case == "covar_dim == D":
        covar_dim = D
    elif case == "MMVAE_FEATURE_PERM=0":
        monkeypatch.setenv("MMVAE_FEATURE_PERM", "0")
    else:
        monkeypatch.delenv("MMVAE_FEATURE_PERM")
        x = _hot(D=600, hot=(3, 300))  # D >= 512, but no card
    t = torch.from_numpy(x).to(torch.int16)
    data, perm = cluster_features(t, covar_dim)
    assert perm is None and data is t
    assert "Feature clustering" not in capsys.readouterr().err


def _write_mtx(path, x):
    """(N, D) counts as a MatrixMarket file (genes x cells) + index."""
    from mmvae_tpu_torch.io.writers import write_matrix_market_file

    dens = x.T
    rr, cc = np.nonzero(dens)
    order = np.lexsort((rr, cc))
    write_matrix_market_file(path, rr[order], cc[order],
                             dens[rr, cc][order], dens.shape)
    build_mmutil_index(path, path + ".index")
    return path


def test_log_line_matches_jax_cli(tmp_path, monkeypatch, capfd):
    mtx = _write_mtx(str(tmp_path / "hot.mtx.gz"), _hot())
    common = ["--mtx", mtx, "--max_epoch", "1", "--recording", "2",
              "--batch_size", "16"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               MMVAE_FEATURE_PERM="force")
    r = subprocess.run([sys.executable, "-m", "mmvae_tpu.cli.nb_vae",
                        *common, "--out", str(tmp_path / "jax")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    monkeypatch.setenv("MMVAE_FEATURE_PERM", "force")
    capfd.readouterr()
    assert nb_vae.main(common + ["--out", str(tmp_path / "port"),
                                 "--device", "cpu"]) == 0
    port = LINE.findall(capfd.readouterr().err)
    jax_line = LINE.findall(r.stderr)
    assert len(port) == 1 and port == jax_line, (port, jax_line)


def test_dense_runner_on_permuted_data_matches_jax(hot_setup,  # noqa: F811
                                                   monkeypatch):
    """The port's epoch runner on port-permuted counts and parameters,
    fed JAX's draws, against JAX's ``make_ondevice_epoch`` on
    JAX-permuted ones; the unpermuted parameters agree too."""
    _, _, jmodel, dens = hot_setup
    x = dens.T.astype(np.int16)
    N, D = x.shape
    B, seed = 16, 5
    gmax = np.asarray(jnp.max(jnp.asarray(x), axis=0))
    jperm = jnp.asarray(np.argsort(gmax > 7, kind="stable"), jnp.int32)
    topt = JOptions(nboot=2, seed=seed)
    jfast = JFast(jmodel, topt)
    trainer = JTrainer(
        lambda p, xx, c, k, t: jmodel.forward(p, xx, c, k, t),
        lambda xx, o, b: nb_loss(xx, o, b), topt,
        report_loss_override=lambda p, xx, c, k, b: jmodel.fused_step_report(
            p, xx, c, k, b, include_data_const=True),
        boot_loss_override=lambda p, xx, c, k, b: jmodel.fused_step_boot(
            p, xx, c, k, b), fast_step=jfast)
    run = trainer.make_ondevice_epoch(
        types.SimpleNamespace(D=D), None, N, B,
        data_dense=jnp.take(jnp.asarray(x), jperm, axis=1))
    jparams0 = jmodel.init(jax.random.PRNGKey(2))
    jparams = _permute_d_axes(jparams0, jperm, D)
    jstate = trainer.optimizer.init(jparams)

    monkeypatch.setenv("MMVAE_FEATURE_PERM", "force")
    data, perm = cluster_features(torch.from_numpy(x), 1)
    np.testing.assert_array_equal(perm, np.asarray(jperm))
    fast = NBFastStep(NBVAE(data_dim=D), TrainingOptions(nboot=2, seed=seed))
    runner = DenseEpochRunner(fast, data, B, seed=seed)
    q = fast.pack(permute_d_axes(params_from_numpy(_np(jparams0)), perm, D))
    st = fast.optimizer.init(q)
    nbatch = N // B
    for epoch in range(2):
        jparams, jstate, jrep = run(jparams, jstate, epoch)
        rand = jax.jit(lambda: jfast.draw_rand(
            jax.random.fold_in(jax.random.PRNGKey(seed), jnp.int32(epoch)),
            jnp.arange(nbatch, dtype=jnp.int32), B))()
        q, st, reps, _ = runner(q, st, epoch, rand=rand_from_numpy(_np(rand)))
        np.testing.assert_allclose(reps.numpy(), np.asarray(jrep), rtol=2e-4)
    inv = np.argsort(perm)
    got = _flat(permute_d_axes(fast.unpack(q), inv, D))
    want = _flat(_np(_permute_d_axes(jparams, jnp.asarray(inv, jnp.int32),
                                     D)))
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=3e-3, atol=2e-5,
                                   err_msg=str(path))


@pytest.fixture()
def port_hot(tmp_path):
    """Port blocks over a hot matrix (B = 16) and its NB model."""
    x = _hot()
    mtx = _write_mtx(str(tmp_path / "hot.mtx.gz"), x)
    data = MtxMemoryBlock(mtx, mtx + ".index", 16, count_dtype="auto")
    cov = str(tmp_path / "cov.mtx.gz")
    create_ones_like(data, cov)
    build_mmutil_index(cov, cov + ".index")
    covar = MtxDataBlock(cov, cov + ".index", 16)
    covar.auto_ones = True
    return data, covar, NBVAE(data_dim=x.shape[1]), tmp_path


def _train(port_hot, perm, epochs=3, recorder=None, on_epoch_end=None,
           start_epoch=0, params=None, opt_state=None):
    data, covar, model, _ = port_hot
    topt = TrainingOptions(nboot=2, max_epoch=epochs, recording=2, seed=0)
    fast = NBFastStep(model, topt)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0))
    return train_vae_model(fast, recorder, data, covar, topt, params, "cpu",
                           start_epoch=start_epoch, init_opt_state=opt_state,
                           on_epoch_end=on_epoch_end, feature_perm=perm)


def test_clustered_training_matches_unclustered(port_hot, monkeypatch,
                                                capsys):
    """Losses, returned parameters and recorded artifacts of a clustered
    run against an unclustered one (JAX's tolerances), all in input gene
    order; a run resumed from the clustered run's epoch-2 checkpoint
    equals the uninterrupted one bitwise."""
    data, covar, model, tmp = port_hot

    def recorder(tag):
        return LatentRecorder(str(tmp / tag), 3, data.ntot(),
                              encode_fn=model.encode_mu, async_writes=True)

    p_ref, l_ref = _train(port_hot, False, recorder=recorder("ref"))
    assert "Feature clustering" not in capsys.readouterr().err
    monkeypatch.setenv("MMVAE_FEATURE_PERM", "force")
    ck = str(tmp / "ck")

    def on_end(epoch, p, o, losses):
        if epoch == 1:
            save_checkpoint(ck, p, epoch, 0, losses, opt_state=o)

    p_prm, l_prm = _train(port_hot, True, recorder=recorder("prm"),
                          on_epoch_end=on_end)
    assert "Feature clustering: 3 hot genes" in capsys.readouterr().err
    np.testing.assert_allclose(l_prm, l_ref, rtol=2e-4)
    ref = _flat(p_ref)
    for path, v in _flat(p_prm).items():
        np.testing.assert_allclose(v, ref[path], rtol=2e-3, atol=2e-4,
                                   err_msg=str(path))
    for name in (".mu_mean", ".mu_lnvar", "_mu_decoding.weight", "_x_mean",
                 "_nu_encoding.weight"):
        a, b = (np.loadtxt(gzip.open(tmp / f"{t}_1{name}.gz", "rt"))
                for t in ("ref", "prm"))
        np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-4, err_msg=name)
    # the checkpoint is in input order: resume it for the third epoch
    params_np, start, losses = load_checkpoint(ck, model)
    assert start == 2 and losses == l_prm[:2]
    p_res, l_res = _train(port_hot, True, start_epoch=start,
                          params=params_from_numpy(params_np),
                          opt_state=adam_from_numpy(load_opt_state(ck,
                                                                   model)))
    assert l_res == l_prm[2:]
    want = _flat(p_prm)
    for path, v in _flat(p_res).items():
        np.testing.assert_array_equal(v, want[path], err_msg=str(path))


@pytest.mark.parametrize("mixture", [False, True], ids=["joint", "mixture"])
def test_vmfnb_cli_clustered_matches_unclustered(tmp_path, monkeypatch,
                                                 mixture):
    """``vmfnb_vae`` (joint, and ``--annot``) under ``force`` against
    ``0``: every artifact in input gene order at this size (at D = 20,000
    the kappa head's float32 cancellation drifts further; PERF.md), and
    for the mixture the hook permutes the model's annotation on entry and
    restores it on the way out."""
    x = _hot()
    D = x.shape[1]
    mtx = _write_mtx(str(tmp_path / "hot.mtx.gz"), x)
    extra = []
    if mixture:
        annot, rows = str(tmp_path / "annot.txt"), str(tmp_path / "rows.txt")
        with open(rows, "w") as f:
            f.write("\n".join(f"g{i}" for i in range(D)) + "\n")
        with open(annot, "w") as f:
            f.write("\n".join(f"g{i}\tk{i % 4}" for i in range(D)) + "\n")
        extra = ["--annot", annot, "--row", rows]
    models, calls = [], []
    permute = VMFNBMixtureVAE.permute_features

    def recorded(self, order):
        models.append(self)
        calls.append(np.asarray(order).copy())
        permute(self, order)

    monkeypatch.setattr(VMFNBMixtureVAE, "permute_features", recorded)
    outs = {}
    for tag, env in (("ref", "0"), ("prm", "force")):
        monkeypatch.setenv("MMVAE_FEATURE_PERM", env)
        out = str(tmp_path / tag)
        assert vmfnb_vae.main(["--mtx", mtx, *extra, "--out", out,
                               "--max_epoch", "2", "--recording", "2",
                               "--batch_size", "16", "--device", "cpu"]) == 0
        outs[tag] = out

    def load(tag, name):
        return np.loadtxt(gzip.open(outs[tag] + name, "rt"))

    np.testing.assert_allclose(load("prm", ".scores.gz"),
                               load("ref", ".scores.gz"), rtol=2e-4)
    names = sorted(f[len("ref"):] for f in os.listdir(tmp_path)
                   if f.startswith("ref_1") and f.endswith(".gz"))
    assert len(names) == (31 if mixture else 28)  # K = 4 components
    for name in names:
        if name == "_1.clust.gz":
            assert (load("prm", name) == load("ref", name)).mean() >= 0.95
        else:
            np.testing.assert_allclose(load("prm", name), load("ref", name),
                                       rtol=2e-3, atol=2e-4, err_msg=name)
    if not mixture:
        assert calls == []
        return
    assert len(calls) == 2  # the clustered run: the order, then its inverse
    np.testing.assert_array_equal(calls[1], np.argsort(calls[0]))
    assert list(calls[0][-3:]) == [3, 17, 31]
    assert models[0] is models[1]
    np.testing.assert_array_equal(models[0].label,
                                  vmfnb_vae.load_label(annot, rows, D))


def test_probe_regime_shares():
    """``perm_probe.regime_shares`` against a direct count, in input and
    cold-first order: the cold-first order only adds fast tiles."""
    rng = np.random.default_rng(0)
    N, D, B, T = 50, 300, 10, 64
    x = rng.poisson(0.5, size=(N, D)).astype(np.float32)
    x[:, [5, 70, 140, 250]] += 9          # hot genes in four tiles
    x[3, 200] = 2.5                       # one non-integer count
    hot = x.max(0) > 7
    order = np.argsort(hot, kind="stable")

    def direct(xo):
        nt = -(-D // T)
        got = {"fast": 0, "mixed": 0, "general": 0}
        for b in range(N // B):
            for t in range(nt):
                tile = xo[b * B:(b + 1) * B, t * T:(t + 1) * T]
                whole = np.all(tile == np.floor(tile))
                fast = whole and tile.max() <= 7
                got["fast" if fast else "mixed" if whole else "general"] += 1
        return {k: v / (N // B * nt) for k, v in got.items()}

    for o in (np.arange(D), order):
        got = perm_probe.regime_shares(torch.from_numpy(x[:, o]), B)
        assert got["pairs"] == N // B * 5
        for k, v in direct(x[:, o]).items():
            assert got[k] == pytest.approx(v, abs=1e-12), k
    before = perm_probe.regime_shares(torch.from_numpy(x), B)["fast"]
    after = perm_probe.regime_shares(torch.from_numpy(x[:, order]), B)["fast"]
    # the non-integer count keeps one (batch, tile) pair general
    assert before == pytest.approx(0.2) and after == pytest.approx(0.76)


def test_probe_kernel_calls_and_main_need_a_card():
    """On the CPU the probe's calls run the plain versions (the wrappers
    take them for a CPU tensor), a permutation of the genes permutes
    K2's column outputs, and ``main`` refuses to measure."""
    x = torch.from_numpy(_hot(D=64)[:16]).to(torch.int8)
    gen = torch.Generator().manual_seed(0)
    zc, zn, depth, W = perm_probe.batch_operands(x, gen)
    o = torch.from_numpy(np.random.default_rng(1).permutation(64))
    a = perm_probe.kernel_calls(x, zc, zn, depth, W)
    b = perm_probe.kernel_calls(x[:, o], zc, zn, depth, W[:, o].contiguous())
    for k, (kern, plain) in a.items():
        torch.testing.assert_close(kern(), plain(), rtol=0, atol=0)
    ga, gb = a["nb_valgrad"][0]()[0], b["nb_valgrad"][0]()[0]
    torch.testing.assert_close(gb, ga[:, o], rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perm_probe.main([])
