"""The port's trainer CLIs on every data tier against the dense-resident
tier, bitwise: host streaming (``--data_mode stream``, and
``--no_auto_ondevice`` on the in-memory block), ELL-resident
(``MMVAE_DENSE_BYTES`` small, ``MMVAE_ROTATE=0``) and rotating shards —
the same ``scores.gz``, recording artifacts (their decompressed text) and
checkpoint arrays, since every tier gives the step the same batch values
and draws and the steps are storage-invariant.  Also: streaming never
builds the in-memory block, each tier logs the JAX package's line, and
the port CLI writes the JAX CLI's artifacts (names and shapes) on the
host-streaming and rotating tiers.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from mmvae_tpu.io.writers import read_data_file
from mmvae_tpu_torch.cli import nb_vae, vmf_vae, vmfnb_vae
from mmvae_tpu_torch.data import block
from mmvae_tpu_torch.io.writers import write_matrix_market_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N_CELLS, B = 40, 70, 16

TIERS = {
    "stream": ({}, ["--data_mode", "stream"], "cells/sec)"),
    "no_auto": ({}, ["--no_auto_ondevice"], "cells/sec)"),
    "ell": ({"MMVAE_DENSE_BYTES": "1", "MMVAE_ROTATE": "0"}, [],
            "Loading data on device (ELL layout)"),
    "rotate": ({"MMVAE_DENSE_BYTES": "1", "MMVAE_SHARD_BYTES": "2000",
                "MMVAE_SHARD_LAYOUT": "csr"}, [],
               "host-resident shards through HBM"),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiers")
    rng = np.random.default_rng(8)
    dens = rng.poisson(1.3, size=(D, N_CELLS)).astype(np.float32)
    dens[D - 1] += 1  # gene D - 1 beside the ELL pads
    dens[:2, ::9] += 20
    rr, cc = np.nonzero(dens)
    mtx = str(tmp / "m.mtx.gz")
    write_matrix_market_file(mtx, rr, cc, dens[rr, cc], (D, N_CELLS))
    feats = str(tmp / "row.txt")
    with open(feats, "w") as f:
        f.write("".join(f"g{i}\n" for i in range(D)))
    annot = str(tmp / "annot.txt")
    with open(annot, "w") as f:
        f.write("".join(f"g{i} T{i % 3}\n" for i in range(0, D, 2)))
    return tmp, mtx, ["--annot", annot, "--row", feats]


def _run(cli, tmp, out, args, env, capfd=None):
    common = ["--batch_size", str(B), "--recording", "2", "--max_epoch",
              "2", "--device", "cpu", "--out", str(tmp / out),
              "--checkpoint_dir", str(tmp / (out + "_ck"))]
    old = dict(os.environ)
    os.environ.update(env)
    try:
        assert cli.main(args + common) == 0
    finally:
        os.environ.clear()
        os.environ.update(old)
    return capfd.readouterr().err if capfd is not None else ""


def _outputs(tmp, out):
    """Every artifact's decompressed bytes and every checkpoint array."""
    got = {f[len(out):]: gzip.open(tmp / f).read()
           for f in os.listdir(tmp)
           if f.startswith(out + "_") and f.endswith(".gz")
           or f == out + ".scores.gz"}
    with np.load(tmp / (out + "_ck") / "ckpt.npz") as z:
        got.update({k: z[k] for k in z.files if k != "__meta__"})
    return got


def _assert_same(a, b):
    assert a.keys() == b.keys() and len(a) > 20
    for k in a:
        assert np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) \
            else a[k] == b[k], k


@pytest.fixture(scope="module")
def dense_nb(data):
    tmp, mtx, _ = data
    _run(nb_vae, tmp, "nbdense", ["--mtx", mtx], {})
    return _outputs(tmp, "nbdense")


@pytest.mark.parametrize("tier", list(TIERS))
def test_nb_tier_matches_dense_bitwise(data, dense_nb, capfd, tier):
    tmp, mtx, _ = data
    env, flags, line = TIERS[tier]
    err = _run(nb_vae, tmp, "nb" + tier, ["--mtx", mtx] + flags, env, capfd)
    assert line in err
    assert ("on-device" in err) == (tier in ("ell", "rotate"))
    assert "dense-resident" not in err
    _assert_same(_outputs(tmp, "nb" + tier), dense_nb)


MODELS = {  # (CLI, flags, the mixture's --annot --row)
    "nb_generic": (nb_vae, ["--mean_encoding", "8", "--mean_decoding", "6"],
                   False),
    "vmf": (vmf_vae, [], False),
    "vmf_generic": (vmf_vae, ["--encoding", "8"], False),
    "joint": (vmfnb_vae, [], False),
    "joint_generic": (vmfnb_vae, ["--mean_encoding", "8",
                                  "--vmf_decoding", "6"], False),
    "mixture": (vmfnb_vae, [], True),
    "mixture_generic": (vmfnb_vae, ["--no_fused_step"], True),
}


@pytest.mark.parametrize("model", list(MODELS))
def test_models_train_on_every_tier(data, model):
    """Each model on its packed and its generic step: host streaming,
    ELL and rotation give the dense-resident run's bits."""
    tmp, mtx, annot = data
    cli, flags, mixture = MODELS[model]
    flags = flags + (annot if mixture else [])
    args = ["--mtx", mtx] + flags
    _run(cli, tmp, model + "dense", args, {})
    want = _outputs(tmp, model + "dense")
    for tier in ("stream", "ell", "rotate"):
        env, extra, _ = TIERS[tier]
        _run(cli, tmp, model + tier, args + extra, env)
        _assert_same(_outputs(tmp, model + tier), want)


def test_stream_never_loads_the_matrix(data, monkeypatch, capfd):
    """``--data_mode stream`` trains from the file: no in-memory block is
    constructed (for the data or the covariate)."""
    tmp, mtx, _ = data

    def refuse(*a, **k):
        raise AssertionError("MtxMemoryBlock constructed")

    monkeypatch.setattr(block.MtxMemoryBlock, "__init__", refuse)
    err = _run(nb_vae, tmp, "nbnomem", ["--mtx", mtx, "--data_mode",
                                        "stream"], {}, capfd)
    assert "Loaded sparse matrix in memory" not in err
    assert "Auto-enabling" not in err and "on-device" not in err


def test_ondevice_flag_loads_a_streaming_block(data, dense_nb, capfd):
    """``--ondevice`` on a streaming block loads it and trains on the
    device, as the JAX package does."""
    tmp, mtx, _ = data
    err = _run(nb_vae, tmp, "nbondev", ["--mtx", mtx, "--data_mode",
                                        "stream", "--ondevice"], {}, capfd)
    assert "dense-resident" in err and "Auto-enabling" not in err
    _assert_same(_outputs(tmp, "nbondev"), dense_nb)


def _run_jax(args, env):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               MMVAE_FEATURE_PERM="0", **env)
    r = subprocess.run([sys.executable, "-m", "mmvae_tpu.cli.nb_vae"] + args,
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stderr


def _artifacts(tmp, prefix):
    return {f[len(prefix):]: read_data_file(str(tmp / f)).shape
            for f in os.listdir(tmp)
            if f.startswith(prefix + "_") and f.endswith(".gz")}


@pytest.mark.parametrize("tier", ["stream", "rotate"])
def test_cli_artifacts_match_jax_cli(data, tier):
    """The JAX CLI on the same tier (its log says so) writes the files
    the port's run wrote, by name and shape."""
    tmp, mtx, _ = data
    env, flags, line = TIERS[tier]
    err = _run_jax(["--mtx", mtx, "--batch_size", str(B), "--recording",
                    "2", "--max_epoch", "2",
                    "--out", str(tmp / ("jax" + tier))] + flags, env)
    assert line in err
    _run(nb_vae, tmp, "port" + tier, ["--mtx", mtx] + flags, env)
    port = _artifacts(tmp, "port" + tier)
    assert port == _artifacts(tmp, "jax" + tier) and len(port) == 28
    assert port["_1.mu_mean.gz"] == (N_CELLS, 2)
