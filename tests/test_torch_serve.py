"""The port's serving CLI (``mmvae_tpu_torch.cli.encode --model nb``)
end to end against the JAX package's ``mmvae_tpu.cli.encode`` on one
checkpoint trained by ``mmvae_tpu.cli.nb_vae``.

The posterior files are ``%g`` text (6 significant digits), so they are
compared with ``rtol=1e-4, atol=1e-5``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmvae_tpu.io.writers import read_data_file, write_matrix_market_file
from mmvae_tpu_torch.cli import encode as port_encode
from mmvae_tpu_torch.ops import _cuda
from mmvae_tpu_torch.ops.enc_kernel import count_encode
from mmvae_tpu_torch.train import loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", module] + args,
                       capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return r


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny mtx (D=30, N=80), a 2-epoch JAX checkpoint, and the JAX
    encode of it."""
    tmp = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(5)
    D, N = 30, 80
    dens = rng.poisson(1.5, size=(D, N)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    rr, cc = np.nonzero(dens)
    mtx = str(tmp / "train.mtx.gz")
    write_matrix_market_file(mtx, rr, cc, dens[rr, cc], (D, N))
    ckpt = str(tmp / "ckpt")
    _run("mmvae_tpu.cli.nb_vae", [
        "--mtx", mtx, "--out", str(tmp / "t"), "--max_epoch", "2",
        "--batch_size", "40", "--checkpoint_dir", ckpt])
    _run("mmvae_tpu.cli.encode", [
        "--model", "nb", "--mtx", mtx, "--checkpoint", ckpt,
        "--out", str(tmp / "jax"), "--batch_size", "40"])
    want = tuple(read_data_file(str(tmp / f"jax.mu_{k}.gz"))
                 for k in ("mean", "lnvar"))
    return mtx, ckpt, want


def _port_args(served, out, device="cpu"):
    mtx, ckpt, _ = served
    return ["--model", "nb", "--mtx", mtx, "--checkpoint", ckpt,
            "--out", out, "--batch_size", "40", "--device", device]


@pytest.mark.parametrize("branch", ["resident", "streaming"])
def test_port_encode_matches_jax(served, tmp_path, monkeypatch, capfd,
                                 branch):
    if branch == "streaming":
        monkeypatch.setenv("MMVAE_DENSE_BYTES", "1")
    out = str(tmp_path / "port")
    launches = count_encode.launches
    assert port_encode.main(_port_args(served, out)) == 0
    err = capfd.readouterr().err
    if branch == "resident":
        assert "dense-resident" in err and "cells/sec" in err
    else:
        assert "resident fast path skipped" in err
    assert count_encode.launches == launches  # CPU: plain version only
    for key, want in zip(("mean", "lnvar"), served[2]):
        got = read_data_file(f"{out}.mu_{key}.gz")
        assert got.shape == want.shape == (80, 2)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_device_cuda_without_gpu_fails(served, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")
    out = str(tmp_path / "nogpu")
    assert port_encode.main(_port_args(served, out, device="cuda")) != 0
    assert not os.listdir(tmp_path)


PORT_MODULES = [
    "cli.encode", "cli.nb_vae", "cli.common", "cli.make_synthetic",
    "models.nb", "models.modules", "ops.enc_kernel", "ops.nb_step",
    "ops.nb_fast", "ops.nb_elbo", "ops.losses", "ops.initializers",
    "ops._cuda", "train.loop", "train.checkpoint", "train.recorder",
    "train.config"]


def test_port_serving_imports_no_jax():
    """Every module of the port imports without loading JAX."""
    code = ("import sys, importlib\n"
            + "".join(f"importlib.import_module('mmvae_tpu_torch.{m}')\n"
                      for m in PORT_MODULES)
            + "assert 'jax' not in sys.modules, 'jax imported'")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=ROOT),
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_other_models_not_ported(served, tmp_path):
    args = _port_args(served, str(tmp_path / "x"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_encode.main(args + ["--model", "vmf"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_encode.main(args + ["--tensor_parallel", "2"])


def test_build_dense_numpy_fill_matches_native(served, monkeypatch):
    """The host fill without the C++ extension gives the same narrow
    matrix as the native one."""
    from mmvae_tpu.data.block import MtxDataBlock
    from mmvae_tpu.io import native

    mtx = served[0]
    blk = loop.as_memory_block(MtxDataBlock(mtx, mtx + ".index", 40))
    want = loop.build_dense(blk, "cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    got = loop.build_dense(blk, "cpu")
    assert got.dtype == want.dtype and got.shape == (80, 30)
    assert torch.equal(got, want)


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No nvcc: the build raises; nothing falls back."""
    import shutil

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("checks a host without the CUDA compiler")
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_cuda, "LIB_PATH", str(tmp_path / "lib.so"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build()
    assert not os.path.exists(tmp_path / "lib.so")
