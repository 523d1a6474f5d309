"""The port's serving CLI (``mmvae_tpu_torch.cli.encode --model nb``)
end to end against the JAX package's ``mmvae_tpu.cli.encode`` on one
checkpoint trained by ``mmvae_tpu.cli.nb_vae``.

The posterior files are ``%g`` text (6 significant digits), so they are
compared with ``rtol=1e-4, atol=1e-5``.
"""

import ast
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


def test_port_serving_imports_no_jax():
    """Every module of the port imports without loading JAX or any module
    of the JAX package, and ``chip_smoke.py`` imports none of either."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mmvae_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " 'mmvae_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'mmvae_tpu'"
        " or m.startswith('mmvae_tpu.'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 30, names\n"
        "assert 'mmvae_tpu_torch.benchmarks.perm_probe' in names, names\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=ROOT),
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
    assert any(m.startswith("mmvae_tpu_torch") for m in imported)
    bad = {m for m in imported
           if m.split(".")[0] in ("jax", "jaxlib", "mmvae_tpu")}
    assert not bad, bad


def test_port_data_block_matches_jax(tmp_path):
    """The port's copy of ``MtxDataBlock`` yields the same batches as the
    JAX package's on a small synthetic ``.mtx.gz``, with the wrap-around
    schedule of both copies of ``sequential_batches``."""
    from mmvae_tpu.data.block import MtxDataBlock as JBlock
    from mmvae_tpu.data.pipeline import sequential_batches as jseq
    from mmvae_tpu_torch.cli import make_synthetic
    from mmvae_tpu_torch.data.block import MtxDataBlock as PBlock
    from mmvae_tpu_torch.data.pipeline import sequential_batches as pseq

    mtx = str(tmp_path / "syn.mtx.gz")
    assert make_synthetic.main(["--out", mtx, "--genes", "50", "--cells",
                                "70", "--depth_mean", "200", "--seed", "3",
                                "--index"]) == 0
    jb = JBlock(mtx, mtx + ".index", 16)
    pb = PBlock(mtx, mtx + ".index", 16)
    assert (pb.ntot(), pb.nfeature()) == (jb.ntot(), jb.nfeature())
    batches = pseq(pb.ntot(), 16)
    assert [list(b) for b in batches] == [list(b) for b in jseq(70, 16)]
    for batch in batches:
        jb.clear()
        pb.clear()
        np.testing.assert_array_equal(pb.read(batch), jb.read(batch))


def test_other_models_not_ported(served, tmp_path, capfd):
    """Tensor-parallel serving (refused until it was ported; its
    two-process sweeps are tests/test_torch_tp_cli.py's) in one process:
    ``--tensor_parallel 2`` raises JAX's error that 2 does not divide the
    one device, for ``--model nb`` and ``--model vmf`` (D = 30); with
    ``--tensor_parallel 4``, which does not divide D, it logs JAX's "TP
    serving skipped" line and serves on one device, the bits of the run
    without the flag."""
    from mmvae_tpu_torch.models.vmf import VMFVAE
    from mmvae_tpu_torch.train.checkpoint import save_checkpoint

    vck = str(tmp_path / "vck")
    save_checkpoint(vck, VMFVAE(30, 1).init(torch.Generator().manual_seed(0)),
                    0, 0)
    args = _port_args(served, str(tmp_path / "x"))
    with pytest.raises(ValueError, match="does not divide 1 devices"):
        port_encode.main(args + ["--model", "vmf", "--checkpoint", vck,
                                 "--tensor_parallel", "2"])
    with pytest.raises(ValueError, match="does not divide 1 devices"):
        port_encode.main(args + ["--tensor_parallel", "2"])
    capfd.readouterr()
    assert port_encode.main(args + ["--tensor_parallel", "4"]) == 0
    assert ("TP serving skipped: D=30 not divisible by --tensor_parallel 4"
            in capfd.readouterr().err)
    assert port_encode.main(_port_args(served, str(tmp_path / "y"))) == 0
    for key in ("mean", "lnvar"):
        assert np.array_equal(read_data_file(f"{tmp_path}/x.mu_{key}.gz"),
                              read_data_file(f"{tmp_path}/y.mu_{key}.gz"))


def test_build_dense_numpy_fill_matches_native(served, monkeypatch):
    """The host fill without the C++ extension gives the same narrow
    matrix as the native one."""
    from mmvae_tpu_torch.data.block import MtxDataBlock
    from mmvae_tpu_torch.io import native

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
