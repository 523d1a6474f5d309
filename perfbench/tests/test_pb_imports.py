"""Nothing the benchmark runs imports JAX, Flax or the JAX package
``mmvae_tpu`` (top-level names compared whole: ``mmvae_tpu_torch`` is
the port), and the plain reference imports nothing of the port."""

import ast
import os

import pytest

from .conftest import REPO

PB = os.path.join(REPO, "perfbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "mmvae_tpu"}


def _modules():
    for d, _, files in os.walk(PB):
        if "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), REPO)


def _imports(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(_modules()))
def test_no_jax(path):
    bad = {n for n in _imports(path) if n.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(p for p in _modules()
                                        if "/reference/" in p))
def test_reference_is_independent(path):
    bad = {n for n in _imports(path)
           if n.split(".")[0] in FORBIDDEN | {"mmvae_tpu_torch"}
           or n.startswith("perfbench") and not n.startswith(
               "perfbench.reference")}
    assert not bad, f"{path} imports {bad}"


def test_whole_name_comparison():
    from perfbench.run import loaded_forbidden

    assert "mmvae_tpu_torch" not in loaded_forbidden()
