"""The benchmark's own tests: ``python -m pytest perfbench/tests -q``
from the repository's root.  Tests marked ``card`` need a CUDA card and
skip inside the test without one."""

import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
DATA = os.path.join(HERE, "data")


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


def run_cpu(workload: str, seed: int, trace: int = 0, root: str = DATA,
            extra_env=None):
    """``python3 -m perfbench.run`` on the CPU over the tests' tiny
    cells: (exit code, last stdout line, stderr)."""
    env = dict(os.environ, **(extra_env or {}))
    r = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", "0.5", "--trace", str(trace),
         "--device", "cpu", "--root", root,
         "--bench", os.path.join(root, "BENCHMARK.json")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    return r.returncode, lines[-1] if lines else "", r.stderr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
