"""The command refuses to run without a card, and outside a checkout that
holds the program."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import REPO


def run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "mvsbench.run", "--workload",
         "sparse-ring.l0", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = run(REPO)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "mvsbench"), tmp_path / "mvsbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = run(str(tmp_path), env)
    assert out.returncode != 0
    assert out.stdout == ""
