"""The command refuses to measure without a card, and without the program."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness


def _run(cwd: Path, env_path: str):
    cmd = [sys.executable, "-m", "portbench.run", "--workload", "vgg16_largefov.stage1", "--seed", "3",
           "--seconds", "1", "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin", "HOME": str(cwd)},
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = _run(harness.ROOT, str(harness.ROOT))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path: Path):
    """A directory with only BENCHMARK.json and portbench/: no program."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path, str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_unknown_workload_is_refused():
    cmd = [sys.executable, "-m", "portbench.run", "--workload", "no.such", "--seed", "1", "--seconds", "1"]
    out = subprocess.run(cmd, cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout.strip() == ""
