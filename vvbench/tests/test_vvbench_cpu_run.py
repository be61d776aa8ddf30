"""A run without a CUDA card gives no result: the harness refuses before
it reports a CPU number under a device metric."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from vvbench.tests.toy import REPO, toy_root


def _run(cwd, workload="serve-query-b50-g20k"):
    return subprocess.run(
        [sys.executable, "-m", "vvbench.run", "--workload", workload,
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


@pytest.fixture
def cpu_only():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here: the refusal is for machines "
                    "without one")


@pytest.mark.parametrize("workload", ["serve-query-b50-g20k",
                                      "train-embed-b128-resident"])
def test_a_toy_run_on_the_cpu_fails_its_device_check(tmp_path, cpu_only,
                                                     workload):
    out = _run(toy_root(tmp_path), workload)
    assert out.returncode == 3
    assert out.stdout == ""
    assert "torch.cuda.is_available() is false" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """A directory with BENCHMARK.json and vvbench/ alone: no program."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "vvbench", tmp_path / "vvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


def test_an_unknown_workload_is_refused(tmp_path):
    out = _run(REPO, "no-such-cell")
    assert out.returncode == 2 and out.stdout == ""
