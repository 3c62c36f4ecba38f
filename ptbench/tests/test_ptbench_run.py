"""The command: with no GPU it exits non-zero and prints nothing on
standard output, and in a directory holding only BENCHMARK.json and
``ptbench/`` it does the same."""

from __future__ import annotations

import shutil
import subprocess
import sys

from ptbench import harness

ROOT = harness.BENCH_DIR.parent


def _run(cwd):
    return subprocess.run([sys.executable, "ptbench/run.py", "--workload", "rtiow_1080p.pool",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_gpu_there_is_no_result(cuda_absent):
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_there_is_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "ptbench", tmp_path / "ptbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
