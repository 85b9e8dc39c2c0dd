"""The command line without a card, and where only the benchmark's own
files are: a message, a non-zero exit, no result on stdout."""

import json
import shutil
import subprocess
import sys

import pytest

from perfbench import registry

ROOT = registry.HERE.parent


def run(cwd, *args):
    return subprocess.run([sys.executable, "-m", "perfbench", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


ARGS = ["--workload", "ak.serve.clip", "--seed", "2147483999", "--seconds", "1",
        "--trace", "0"]


def test_no_card_exits_non_zero_with_a_message():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is for the machines without one")
    p = run(ROOT, *ARGS)
    assert p.returncode != 0 and p.stdout == ""
    assert "cuda" in p.stderr.lower()


def test_only_the_benchmark_files_exit_non_zero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run(tmp_path, *ARGS)
    assert p.returncode != 0 and p.stdout == ""
    assert p.stderr.strip()


def test_an_unknown_cell_is_refused():
    p = run(ROOT, "--workload", "no.such.cell", "--seed", "1", "--seconds", "1")
    assert p.returncode != 0 and p.stdout == ""
    assert "unknown workload" in p.stderr and "ak.serve.clip" in p.stderr
    assert json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
