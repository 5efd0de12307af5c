"""``run.py`` finds no card here: it exits non-zero and prints no result,
and never falls back to the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("trace", ["0", "1"])
def test_run_without_a_card_prints_no_result(trace):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "dlrm_kaggle.train_b64k", "--seed", "3000000000", "--seconds", "1",
         "--trace", trace], capture_output=True, text=True, timeout=300,
        cwd=str(ROOT), env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA card" in out.stderr


def test_an_unknown_cell_prints_no_result():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "no_such.cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode != 0 and "{" not in out.stdout
