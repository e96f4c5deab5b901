"""On an NVIDIA card: one short run of a one-card cell through the
command the driver runs, and its line.  Skips without a card (decided
inside the test).  Run on the card with
``python -m pytest benchmark/tests -m chip``."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: this machine has none")


@pytest.mark.chip
@pytest.mark.parametrize("trace", [0, 1])
def test_batch_cell_runs_on_the_card(trace):
    need_card()
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "wc-zipf30k-batch", "--seed",
         str(2**31 + 17), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=360, cwd=harness.ROOT,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"


def test_run_refuses_without_enough_cards():
    """Without the cards a cell asks for, no line and a non-zero exit."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has the card the batch cell asks for")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "wc-zipf30k-batch", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
