"""On the card: each cell through ``benchmark/run.py`` as a check runs
it, with a short window; the result line is correct.  Skips without a
card (run on the card: ``python3 -m pytest benchmark/tests -m cuda``)."""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import bench_tiny

CELLS = [w["name"] for w in bench_tiny.bench()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "2718281828459", "--seconds", "15", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
