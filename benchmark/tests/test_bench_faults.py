"""The comparison that decides ``correct`` fails the control and each
fault a cell can have (``faults.py``), planted underneath the timed path,
in tiny CPU runs of the cells; a sound run passes it (test_bench_cells)."""

import pytest

from benchmark import faults
from benchmark.tests import bench_tiny

# the P cells of BENCHMARK.json and of pending/
P_CELLS = [w["name"] for w in bench_tiny.bench()["workloads"]
           if w["traffic"] != "cuts"] + [
    e["workload"]["name"] for e in bench_tiny.pending()
    if e["workload"]["traffic"] != "cuts"]


@pytest.mark.parametrize("workload", P_CELLS + ["spec1080.cuts"])
def test_control_is_not_correct(workload, pending_root):
    out = bench_tiny.run(workload, control=True, spec_root=pending_root)
    assert out["correct"] is False
    assert out["checks"]["decode_mismatch_px"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(faults.P_FAULTS))
@pytest.mark.parametrize("workload", P_CELLS)
def test_p_cell_fault_is_not_correct(workload, fault, pending_root):
    out = bench_tiny.run(workload, faults=[faults.P_FAULTS[fault]],
                         spec_root=pending_root)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", sorted(faults.KEY_FAULTS))
def test_cuts_fault_is_not_correct(fault, pending_root):
    out = bench_tiny.run("spec1080.cuts", faults=[faults.KEY_FAULTS[fault]],
                         spec_root=pending_root)
    assert out["correct"] is False, out["checks"]
