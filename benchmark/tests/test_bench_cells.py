"""Every cell of BENCHMARK.json, and each pending cell (``pending/``),
loads from its data files and runs once, tiny, on the CPU, with the
result line the benchmark fixes."""

import json
import os

import pytest

from benchmark import harness
from benchmark.tests import bench_tiny

BENCH = bench_tiny.bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
PENDING = [e["workload"]["name"] for e in bench_tiny.pending()]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("workload", CELLS + PENDING)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_tiny(workload, traced, pending_root):
    root = pending_root if workload in PENDING else harness.ROOT
    out = bench_tiny.run(workload, traced, spec_root=root)
    assert set(out) == KEYS | ({"breakdown"} if traced else set())
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    cell = harness.load_cell(workload, root)
    want = {m["name"] for m, _ in
            cell["per_layer" if traced else "end_to_end"]}
    assert set(out["metrics"]) <= want
    if not traced:
        # the end-to-end metrics are host readings, present on the CPU too
        assert set(out["metrics"]) == want
        assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(out)


def test_every_metric_has_a_reader_and_every_cell_its_files(pending_root):
    with open(os.path.join(pending_root, "BENCHMARK.json")) as f:
        b = json.load(f)
    bdir = os.path.join(harness.ROOT, b["paths"][0])
    for m in b["end_to_end"]:
        assert os.path.exists(os.path.join(bdir, "end_to_end",
                                           m["name"] + ".py"))
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(bdir, "layers",
                                           m["name"] + ".py"))
    for w in CELLS + PENDING:
        cell = harness.load_cell(w, pending_root)
        assert cell["limits"] and cell["traffic"]["content"]
