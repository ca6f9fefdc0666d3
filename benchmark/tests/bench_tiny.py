"""Tiny CPU runs of the benchmark's cells for its tests: the plain
PyTorch versions at 192x128, with the traffic's counts cut to fit a
one-second window.  ``pending_root`` is BENCHMARK.json with the entries
of the cells under ``pending/`` added (a pending cell's configuration,
its workload, its own metrics, and its name in the ``workloads`` of the
metrics it ``join``s), over the repo's benchmark files."""

import glob
import json
import os

from benchmark import harness

SIZE = (192, 128)
SEED = 2 ** 33 + 5
# by traffic mix
OVERRIDES = {
    "grain-p": {"metric_frames": 8, "profile": {
        "start": 0, "frames": 8, "spans": {"encode_chunk": 2}}},
    "clean-p": {"metric_frames": 8, "profile": {
        "start": 0, "frames": 8, "spans": {"encode_chunk": 2}}},
    "cuts": {"profile": {"start": 0, "frames": 1, "count_ops": 1,
                         "waves": [2, 4]}},
}
BDIR = os.path.join(harness.ROOT, "benchmark")


def bench(root=harness.ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def pending() -> list:
    out = []
    for p in sorted(glob.glob(os.path.join(BDIR, "pending", "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def pending_root(tmp) -> str:
    b = bench()
    for e in pending():
        if all(c["name"] != e["config"]["name"] for c in b["configs"]):
            b["configs"].append(e["config"])
        b["workloads"].append(e["workload"])
        for m in b["end_to_end"] + b["per_layer"]:
            if m["name"] in e["join"]:
                m["workloads"].append(e["workload"]["name"])
        b["end_to_end"] += e["end_to_end"]
        b["per_layer"] += e["per_layer"]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    os.symlink(BDIR, os.path.join(tmp, "benchmark"))
    return str(tmp)


def run(workload, traced=False, **kw):
    cells = {w["name"]: w for w in
             bench(kw.get("spec_root", harness.ROOT))["workloads"]}
    kw.setdefault("overrides", OVERRIDES.get(cells[workload]["traffic"]))
    return harness.run_cell(workload, SEED, 1.0, traced, device="cpu",
                            size=SIZE, log=lambda msg: None, **kw)
