"""A configuration, a traffic mix and a per-layer metric that no file of
the harness names, from a temporary directory: the harness runs the cell
they make without an edit."""

import json
import os

from benchmark import harness

LAYER = '''
SPANS = [{"target": "av1tpu_torch.specav1.native:encode_tile_rows",
          "name": "tiles"}]


def read(run):
    spans = run.spans("tiles")
    return len(spans) / run.frames if spans else None
'''


def test_throwaway_cell_from_data_only(tmp_path):
    root = tmp_path
    b = root / "bench"
    for d in ("configs", "traffic", "limits", "layers", "end_to_end"):
        (b / d).mkdir(parents=True)
    src = os.path.join(harness.ROOT, "benchmark")
    for m in ("encode_fps", "setup_s"):
        with open(os.path.join(src, "end_to_end", m + ".py")) as f:
            (b / "end_to_end" / (m + ".py")).write_text(f.read())
    cfg = {"width": 128, "height": 128, "qindex": 120,
           "tpu": {"keyint": 1000, "chunk": 2, "cdef": False, "lr": False}}
    (b / "configs" / "tiny-clean.json").write_text(json.dumps(cfg))
    (b / "traffic" / "drift.json").write_text(json.dumps(
        {"content": "clean", "pool": 3, "warm_payloads": 3,
         "metric_frames": 2, "check_every": 1, "ring": 12,
         "profile": {"start": 0, "frames": 2}}))
    (b / "limits" / "tiny.drift.json").write_text(json.dumps(
        {"decode_mismatch_px": {"max": 0}}))
    (b / "layers" / "tile_calls_per_frame.py").write_text(LAYER)
    bench = {
        "command": ["python3", "bench/run.py"], "paths": ["bench"],
        "run_seconds": 1,
        "configs": [{"name": "tiny-clean", "source": "a test",
                     "file": "bench/configs/tiny-clean.json",
                     "reduced": [], "why": "a test"}],
        "workloads": [{"name": "tiny.drift", "config": "tiny-clean",
                       "traffic": "drift", "chips": 1, "why": "a test"}],
        "end_to_end": [
            {"name": "encode_fps", "unit": "frames/s", "better": "higher",
             "bound": 0.1, "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [{"name": "tile_calls_per_frame", "unit": "calls/frame",
                       "better": "lower", "source": "program_span",
                       "layer": "entropy", "moves": "encode_fps"}]}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for traced, name in ((False, "encode_fps"),
                         (True, "tile_calls_per_frame")):
        out = harness.run_cell("tiny.drift", 7, 1.0, traced,
                               spec_root=str(root), device="cpu",
                               log=lambda msg: None)
        assert out["correct"] is True, out["checks"]
        assert name in out["metrics"]
        assert list(out["checks"]) == ["decode_mismatch_px"]
