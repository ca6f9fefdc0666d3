"""The benchmark of av1tpu_torch on one NVIDIA H100.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Runs the cell ``NAME`` of ``BENCHMARK.json``
(``harness.run_cell``) and prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; then ``checks``, each number the
comparison read beside its limit, which are also the last lines on
standard error.  Without the cell's CUDA cards, or with JAX or the JAX
package loaded once the window has closed, it prints no result and exits
with 1.  ``--control 1`` puts the control in the program's place in the
comparison, and ``--fault NAME`` plants a fault of ``faults.py``
underneath the timed path (the runs that show the comparison failing
them; never in a measured run).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import faults, harness
    try:
        out = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            t_start=T_START, control=bool(args.control),
            faults=[faults.FAULTS[args.fault]] if args.fault else ())
    except harness.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr, flush=True)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
