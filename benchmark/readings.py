"""The readings the limits of ``limits/<cell>.json`` are set from: one
cell's sound runs and its control runs (``--control 1`` of ``run.py``)
on several seeds, in one process, each a short window at the cell's own
size and load (the set-up of each run is its own stream and key; the
process's imports and kernel builds are paid once).

    python3 benchmark/readings.py --workload NAME --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 12 [--out FILE]

Prints one JSON line a run: the seed, whether it ran the control, and
the numbers compared with their limits, and appends it to ``--out``.
Exits 1 without the cell's cards.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    def seeds(s):
        return [int(x) for x in s.split(",") if x]
    runs = [(s, False) for s in seeds(args.seeds)] + \
        [(s, True) for s in seeds(args.control_seeds)]
    for seed, control in runs:
        t = time.perf_counter()
        try:
            out = harness.run_cell(args.workload, seed, args.seconds, False,
                                   t_start=t, control=control)
        except harness.NoDevice as e:
            print(f"no result: {e}", file=sys.stderr, flush=True)
            return 1
        line = json.dumps({
            "workload": args.workload, "seed": seed, "control": control,
            "correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "checks": out["checks"],
            "metrics": out["metrics"], "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
