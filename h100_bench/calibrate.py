"""The readings that the limits in limits/<cell>.json are set from: one
cell run on many seeds in one process (set-up paid per seed, the kernels'
build once), each with a short window at the cell's own load and the
timed path's outputs judged as in a full run; then the same with a control
put in the program's place (the kind's CONTROLS).

    python3 h100_bench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--control bf16_storage --control-seeds 21,22,23] [--seconds 4] \
        [--out calibrate.jsonl]

Prints one JSON line per run (seed, control, correct, readings) and writes
them to --out.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", action="append", default=[])
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from h100_bench import harness

    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), c) for c in args.control
             for s in args.control_seeds.split(",") if s]
    lines = []
    for seed, control in runs:
        t0 = time.perf_counter()
        r = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                             control=control)
        line = {"workload": args.workload, "seed": seed, "control": control,
                "correct": r["correct"], "attempted": r["attempted"],
                "readings": {k: c["value"] for k, c in r["checks"].items()},
                "metrics": {k: m["value"] for k, m in r["metrics"].items()},
                "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
