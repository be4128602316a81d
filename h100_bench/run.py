"""Run one cell of BENCHMARK.json once on the card(s) of this machine.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the CUDA context, the
kernels' libraries, the inputs from the seed, warm-up of the cell's own
shapes) is timed from the start of this script; then the window runs for
--seconds; with --trace 1 a few more steps run under the profiler. The
program's outputs in the window are judged against the plain reference
once the window has closed and the program's state is freed. The last
line on standard output is the result as one JSON object; the last lines
on standard error are the numbers compared, each beside its limit.

Exits 2, printing no result, without enough CUDA cards, and 3 if a module
of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run as a script, Python puts this directory first on the path; the
# harness is imported as the package h100_bench from the checkout's root
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from h100_bench import harness

    bench_path = os.path.join(ROOT, "BENCHMARK.json")
    with open(bench_path) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    chips = int(cells.get(args.workload, {}).get("chips", 1))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct {result['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
