"""Helpers of the harness's CPU tests: a copy of the benchmark at a tiny
size (`make_tiny_copy`) and `run_cell`, one run of a cell of such a copy on the
CPU in a fresh process, with the look for a card skipped, optionally with
a control in the program's place or a fault planted in it."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)

# what the tiny copy changes in each data file: sizes only
TINY = {
    "configs/video_1080p_opencv.json": {
        "frame": {"height": 64, "width": 80},
        "canvas": {"height": 120, "width": 150, "sigmas": [1, 2, 4, 8],
                   "mean": 128.0, "std": 40.0}},
    "configs/keyframe_index_kitti00.json": {
        "map": {"keyframes": 8, "rows_per_keyframe": 320, "dim": 128,
                "magnitude_cap": 0.2, "l2_norm": 512.0}},
    "traffic/batch4.json": {"batch": 2, "warmup_steps": 1, "trace_steps": 1},
    "traffic/batch4_limit2048.json": {"batch": 2, "features_limit": 30,
                                      "warmup_steps": 1, "trace_steps": 1},
    "traffic/loop_closure_8192.json": {"query_rows": 64, "trace_steps": 2},
}


def make_tiny_copy(dst: str) -> str:
    """BENCHMARK.json, with the parked cells of parked.json added, and the
    benchmark's folder under dst, at TINY sizes."""
    shutil.copytree(BENCH, os.path.join(dst, "h100_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(BENCH, "parked.json")) as f:
        parked = json.load(f)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] += parked[key]
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for rel, upd in TINY.items():
        path = os.path.join(dst, "h100_bench", rel)
        with open(path) as f:
            d = json.load(f)
        d.update(upd)
        with open(path, "w") as f:
            json.dump(d, f)
    return dst


def run_cell(root: str, workload: str, seed: int, seconds: float = 0.0,
             trace: int = 0, control: str | None = None,
             fault: str | None = None) -> dict:
    """One run of the harness on the CPU in a fresh process; the result
    dict, with the top-level names of JAX's modules it found loaded under
    `forbidden`."""
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{root!r}, {REPO!r}, {HERE!r}]\n"
        "import faults\n"
        f"faults.apply({fault!r})\n"
        "from h100_bench import harness\n"
        f"r = harness.run_cell({root!r}, {workload!r}, {seed}, {seconds}, "
        f"{bool(trace)}, device='cpu', control={control!r}, workers=0, "
        "log=lambda s: None)\n"
        "r['forbidden'] = harness.forbidden_modules()\n"
        "print(json.dumps(r))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, cwd=root, env=env)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])
