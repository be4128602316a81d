"""The harness is driven by data: a cell, a configuration, a traffic mix
and a per-layer metric added as files (and entries in BENCHMARK.json) in a
copy of the benchmark are found and run by name, with no file of the
harness edited. The generators give the same inputs for the same seed.
One test needs the card (marker `gpu`) and skips elsewhere."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from h100_bench import generators as gen
from h100_bench_support import REPO, run_cell


def _add_probe_cell(root: str) -> None:
    b = os.path.join(root, "h100_bench")
    with open(os.path.join(b, "configs", "video_1080p_opencv.json")) as f:
        cfg = json.load(f)
    cfg.update(name="probe_video", frame={"height": 48, "width": 64},
               canvas={"height": 90, "width": 120, "sigmas": [1, 2, 4],
                       "mean": 128.0, "std": 40.0})
    with open(os.path.join(b, "configs", "probe_video.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "probe_b1.json"), "w") as f:
        json.dump({"kind": "video_step", "batch": 1, "features_limit": None,
                   "cross_check": True, "warmup_steps": 1, "trace_steps": 2}, f)
    with open(os.path.join(b, "limits", "probe_cell.json"), "w") as f:
        json.dump({"rows_unpaired": 0.01, "kp_xy_size_err": 0.01,
                   "kp_angle_off": 0.01, "kp_response_err": 1e-3,
                   "desc_rows_unequal": 0.1, "match_rows_differ": 0}, f)
    with open(os.path.join(b, "metrics", "probe.steps_traced.py"), "w") as f:
        f.write("def read(trace):\n"
                "    return float(len(trace.spans.get('bench.step', [])))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "probe_video", "source": "test",
                             "file": "h100_bench/configs/probe_video.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "probe_cell", "config": "probe_video",
                               "traffic": "probe_b1", "chips": 1, "why": "test"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "frames_per_s")["workloads"].append("probe_cell")
    bench["per_layer"].append({"name": "probe.steps_traced", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "probe", "moves": "frames_per_s",
                               "workloads": ["probe_cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def test_new_cell_config_and_metric_found_by_name(tmp_path):
    from h100_bench_support import make_tiny_copy

    root = make_tiny_copy(str(tmp_path))
    _add_probe_cell(root)
    traced = run_cell(root, "probe_cell", 2 ** 32 + 5, trace=1)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["probe.steps_traced"] == {"value": 2.0, "unit": "steps"}
    assert set(traced["device"]) >= {"busy_s", "window_s"}
    assert list(traced)[-3:-1] == ["breakdown", "checks"]  # then "forbidden", added by the test
    plain = run_cell(root, "probe_cell", 2 ** 32 + 5)
    assert set(plain["metrics"]) == {"frames_per_s", "setup_s"}
    assert plain["forbidden"] == traced["forbidden"] == []


def test_result_line_of_each_cell(tiny_root):
    r = run_cell(tiny_root, "index_query", -3)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert set(r["metrics"]) == {"query_ms", "setup_s"}
    assert r["checks"]["answer_rows_differ"]["limit"] == 0.0
    r = run_cell(tiny_root, "video_b4_limit2048", 9)
    assert set(r["metrics"]) == {"frames_per_s", "step_p95_ms", "setup_s"}


def test_generators_are_seeded():
    assert gen.seed_of(2 ** 31 + 3) == gen.seed_of(2 ** 31 + 3)
    assert gen.seed_of(2 ** 31 + 3) != gen.seed_of(2 ** 31 + 4)
    assert 0 <= gen.seed_of(-7, 2 ** 40) < 2 ** 63
    a = gen.canvas(2 ** 31 + 9, 80, 96, (1, 2, 4), 128.0, 30.0, "cpu")
    b = gen.canvas(2 ** 31 + 9, 80, 96, (1, 2, 4), 128.0, 30.0, "cpu")
    c = gen.canvas(2 ** 31 + 10, 80, 96, (1, 2, 4), 128.0, 30.0, "cpu")
    assert a.dtype == np.uint8 and np.array_equal(a, b) and not np.array_equal(a, c)
    p1 = gen.CameraPath(a, 40, 50, 4.0, 11).take(30)
    p2 = gen.CameraPath(b, 40, 50, 4.0, 11).take(30)
    assert np.array_equal(p1, p2) and p1.flags.c_contiguous
    # consecutive frames overlap: each is the last one moved by a few pixels
    assert all(not np.array_equal(p1[i], p1[i + 1]) for i in range(29))
    g1, g2 = (gen.device_generator(gen.seed_of(4), "cpu") for _ in range(2))
    r1 = gen.sift_rows(g1, 300, 128, 0.2, 512.0, "cpu")
    assert torch.equal(r1, gen.sift_rows(g2, 300, 128, 0.2, 512.0, "cpu"))
    norms = torch.linalg.vector_norm(r1.float(), dim=1)
    assert r1.dtype == torch.uint8 and bool(((norms - 512).abs() < 8).all())
    assert int(r1.max()) < 255


@pytest.mark.gpu
def test_cell_runs_on_the_card():
    """One short run of each cell on the card, through run.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for cell in cells:
        p = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                            cell, "--seed", str(2 ** 31 + 1), "--seconds", "2",
                            "--trace", "0"], capture_output=True, text=True,
                           timeout=1200, cwd=REPO)
        assert p.returncode == 0, p.stderr[-3000:]
        r = json.loads(p.stdout.strip().splitlines()[-1])
        assert r["correct"] and r["device"]["platform"] == "gpu", r
