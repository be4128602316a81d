"""One run of one cell: set-up, the measured window, the traced steps, the
judgement and the result line. Driven by data: the cell's entry in
BENCHMARK.json names its configuration (`configs[].file`) and its traffic
mix (`traffic/<traffic>.json`, whose `kind` names the generator
`kinds/<kind>.py`); its readings' limits are `limits/<cell>.json`; each
per-layer metric is read by `metrics/<metric>.py`.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "sift_features_tpu")


@dataclasses.dataclass
class Context:
    workload: dict
    config: dict
    traffic: dict
    seed: int
    device: str
    control: str | None = None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, workload: str, seed: int, device: str,
              control: str | None = None):
    """(the cell's context, BENCHMARK.json, the bench directory)."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    bench_dir = os.path.join(root, bench["paths"][0])
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    ctx = Context(w, _load_json(os.path.join(root, conf["file"])),
                  _load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")),
                  seed, device, control)
    return ctx, bench, bench_dir


def _applies(metric: dict, cell: str, reported: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def _reader(bench_dir: str, name: str):
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             control: str | None = None, workers: int | None = None,
             log=None) -> dict:
    """Run the cell once and return the result dict (its keys in the order
    they are printed, `checks` last). t_start: the process's start on the
    perf_counter clock, where set-up is counted from."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    ctx, bench, bench_dir = load_cell(root, workload, seed, device, control)
    name = ctx.workload["name"]
    kind = importlib.import_module(f"h100_bench.kinds.{ctx.traffic['kind']}")
    limits = _load_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    import torch

    on_cuda = str(device).startswith("cuda")
    cell = kind.Cell(ctx)
    cell.setup()
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    cell.in_window = True
    t0 = time.perf_counter()
    while True:
        cell.step()
        window_s = time.perf_counter() - t0
        if window_s >= seconds:
            break
    cell.in_window = False
    attempted = len(cell.latencies)
    e2e = cell.end_to_end(window_s)
    e2e["setup_s"] = setup_s

    tr = None
    if trace:
        from . import tracing
        import sift_features_tpu_torch as port

        n = int(ctx.traffic.get("trace_steps", 6))

        def steps():
            for _ in range(n):
                cell.step(traced=True)
            if on_cuda:
                torch.cuda.synchronize()

        tr = tracing.record(steps, n, tracing.program_kernels(
            os.path.dirname(port.__file__)), cell.trace_cell())
    peak = int(torch.cuda.max_memory_allocated()) if on_cuda else 0
    for line in cell.audit():
        print(line, flush=True)
        log(line)
    cell.free()
    if on_cuda:
        torch.cuda.empty_cache()

    t_j = time.perf_counter()
    if workers is None:
        workers = max(1, (os.cpu_count() or 2) - 2)
    readings = cell.judge(workers)
    log(f"judged in {time.perf_counter() - t_j:.1f} s")
    missing = sorted(set(readings) - set(limits))
    if missing:
        raise SystemExit(f"no limit for the readings {missing} in limits/{name}.json")
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in readings.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    if trace:
        metrics = {}
        reported = {e["name"] for e in bench["end_to_end"] if _applies(e, name)}
        for m in bench["per_layer"]:
            if not _applies(m, name, reported):
                continue
            v = _reader(bench_dir, m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in bench["end_to_end"] if _applies(m, name)}
    if on_cuda:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": int(ctx.workload.get("chips", 1)),
               "memory_peak_bytes": peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s()
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result
