#!/usr/bin/env python3
"""Kernel times of several checkouts of the port, in turns, on one card.

    python3 kernel_ab.py [--out FILE.json] PARENT_DIR . . PARENT_DIR

Runs, for each directory in the order given and each in a process of its
own (so each imports its own `sift_features_tpu_torch` and builds its own
kernels), that checkout's `chip_smoke.py` kernel phases on the 1080p B=4
batch: phase 3 (every kernel against its plain version, per-launch times,
bounds) and phase 11a (the storage forms); the device time of the refine
kernels K3, K4, K4:bf16, K10 and K11 (`refine_device_ms` of the
chip_smoke.py beside this script, run on that checkout's package: CUDA
graph replays of the wrappers) and of the window kernels K5 and K8 (K8's
three bucket launches on K5's lanes, `window_device_ms`), f32 on the main
step's octave-0 lanes and bf16 on the bf16 step's; then phase 4's
per-kernel device time inside one main step (CUDA events around each
wrapper call), the matcher's `match_ms` on that step's descriptors (phase
4's measure: CUDA events around the B cross-check matches, here over 20
repetitions, host-bound) and their device time (`device_ms` of the
chip_smoke.py beside this script: the B matches replayed from a CUDA
graph), the median of 10 main steps (host clock around each, ending
in a synchronize), the peak memory of each stage of `extract_batch` in the
default and the storage modes and, last (a profiler session slows every
later launch in its process), two torch.profiler sessions: each refine
kernel and K5 and K8 alone (`kernel_alone_ms`: an older checkout's
wrappers also cast and zero-fill on the card, which its device times
include, and K8's wrapper clamps), then one window_kernel="perkey" step
and one storage_dtype="bfloat16" step, with K8's launches in the first
and K4:bf16's in the second summed. Prints each run's lines and, at the end,
one table of per-launch times by kernel and run and the step medians by
run; with --out, writes every number to that JSON file. Comparing
checkouts within one run, parent / change / change / parent, keeps the
card and its power limit the same.
"""

import json
import os
import statistics
import subprocess
import sys
import time


def step_kernels(torch, cs_here, steps) -> dict:
    """{"K8": ..., "K4:bf16": ...}: (summed device ms, launches) of each in
    one torch.profiler session around steps (a warm perkey step, where K8
    runs, and a warm bf16 step, where K4:bf16 runs)."""
    from torch.profiler import ProfilerActivity, profile

    for fn in steps:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in steps:
            fn()
        torch.cuda.synchronize()
    got = cs_here.profiled_kernels(prof, {k: cs_here.ALONE_KERNELS[k]
                                          for k in ("K8", "K4:bf16")})
    return {k: {"ms": ms, "launches": n} for k, (ms, n) in got.items()}


def one(tree: str) -> dict:
    """The kernel phases of the checkout at `tree`, in this process."""
    import importlib.util

    here = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "chip_smoke.py"))
    cs_here = importlib.util.module_from_spec(here)
    here.loader.exec_module(cs_here)
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import dataclasses

    import torch

    import chip_smoke as cs
    from sift_features_tpu_torch.config import DEFAULT_CONFIG as cfg
    from sift_features_tpu_torch.models import extractor
    from sift_features_tpu_torch.ops.kernels import build
    from sift_features_tpu_torch.ops.matcher import match_dense

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [f"{src}: {ln.strip()}" for src, log in logs.items()
             for ln in log.splitlines()
             if src in ("pyramid", "descriptor", "refine", "orientation") and (
                 "registers" in ln or "spill" in ln or "Compiling entry" in ln)]
    frames = cs.make_frames(cs.B)
    cap = cs.capture_octave0(torch, extractor, frames, dev)
    rows = cs.check_kernels(torch, cap, cfg, dev)
    refine_dev = cs_here.refine_device_ms(torch, cap, cfg)
    cfgs = {m: dataclasses.replace(cfg, **f) for m, (f, _, _) in cs.STORAGE.items()}
    cap16 = cs_here.capture_first_calls(
        torch, {"K5": (cs_here.EXTRACTOR, "orientation_hist_peaks")},
        lambda: extractor.extract_batch(frames, cfgs["bfloat16"], device=dev))
    window_dev = {**cs_here.window_device_ms(torch, cap["K5"][0], cfg),
                  **cs_here.window_device_ms(torch, cap16["K5"][0], cfg)}
    del cap, cap16
    torch.cuda.empty_cache()
    cs.check_storage_kernels(torch, extractor, frames, cfgs, cfg, dev, rows)
    torch.cuda.empty_cache()

    def step(c=cfg):
        return cs.main_path_step(torch, extractor.extract_batch, match_dense,
                                 frames, c, dev)

    # device time of each main-path wrapper inside one main step
    step()
    torch.cuda.synchronize()
    events = {}
    saved = {a: getattr(extractor, a) for a in cs.WRAPPERS.values()}
    for k, attr in cs.WRAPPERS.items():
        def timed(*a, _k=k, _fn=saved[attr], **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = _fn(*a, **kw)
            e1.record()
            events.setdefault(_k, []).append((e0, e1))
            return out
        setattr(extractor, attr, timed)
    try:
        step()
        torch.cuda.synchronize()
    finally:
        for attr, fn in saved.items():
            setattr(extractor, attr, fn)
    in_step = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()}
    _, d, _ = step()
    n = d.shape[0]
    match_ms = cs.time_ms(torch, lambda: [match_dense(d[(i + 1) % n], d[i])
                                          for i in range(n)], 20, 3)
    match_device_ms = cs_here.device_ms(
        torch, lambda: [match_dense(d[(i + 1) % n], d[i]) for i in range(n)])
    step_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    stage_peaks = {"f32": cs.stage_peaks(torch, extractor, step)}
    for mode, c in cfgs.items():
        stage_peaks[mode] = cs.stage_peaks(torch, extractor, lambda c=c: step(c))
    cap = cs.capture_octave0(torch, extractor, frames, dev)
    alone = cs_here.kernel_alone_ms(torch, cap, cfg)
    del cap
    in_steps = step_kernels(torch, cs_here, [
        lambda: step(dataclasses.replace(cfg, window_kernel="perkey")),
        lambda: step(cfgs["bfloat16"])])
    return {"tree": tree, "card": cs.nvidia_smi_line(),
            "device": torch.cuda.get_device_name(0), "build_s": build_s,
            "ptxas": ptxas, "rows": rows, "refine_device_ms": refine_dev,
            "window_device_ms": window_dev, "kernel_alone_ms": alone,
            "kernels_in_steps": in_steps,
            "kernel_ms_in_step": in_step,
            "launches_in_step": {k: len(v) for k, v in events.items()},
            "match_ms": match_ms, "match_device_ms": match_device_ms,
            "step_ms": step_ms,
            "stage_peak_gb": stage_peaks}


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1]), ensure_ascii=False), flush=True)
        return 0
    out_path = None
    if argv[:1] == ["--out"]:
        out_path, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for i, tree in enumerate(argv):
        print(f"[kernel_ab] run {i}: {tree}", flush=True)
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                           capture_output=True, text=True, timeout=1500)
        out = p.stdout.strip().splitlines()
        for ln in out[:-1]:
            print(f"[run {i}] {ln}", flush=True)
        if p.returncode != 0:
            print(p.stderr[-6000:], file=sys.stderr)
            raise SystemExit(f"kernel_ab: run {i} ({tree}) failed")
        runs.append(json.loads(out[-1]))
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(runs, f, ensure_ascii=False, indent=1)
    names = [k for k in runs[-1]["rows"]]
    print(f"[kernel_ab] {runs[0]['card']}; ms per launch at octave 0, runs "
          f"{' / '.join(os.path.relpath(r['tree']) for r in runs)}")
    for k in names:
        ms = " / ".join(f"{r['rows'][k]['ms']:.4f}" if k in r["rows"] else "-"
                        for r in runs)
        bd = " / ".join(f"{r['rows'][k]['bound_ms']:.4f} ({r['rows'][k]['bound_by']})"
                        if k in r["rows"] else "-" for r in runs)
        print(f"[kernel_ab] {k:9s} {ms}  bound {bd}")
    for k in runs[-1]["refine_device_ms"]:
        ms = " / ".join(f"{v:.4f}" if isinstance(v, float) else str(v) for v in
                        (r["refine_device_ms"][k] for r in runs))
        print(f"[kernel_ab] {k:9s} device ms per launch {ms}")
    for k in runs[-1]["window_device_ms"]:
        ms = " / ".join(f"{v:.4f}" if isinstance(v, float) else str(v) for v in
                        (r["window_device_ms"][k] for r in runs))
        what = "its 3 bucket launches" if k.startswith("K8") else "one launch"
        print(f"[kernel_ab] {k:9s} device ms, {what} on the octave-0 lanes: {ms}")
    for k in runs[-1]["kernel_alone_ms"]:
        ms = " / ".join("not recorded" if v is None else f"{v:.4f}" for v in
                        (r["kernel_alone_ms"][k] for r in runs))
        print(f"[kernel_ab] {k:9s} kernel alone (profiled) ms per launch {ms}")
    for k in runs[-1]["kernels_in_steps"]:
        ms = " / ".join(f"{r['kernels_in_steps'][k]['ms']:.4f} ms in "
                        f"{r['kernels_in_steps'][k]['launches']}" for r in runs)
        print(f"[kernel_ab] {k:9s} device ms in one step (perkey for K8, bf16 "
              f"for K4:bf16), launches: {ms}")
    for k in runs[-1]["kernel_ms_in_step"]:
        ms = " / ".join(f"{r['kernel_ms_in_step'].get(k, 0):.3f}" for r in runs)
        print(f"[kernel_ab] in one main step: {k} {ms} ms")
    print("[kernel_ab] match_ms: " + " / ".join(
        f"{r['match_ms']:.4f}" for r in runs))
    print("[kernel_ab] match device ms (the B matches replayed from a CUDA "
          "graph): " + " / ".join(f"{r['match_device_ms']:.4f}" for r in runs))
    print("[kernel_ab] main step median ms: " + " / ".join(
        f"{statistics.median(r['step_ms']):.1f}" for r in runs))
    for r in runs:
        print(f"[kernel_ab] {os.path.relpath(r['tree'])}: K1-stage peak GB "
              f"{ {m: round(v['octave_fused'], 3) for m, v in r['stage_peak_gb'].items()} }")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
