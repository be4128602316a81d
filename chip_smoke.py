#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases (any failure stops the script with a non-zero exit):
  1. device: name, count, nvidia-smi name and power limit;
  2. build: every CUDA source of sift_features_tpu_torch/csrc with nvcc, one
     process per source, all at once; ptxas register and spill lines;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the inputs the main path gives it at octave 0 of a 1080p B=4 batch
     (captured from a run of the entry point), two launches compared byte
     for byte, per-launch time, plain-version time, the bound and, where one
     PyTorch call computes the same function, that call's time;
  4. main path: extract_batch on the B=4 1080p batch, then per-frame top-1024
     by response and cross-check matching of frame i against frame i+1 (the
     step bench.py times), with launch counts reset just before and read
     just after; kps/frame, the capacity overflow audit, median step time,
     peak memory, per-kernel time inside the step, a profile of one step;
  5. card against CPU on one small seeded image;
  6. refine_mode="step" (K4) against the default walk (K3) on that image;
  7. one JSON line per run with every kernel's numbers.
The last line is {"ok": true, "device": {...}}.

It needs one CUDA card and nvcc; without a card it exits with code 2 and
prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

B, H, W = 4, 1080, 1920
N_MATCH = 1024
SMALL = (240, 320)
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # f32 outside the tensor cores
# the extractor's names of the kernel wrappers of the main path
WRAPPERS = {"K1": "octave_fused", "K2": "extrema_words", "K3": "refine_walk",
            "K5": "orientation_hist_peaks", "K6": "descriptor_hist"}


def make_frames(b: int, h: int = H, w: int = W) -> np.ndarray:
    """bench.py's frame recipe without the reference images: a seeded
    600 x 800 texture tiled to (h, w), frame i rolled by 7 i columns."""
    rng = np.random.RandomState(0)
    base = (rng.rand(600, 800) * 255).astype(np.uint8)
    tiled = np.tile(base, (-(-h // 600), -(-w // 800)))[:h, :w]
    return np.stack([np.roll(tiled, 7 * i, axis=1) for i in range(b)])


def small_image(torch):
    """A seeded smooth (H, W) u8 image: blurred noise."""
    from sift_features_tpu_torch.ops.gaussian import gaussian_blur

    rng = np.random.RandomState(1)
    x = gaussian_blur(torch.from_numpy(rng.rand(*SMALL).astype(np.float32)), 2.0)
    x = (x - x.min()) / (x.max() - x.min())
    return (x * 255).to(torch.uint8).numpy()


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture_octave0(torch, extractor, frames, dev):
    """Run extract_batch once with every kernel wrapper wrapped, keeping the
    arguments of each wrapper's first call (octave 0)."""
    captured, saved = {}, {}
    for k, attr in WRAPPERS.items():
        fn = getattr(extractor, attr)
        saved[attr] = fn

        def rec(*args, _k=k, _fn=fn, **kw):
            captured.setdefault(_k, (args, kw))
            return _fn(*args, **kw)
        setattr(extractor, attr, rec)
    try:
        extractor.extract_batch(frames, device=dev)
        torch.cuda.synchronize()
    finally:
        for attr, fn in saved.items():
            setattr(extractor, attr, fn)
    return captured


def refine_steps_active(torch, args, cfg):
    """Active lanes at each Newton step of this run's candidates (what K3
    must read), from the plain loop on the card."""
    from sift_features_tpu_torch.ops.extrema import newton_step, refine_loop

    dog_flat = args[0]
    counts = []

    def step(p, y, x, active):
        counts.append(int(active.sum()))
        return newton_step(dog_flat, p, y, x, active, cfg)
    refine_loop(step, *args[1:8], cfg, plane_off=args[-1])
    return counts


def window_samples(torch, scale, live, factor, r_max):
    """(live lanes, window pixels read, in-radius samples) of a window
    kernel for this run's keypoints."""
    from sift_features_tpu_torch.ops.util import round_half_away

    r = torch.clamp(round_half_away(scale * factor), 0, r_max)[live.bool()]
    return (int(live.sum()), float(((2 * r + 3) ** 2).sum()),
            float(((2 * r + 1) ** 2).sum()))


def bound(nbytes: float, ops: float):
    t_b = nbytes / H100_BYTES_PER_S * 1e3
    t_o = ops / H100_F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check_kernels(torch, cap, cfg, dev):
    """Phase 3: every kernel against its plain version at octave 0."""
    from sift_features_tpu_torch.ops.extrema import newton_step, refine
    from sift_features_tpu_torch.ops.kernels import (
        descriptor as k6, extrema as k2, orientation as k5, pyramid as k1,
        refine as k34)

    rows = {}

    def record(name, out_k, out_k2, out_p, exact, tol, ms, plain_ms, nbytes,
               ops, library_ms=None, note=""):
        outs = [(a.float(), b.float(), c.float()) for a, b, c in
                zip(out_k, out_k2, out_p)]
        same = all(torch.equal(a, b) for a, b, _ in outs)
        err = max(float((a - c).abs().max()) if a.numel() else 0.0
                  for a, _, c in outs)
        ok = same and (all(torch.equal(a, c) for a, _, c in outs) if exact
                       else err <= tol)
        b_ms, b_by = bound(nbytes, ops)
        print(f"[kernel] {name}: {'bit-exact' if exact else f'tol {tol:g}'} "
              f"vs plain -> max_abs_err {err:.3g}, run-to-run identical {same}; "
              f"{ms:.4f} ms/launch, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by}){note}", flush=True)
        if not ok:
            raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library_ms}

    # K1: octave 0 blur chain + DoG
    (base, _), _ = cap["K1"]
    outs = [k1.octave_fused(base, cfg) for _ in range(2)]
    plain = k1.octave_fused_plain(base, cfg)
    nb, hp, wp = base.shape
    taps = k1.octave_taps(cfg)
    px = nb * hp * wp
    k1_bytes = 4 * px * (1 + cfg.scales_per_octave + len(taps))
    k1_ops = px * (sum(4 * len(t) for t in taps) + len(taps))
    ms = time_ms(torch, lambda: k1.octave_fused(base, cfg), 10)
    plain_ms = time_ms(torch, lambda: k1.octave_fused_plain(base, cfg), 2)
    # yardstick: one cuDNN convolution giving all Gaussian levels from the
    # base, each level's taps composed into one 2D kernel (f32, TF32 off)
    comp, kern = np.ones(1), []
    for t in taps:
        comp = np.convolve(comp, t.astype(np.float64))
        kern.append(comp)
    r = len(kern[-1]) // 2
    wgt = np.zeros((len(kern), 1, 2 * r + 1, 2 * r + 1), np.float32)
    for i, c in enumerate(kern):
        o = r - len(c) // 2
        wgt[i, 0, o:o + len(c), o:o + len(c)] = np.outer(c, c)
    wgt[wgt < 1e-20] = 0.0     # keep products clear of subnormals
    wgt = torch.from_numpy(wgt).to(dev)
    torch.backends.cudnn.allow_tf32 = False
    conv = torch.nn.functional.conv2d
    lib_ms = time_ms(torch, lambda: conv(base[:, None], wgt, padding=r), 3)
    record("K1", [outs[0][0], outs[0][1]], [outs[1][0], outs[1][1]],
           [plain[0], plain[1]], True, 0.0, ms, plain_ms, k1_bytes, k1_ops,
           lib_ms, f"; library conv2d {lib_ms:.3f} ms")
    del outs, plain

    # K2: extremum words
    (dog, bounds, _), _ = cap["K2"]
    outs = [k2.extrema_words(dog, bounds, cfg) for _ in range(2)]
    plain = k2.extrema_words_plain(dog, bounds, cfg)
    ms = time_ms(torch, lambda: k2.extrema_words(dog, bounds, cfg), 10)
    plain_ms = time_ms(torch, lambda: k2.extrema_words_plain(dog, bounds, cfg), 2)
    record("K2", [outs[0]], [outs[1]], [plain], True, 0.0, ms, plain_ms,
           dog.numel() * 4 + outs[0].numel() * 4, dog.numel() // 5 * 3 * 27)
    del outs, plain

    # K3: the whole Newton walk, and K4 (one step) at the same candidates
    args, kw = cap["K3"]
    dog_flat, s0, y0, x0, valid = args[:5]
    poff = kw["plane_off"]
    full = (*args[:9], poff)
    outs = [k34.refine_walk(*args, **kw) for _ in range(2)]
    plain = refine(*args, **kw)
    active = refine_steps_active(torch, full, cfg)
    k = s0.numel()
    k3_bytes = k * (5 * 4 + 16 * 4) + 27 * 4 * sum(active)
    ms = time_ms(torch, lambda: k34.refine_walk(*args, **kw), 10)
    plain_ms = time_ms(torch, lambda: refine(*args, **kw), 2)
    record("K3", [outs[0]], [outs[1]], [plain], True, 0.0, ms, plain_ms,
           k3_bytes, 150 * sum(active),
           note=f"; active lanes per step {active} of {k}")
    p = torch.clamp(s0, 1, cfg.scales_per_octave) + poff
    k4_args = (dog_flat, p, y0, x0, valid, cfg)
    outs = [k34.refine_step(*k4_args) for _ in range(2)]
    plain = newton_step(*k4_args)
    ms = time_ms(torch, lambda: k34.refine_step(*k4_args), 10)
    plain_ms = time_ms(torch, lambda: newton_step(*k4_args), 2)
    record("K4", [outs[0]], [outs[1]], [plain], True, 0.0, ms, plain_ms,
           k * (4 * 4 + 16 * 4) + 27 * 4 * active[0], 150 * active[0],
           note=" (first step of the same candidates)")
    del outs, plain

    # K5: orientation histograms + peaks. The plain version sums in the
    # kernel's order; the tolerance covers the f64 exp of two libraries
    args, kw = cap["K5"]
    outs = [k5.orientation_hist_peaks(*args, **kw) for _ in range(2)]
    plain = k5.orientation_plain(*args, **kw)
    scale, live = args[4], args[5]
    n_live, px, smp = window_samples(torch, scale, live,
                                     3.0 * cfg.lambda_ori, 16)
    ms = time_ms(torch, lambda: k5.orientation_hist_peaks(*args, **kw), 10)
    plain_ms = time_ms(torch, lambda: k5.orientation_plain(*args, **kw), 1, 0)
    record("K5", outs[0], outs[1], plain, False, 1e-4, ms, plain_ms,
           4 * px + live.numel() * (5 * 4 + 41 * 4), 60 * smp,
           note=f"; {n_live} live of {live.numel()} lanes")
    del outs, plain

    # K6: descriptor histograms, same summation-order rule as K5
    args, kw = cap["K6"]
    outs = [k6.descriptor_hist(*args, **kw) for _ in range(2)]
    plain = k6.descriptor_plain(*args, **kw)
    scale, live = args[4], args[6]
    radius_factor = cfg.lambda_descr * np.sqrt(2.0) * (cfg.descriptor_n_histograms + 1) / 2
    n_live, px, smp = window_samples(torch, scale, live, radius_factor, 39)
    ms = time_ms(torch, lambda: k6.descriptor_hist(*args, **kw), 5)
    plain_ms = time_ms(torch, lambda: k6.descriptor_plain(*args, **kw), 1, 0)
    record("K6", [outs[0]], [outs[1]], [plain], False, 1e-4, ms, plain_ms,
           4 * px + live.numel() * (6 * 4 + 128 * 4), 100 * smp,
           note=f"; {n_live} live of {live.numel()} lanes")
    return rows


def main_path_step(torch, extract_batch, match_dense, frames, cfg, dev):
    """One step of the bench: extract, per-frame top-1024 by response,
    cross-check matching of frame i (queries) against frame i+1 (train)."""
    res = extract_batch(frames, cfg, device=dev)
    resp = torch.where(res["valid"], res["kps"][..., 4],
                       torch.tensor(float("-inf"), device=dev))
    top = torch.topk(resp, N_MATCH, dim=1).indices
    desc = torch.gather(res["desc"], 1, top[..., None].expand(-1, -1, 128))
    d = desc.float()
    matches = [match_dense(d[(i + 1) % d.shape[0]], d[i])
               for i in range(d.shape[0])]
    return res, d, matches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from sift_features_tpu_torch.config import DEFAULT_CONFIG
    from sift_features_tpu_torch.models import extractor
    from sift_features_tpu_torch.ops.kernels import KERNELS, build
    from sift_features_tpu_torch.ops.matcher import match_dense

    cfg = DEFAULT_CONFIG
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. device
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"[device] {name} x{count}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[build] {len(logs)} sources compiled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {src}: {line.strip()}")

    # 3. kernels against their plain versions at octave 0 of the main path
    frames = make_frames(B)
    cap = capture_octave0(torch, extractor, frames, dev)
    rows = check_kernels(torch, cap, cfg, dev)
    del cap
    torch.cuda.empty_cache()

    # 4. main path
    main_path_step(torch, extractor.extract_batch, match_dense, frames, cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    res, d, matches = main_path_step(torch, extractor.extract_batch,
                                     match_dense, frames, cfg, dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for k in WRAPPERS:
        if not launches.get(k):
            raise SystemExit(f"chip_smoke: {k} was not launched on the main path")
    if launches.get("K4"):
        raise SystemExit("chip_smoke: K4 launched in walk mode (K3 never escapes)")

    kps_frame = res["valid"].sum(1).tolist()
    if not all(np.isfinite(res["kps"][res["valid"]].cpu().numpy()).all(1)):
        raise SystemExit("chip_smoke: non-finite keypoints")
    n_kept = [int(m[2].sum()) for m in matches]
    if min(kps_frame) < N_MATCH or min(n_kept) < 1:
        raise SystemExit(f"chip_smoke: too few keypoints {kps_frame} or "
                         f"matches {n_kept}")
    hh, ww = H * cfg.inv_delta_min, W * cfg.inv_delta_min
    overflow = []
    for o in range(res["n_candidates"].shape[1]):
        caps = extractor.octave_capacities(hh, ww, cfg)
        got = [int(res[c][:, o].max()) for c in
               ("n_candidates", "n_survivors", "n_emitted")]
        print(f"[audit] octave {o} ({hh}x{ww}): candidates/survivors/emitted "
              f"max {got} of capacity {list(caps)}")
        overflow += [f"oct{o}:{c} {v}>{cap}" for c, v, cap in
                     zip(("candidates", "survivors", "emitted"), got, caps)
                     if v > cap]
        hh, ww = hh // 2, ww // 2

    # per-kernel device time inside one step: CUDA events around each call
    events = {}
    saved = {a: getattr(extractor, a) for a in WRAPPERS.values()}
    for k, attr in WRAPPERS.items():
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
        main_path_step(torch, extractor.extract_batch, match_dense, frames,
                       cfg, dev)
        torch.cuda.synchronize()
    finally:
        for attr, fn in saved.items():
            setattr(extractor, attr, fn)
    in_step = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()}

    step_s = []
    for _ in range(10):
        t0 = time.perf_counter()
        main_path_step(torch, extractor.extract_batch, match_dense, frames,
                       cfg, dev)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    step_med = statistics.median(step_s)
    # device time over one step by kernel and by operator (torch.profiler,
    # CUPTI), after the timed steps so its overhead touches none of them
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        main_path_step(torch, extractor.extract_batch, match_dense, frames,
                       cfg, dev)
        torch.cuda.synchronize()
    kern, ops = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        tot_us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            kern.append((dev_us / 1e3, e.count, e.key))
        elif e.device_type == DeviceType.CPU and tot_us > 0:
            ops.append((tot_us / 1e3, e.count, e.key))
    kern.sort(reverse=True)
    ops.sort(reverse=True)
    busy_ms = sum(t for t, _, _ in kern)
    print(f"[profile] one step: {busy_ms:.1f} ms of device kernels "
          f"({busy_ms / (step_med * 1e3):.1%} of the median step)")
    for t, n, key in kern[:15]:
        print(f"[profile] kernel {t:9.3f} ms {n:6d}x  {key[:80]}")
    for t, n, key in ops[:15]:
        print(f"[profile] op     {t:9.3f} ms {n:6d}x  {key[:80]}")

    dt = torch.roll(d, -1, 0)
    match_ms = time_ms(torch, lambda: [match_dense(d[(i + 1) % B], d[i])
                                       for i in range(B)], 5)
    cdist_ms = time_ms(torch, lambda: torch.cdist(d, dt), 5)
    print(json.dumps({
        "e2e": "1080p extract + match, B=4", "card": smi,
        "kps_per_frame": kps_frame, "matches_kept": n_kept,
        "median_step_ms": step_med * 1e3, "step_ms": [s * 1e3 for s in step_s],
        "frames_per_s": B / step_med, "first_counted_step_ms": first_s * 1e3,
        "peak_mem_gb": peak_gb, "launches": launches,
        "kernel_ms_in_step": in_step,
        "kernel_ms_per_launch_in_step": {k: v / launches[k] for k, v in in_step.items()},
        "profiled_step_kernel_ms": busy_ms, "match_ms": match_ms,
        "match_library_cdist_ms": cdist_ms, "capacity_overflow": overflow}),
        flush=True)

    # 5. card against CPU on a small image
    img = small_image(torch)[None]
    rc = extractor.extract_batch(img, cfg, device=dev)
    rh = extractor.extract_batch(img, cfg, device="cpu")
    for key in ("n_candidates", "n_survivors", "n_emitted", "valid"):
        if not torch.equal(rc[key].cpu(), rh[key]):
            raise SystemExit(f"chip_smoke: card and CPU differ in {key}")
    v = rh["valid"]
    kp_err = float((rc["kps"].cpu()[v] - rh["kps"][v]).abs().max())
    rows_eq = float((rc["desc"].cpu()[v] == rh["desc"][v]).all(1).float().mean())
    print(f"[card-vs-cpu] {SMALL[0]}x{SMALL[1]}: {int(v.sum())} keypoints, "
          f"identical sets, max field diff {kp_err:.3g}, descriptor rows "
          f"byte-equal {rows_eq:.4f}", flush=True)
    if int(v.sum()) < 50 or kp_err > 1e-3 or rows_eq < 0.99:
        raise SystemExit("chip_smoke: card and CPU disagree")

    # 6. refine_mode="step" (K4) against the default walk
    import dataclasses

    build.reset_launches()
    rs = extractor.extract_batch(img, dataclasses.replace(cfg, refine_mode="step"),
                                 device=dev)
    torch.cuda.synchronize()
    step_launches = dict(build.LAUNCHES)
    if not step_launches.get("K4"):
        raise SystemExit("chip_smoke: K4 was not launched in step mode")
    for key in ("valid", "kps", "desc", "n_emitted"):
        if not torch.equal(rs[key], rc[key]):
            raise SystemExit(f"chip_smoke: step and walk modes differ in {key}")
    print(f"[step-mode] K4 launches {step_launches['K4']}: keypoints and "
          f"descriptors identical to walk mode", flush=True)

    # 7. the kernels line
    kernels = []
    for k, (src, replaces) in KERNELS.items():
        n = step_launches.get(k, 0) if k == "K4" else launches.get(k, 0)
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": n,
                        "launches_path": ("refine_mode=step, 240x320"
                                          if k == "K4" else "main path"),
                        **rows[k]})
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
