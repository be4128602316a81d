#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases (any failure stops the script with a non-zero exit):
  1. device: name, count, nvidia-smi name and power limit;
  2. build: every CUDA source of sift_features_tpu_torch/csrc with nvcc, one
     process per source, all at once (the extractor's five and the
     matcher's); ptxas register and spill lines;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the inputs the main path gives it at octave 0 of a 1080p B=4 batch
     (captured from a run of the entry point), two launches compared byte
     for byte, per-launch time, plain-version time, the bound and, where one
     PyTorch call computes the same function, that call's time; K1 and K2
     are held bit-exact at every fused octave (their tiles' and strips'
     edge cases differ by shape), timed at octave 0; a measurement probe
     is printed, not gated: a streaming read of the DoG values K2 needs
     (probes/k2_stream.cu; the rate its access pattern can reach);
     K2', K5', K6' and K9 are held the same way at the octave-0 inputs of
     the per-frame path (_extract_single on frame 0), K9 at every octave
     that path builds with it; K10 and K11 at K3's
     candidates (K10 also against K4's rows, K11's merged rows against
     K3's), K8 and K7 on K5's and K6's lanes, one launch per scale bucket
     (K8 bit-exact, also against K5's and K6's raw rows). The refine
     kernels K3, K4, K4:bf16 (on a bf16 copy of the DoG), K10 and K11 and
     the window kernels K5 and K8 (its three bucket launches on K5's
     lanes) also print their device time (device_ms: the wrapper's calls
     captured in a CUDA graph, one replay timed), which below ~0.1 ms the
     events around the wrapper cannot give; K3 also prints a probe line,
     not gated: its time with every lane dead and with the walk cut to one
     and to two Newton steps;
  4. main path: extract_batch on the B=4 1080p batch, then per-frame top-1024
     by response and cross-check matching of frame i against frame i+1 (the
     step bench.py times), with launch counts reset just before and read
     just after; kps/frame, the capacity overflow audit, median step time,
     peak memory, per-kernel time inside the step, a profile of one step
     (with every port kernel's device time), the matcher's time;
  5. budget: the same batch with features_limit=2048 (bench.py's step_b:
     match the first 1024 rows), launches (K6' and never K6), median step,
     peak memory; the output byte-identical to _truncate_result of the
     unbudgeted output;
  6. per-frame: _extract_single on frame 0 (K9, K2', K3, K5', K6') against
     extract_batch's row for that frame;
  7. split: precompute + extract_with_precomputed on frame 0 against
     extract_batch's row, kps within 1e-4 and descriptor bytes within 1;
  8. card against CPU on one small seeded image; the port's NumPy oracle
     (oracle.sift, NumpyProcessing) against sift on the card at
     tests/test_fuzz.py's bar on that test's four image shapes, with both
     times, and octave by octave on the small image, whose octave 1 (and
     no other) must overflow the extractor's capacities: there the card's
     rows are held against the oracle's first rows;
  9. refine_mode="step" (K4) against the default walk (K3) on that image;
  10. modes: the main step with refine_mode="region" (K10 then K4), "tile"
      (K11, escapes re-refined by K4) and window_kernel="perkey" (K8, K7),
      each byte-identical to the default step's output, launching its
      kernels and not the ones they replace; the median of 5 steps each
      against 5 default steps interleaved with them, a profile of one step,
      the tile walks that escaped; then the budget step once with perkey,
      byte-identical to the default budget output;
  11. storage: storage_dtype "bfloat16" and "split" and gather_dtype
      "bfloat16". Each new kernel form against its plain version at the
      octave-0 inputs of its path (K1 and K2 forms at every fused octave; K1, K9,
      K2, K4 and K8 forms bit-exact, K4:bf16 also against K10 on the
      widened DoG, K8:bf16 at every call of the bf16 perkey step and
      against K5:bf16 on the bf16 step's lanes, with both device times;
      the other window kernels on bf16 levels
      within 1e-4); the split and gather16 K1
      against the f32 K1 bit for bit. Each mode's main step: its K1 form
      launched (bf16: K4 and not K3), split and gather16 with the f32 step's
      candidate and survivor counts and detection sets, bf16 with the share
      of f32 keypoints it finds by position; the median of 5 steps against 5
      default steps interleaved with them, peak memory, a profile of one
      step; bf16 with perkey
      (K8, K7 on bf16) equal to the bf16 step; the gather16 budget (K6′ on
      bf16) equal to the truncated gather16 output; card against CPU on the
      small image in each mode;
  12. service: the descriptor-database service (service.DescriptorIndex)
      at 256 1080p frames, each its own seeded texture, added by 64
      add_frames calls at B=4 (the main path's kernels launched); a new
      frame's query against all ~2.2M rows (median of 3, distances/s, peak
      memory, not gated; the same on the int8 path, gated equal); gated:
      the self-queries of frames 0 (through
      query_image, whose keypoints and descriptors equal extract's), 127
      and 255 match only rows of their frame at distance 0, the chunked
      matcher equals its one-chunk form on the first 8 frames, save / load
      round-trips byte-equal; then M1, the matcher kernel, against the
      chunk loop on u8 rows at the new frame's query against the index and
      at 8,192 query rows (the index cell's) against the index's rows and
      as many seeded rows again: gated, best_train, distance and keep
      bit-equal with and without the cross-check and one M1 launch per
      match_dense call (launch counts reset just before); not gated, M1's
      time, the loop's, its bound (f64 tensor operations at 66.9 TFLOP/s)
      and the f64 GEMM alone over the same rows;
  13. stream: the I/O tier and the streaming executor. 62 1080p frames
      (the service phase's textures; 62 is not a multiple of B=4) written
      as JPEGs (quality 92) by the native encoder; gated: the native decode
      pool's frames byte-equal to decode_gray's, and stream_extract_paths
      (depth 2, compact) byte-identical frame for frame to extract_batch
      on the decoded batches, with and without features_limit=2048,
      launching the main path's kernels (K6′ and not K6 with the limit);
      not gated, interleaved twice: frames/s of the decode pool alone, the
      stream, an extract_batch loop over the decoded frames and a serial
      decode -> extract loop; one instrumented stream run: the share of its
      window the card spends inside a batch's work (CUDA events around
      each extract_batch call), host time in extract_batch and in the
      readback waits, peak device memory. Without libjpeg's header (an
      explicit g++ check) it prints "[stream] native tier not built" and
      streams the frames from memory through four rotating pinned buffers
      (the pool's contract) instead; either way with the default
      compact=True;
  14. dist: the distributed path (parallel/). (a) One rank on a NCCL
      group (runner.init_distributed on a free localhost port):
      extract_match_step on the B=4 1080p batch with 128 queries a frame,
      then with features_limit=2048, gated byte-equal to extract_batch
      (budgeted likewise) and its matches to the tagged dense reference
      (ring.match_tagged_dense on the card), launching the main path's
      kernels (K6′ and not K6 with the limit); not gated: the median of 10
      steps interleaved with 10 extract_batch steps, peak memory. (b) Two
      ranks on the one card over gloo (spawned processes, both on cuda:0,
      the hops staged through pinned host memory): gated, ring_match of a
      new frame's ~8.7k rows against the four frames' ~35k equal to
      match_brute_force, and extract_match_step equal to (a)'s; not
      gated, their wall times and bytes per hop. (c) SIFT_INT8_MATCH=1:
      gated, the main step's matching of u8 rows equal to the f64 path's;
      not gated, both times, and phase 12's 2.2M-row query (int8 against
      f64, with its peaks, run in phase 12). (d) The same two ranks as a
      data=1 x space=2 mesh: extract_match_step of the four frames on the
      spatial path (octaves 0-2 row-sharded, halo-exchange blurs,
      detection by row band), without and with features_limit=2048;
      gated: per frame the keypoint set and the counters byte-equal to
      the split path's on the card (precompute + extract_with_precomputed:
      the same reflect-101 blur chain), the keypoint count equal to (a)'s,
      the budget holding the unbudgeted step's top-2048 with its rows'
      bytes, the matches equal to the tagged dense reference, K2′ never
      launched and K3, K5′ and K6′ at least once per sharded octave and
      frame; not gated, first and warm step times, halo hops and bytes per
      hop, bytes gathered over space, the largest gather's time, peak
      memory per rank;
  15. K5's probe lines, not gated: K5 with every lane dead and with its
      per-sample math replaced by constants (probes/: a copy of its
      kernel), by CUDA events around the wrapper and by device time (the
      calls replayed from a CUDA graph);
  16. one JSON line with every kernel's numbers.
The last line is {"ok": true, "device": {...}}.

It needs one CUDA card and nvcc; without a card it exits with code 2 and
prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

B, H, W = 4, 1080, 1920
N_MATCH = 1024
BUDGET = 2048
SMALL = (240, 320)
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
# f32 instructions per second outside the tensor cores: the data sheet's
# 67 TFLOP/s counts an FMA as two operations, and every kernel is built with
# --fmad=false, so each f32 multiply or add takes a whole FMA issue slot.
# The operation counts below are such instructions.
H100_F32_INSTR_PER_S = 33.5e12
# f64 operations per second on the tensor cores (H100 SXM data sheet), what
# M1's bounds count: 2 x 128 a distance for the pairs' work, half of that
# for the products M1 runs (two query rows to an operand)
H100_F64_TENSOR_PER_S = 66.9e12
# query rows of the index cell's query (h100_bench), M1's second shape
M1_QUERY_ROWS = 8192
# the values of a candidate's 3 x 3 x 3 cube that a Newton step reads: the
# centre, the 6 faces and the 12 edges (ops/extrema.py:newton_from_cubes;
# the 8 corners are unused), what a refine kernel's bound counts a step
CUBE_VALUES = 19
# the extractor's names of the kernel wrappers of the main path
WRAPPERS = {"K1": "octave_fused", "K2": "extrema_words", "K3": "refine_walk",
            "K5": "orientation_hist_peaks", "K6": "descriptor_hist"}
# kernel -> (module, wrapper name) of the per-frame path's kernels; the
# window kernels are reached through their bucketed dispatchers
SINGLE_WRAPPERS = {
    "K9": ("sift_features_tpu_torch.models.extractor", "build_octave_padded"),
    "K2′": ("sift_features_tpu_torch.models.extractor", "extrema_words_single"),
    "K5′": ("sift_features_tpu_torch.ops.kernels.orientation",
            "orientation_hist_prefix"),
    "K6′": ("sift_features_tpu_torch.ops.kernels.descriptor",
            "descriptor_hist_prefix")}


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


def capture_first_calls(torch, wrappers, run, every=()):
    """Run run() once with each wrapper in wrappers {kernel: (module,
    attribute)} wrapped, keeping the arguments of each one's first call
    (octave 0); for the kernels in `every`, also the list of every call's
    arguments (all octaves), under "<kernel>*"."""
    import importlib

    captured, saved = {}, []
    for k, (mod_name, attr) in wrappers.items():
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def rec(*args, _k=k, _fn=fn, **kw):
            captured.setdefault(_k, (args, kw))
            if _k in every:
                captured.setdefault(_k + "*", []).append((args, kw))
            return _fn(*args, **kw)
        setattr(mod, attr, rec)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return captured


def capture_octave0(torch, extractor, frames, dev):
    """The octave-0 arguments of every kernel wrapper: the main path's
    (extract_batch on the batch) and the per-frame path's (_extract_single
    on frame 0)."""
    mod = "sift_features_tpu_torch.models.extractor"
    cap = capture_first_calls(
        torch, {k: (mod, a) for k, a in WRAPPERS.items()},
        lambda: extractor.extract_batch(frames, device=dev), every=("K1", "K2"))
    img = torch.as_tensor(frames[0], device=dev)
    n_oct = extractor._n_octaves(H, W, extractor.DEFAULT_CONFIG)
    cap.update(capture_first_calls(
        torch, SINGLE_WRAPPERS,
        lambda: extractor._extract_single(img, n_oct, extractor.DEFAULT_CONFIG),
        every=("K9",)))
    return cap


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


def window_union_px(torch, plane, y, x, scale, live, factor, r_max, h, w):
    """Plane pixels in the union of the live lanes' (2r+3)^2 windows (y, x
    clamped into the plane, as the window kernels clamp them): what a
    window kernel must read, each pixel once, where windows overlap."""
    from sift_features_tpu_torch.ops.util import round_half_away

    lv = live.bool()
    if not bool(lv.any()):
        return 0
    r = torch.clamp(round_half_away(scale[lv] * factor), 0, r_max).long() + 1
    e = r_max + 1
    hp, wp = h + 2 * e, w + 2 * e
    row0 = (plane[lv].long() * hp + torch.clamp(y[lv].long(), 0, h - 1) + e) * wp \
        + torch.clamp(x[lv].long(), 0, w - 1) + e
    off = torch.arange(-e, e + 1, device=r.device)
    seen = torch.zeros((int(plane[lv].max()) + 1) * hp * wp, dtype=torch.bool,
                       device=r.device)
    for i in range(0, r.numel(), 2048):
        ri = r[i:i + 2048, None, None]
        inside = (off.abs()[None, :, None] <= ri) & (off.abs()[None, None, :] <= ri)
        keys = row0[i:i + 2048, None, None] + off[None, :, None] * wp + off[None, None, :]
        seen[keys[inside]] = True
    return int(seen.sum())


def step_bytes(k: int, n_act: int, cube: int, lane: int) -> int:
    """Bytes that one masked Newton step (K4, K10) needs: every lane's mask
    or index (`lane` bytes: K4's bool mask 1, K10's int32 index 4) and row
    (64 B), and each active lane's position (12 B) and the CUBE_VALUES
    values of its cube that the step reads (`cube` bytes in all)."""
    return k * (lane + 16 * 4) + n_act * (3 * 4 + cube)


def bound(nbytes: float, ops: float):
    t_b = nbytes / H100_BYTES_PER_S * 1e3
    t_o = ops / H100_F32_INSTR_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def composed_kernels(torch, taps, dev):
    """(levels, 1, 2r+1, 2r+1) f32 2-D kernels giving each Gaussian level of
    an octave from its base in one convolution (the library yardstick of
    K1), and r."""
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
    return torch.from_numpy(wgt).to(dev), r


def make_record(torch, rows):
    """record(name, ...): holds a kernel's two launches against each other
    and its plain version, prints its line, and keeps its numbers in
    rows[name]; a disagreement stops the script."""
    def record(name, out_k, out_k2, out_p, exact, tol, ms, plain_ms, nbytes,
               ops, library_ms=None, note="", dev_ms=None):
        outs = list(zip(out_k, out_k2, out_p))
        same = all(torch.equal(a, b) for a, b, _ in outs)
        err = max(float((a.float() - c.float()).abs().max()) if a.numel() else 0.0
                  for a, _, c in outs)
        ok = same and (all(torch.equal(a, c) for a, _, c in outs) if exact
                       else err <= tol)
        b_ms, b_by = bound(nbytes, ops)
        dev = ("" if dev_ms is None else f" (device {dev_ms:.4f})"
               if isinstance(dev_ms, float) else f" (device time: {dev_ms})")
        print(f"[kernel] {name}: {'bit-exact' if exact else f'tol {tol:g}'} "
              f"vs plain -> max_abs_err {err:.3g}, run-to-run identical {same}; "
              f"{ms:.4f} ms/launch{dev}, plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}){note}", flush=True)
        if not ok:
            raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library_ms,
                      "device_ms": dev_ms if isinstance(dev_ms, float) else None}
        if isinstance(dev_ms, str):
            rows[name]["device_ms_note"] = dev_ms
    return record


def k2_work(dog, bounds, n_s: int):
    """(bytes, operations) that K2's function needs on dog (B, S+2, Hp, Wp):
    each DoG value of rows [y0 - 1, y1] and columns [x0 - 1, x1] (clipped
    to the plane) read once, every word written once, and 27 compares for
    each pixel inside the bounds of each scale."""
    b, n_p, hp, wp = dog.shape
    y0, y1, x0, x1 = (int(v) for v in bounds)
    y0, y1, x0, x1 = max(y0, 0), min(y1, hp), max(x0, 0), min(x1, wp)
    rows = max(min(y1 + 1, hp) - max(y0 - 1, 0), 0)
    cols = max(min(x1 + 1, wp) - max(x0 - 1, 0), 0)
    nbytes = b * n_p * rows * cols * dog.element_size() + b * n_s * hp * wp // 32 * 4
    return nbytes, b * n_s * max(y1 - y0, 0) * max(x1 - x0, 0) * 27


def stream_probe_line(torch, k2, dog, bounds, cfg, name, ms, nbytes):
    """Prints (not gated) the time of a kernel that reads once the DoG
    values K2 needs and writes K2's words of those rows, with no stencil
    (probes/k2_stream.cu): what K2's reads cost at the rate its access
    pattern can reach. Both by CUDA events around the wrapper, as the
    kernel lines time, and as device time (device_ms); both rates are over
    K2's byte count, nbytes."""
    import probes

    p_ms = time_ms(torch, lambda: probes.k2_stream(dog, bounds, cfg), 10)
    p_dev = device_ms(torch, lambda: probes.k2_stream(dog, bounds, cfg))
    k_dev = device_ms(torch, lambda: k2.extrema_words(dog, bounds, cfg))
    print(f"[probe] {name} streaming read of the DoG values it needs, ms/launch "
          f"(events / device): {p_ms:.4f} / {p_dev:.4f}, {nbytes / p_dev / 1e9:.3f} "
          f"TB/s; {name} {ms:.4f} / {k_dev:.4f}, {nbytes / k_dev / 1e9:.3f} TB/s, "
          f"{p_dev / k_dev:.1%} of the probe's rate", flush=True)


def device_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time per fn() call, without the host time of its wrapper
    (which CUDA events around back-to-back calls include when the wrapper
    is the slower): reps calls captured in a CUDA graph, one replay timed
    with CUDA events. fn must launch on the current stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def refine_calls(torch, cap, cfg) -> dict:
    """One call of each refine wrapper, K3, K4, K4:bf16, K10 and K11, at
    K3's octave-0 candidates: K3 and K4 with the types their callers give
    them (int32 positions, bool mask: an older checkout's K3 wrapper casts
    the mask on the card, as it did on the main path), K4:bf16 the same on
    a bf16 copy of the DoG, the others with their inputs cast to int32
    first. Uses only wrapper names
    the port has had since the kernels were ported, so kernel_ab.py can
    time an older checkout with it."""
    from sift_features_tpu_torch.ops.kernels import refine as kr

    args, kw = cap["K3"]
    dog_flat, pad, h, w = args[0], *args[5:8]
    s0, y0, x0, valid = (t.int() for t in args[1:5])
    poff = kw["plane_off"].int()
    p = torch.clamp(s0, 1, cfg.scales_per_octave) + poff
    mask = valid.bool()
    dog16 = dog_flat.to(torch.bfloat16)
    g = kr.region_order(p, y0, x0, valid, *dog_flat.shape)
    lay = kr.tile_layout(dog_flat, s0, y0, x0, valid, pad, cfg, poff)
    return {"K3": lambda: kr.refine_walk(dog_flat, s0, y0, x0, mask, pad, h, w,
                                         cfg, plane_off=poff),
            "K4": lambda: kr.refine_step(dog_flat, p, y0, x0, mask, cfg),
            "K4:bf16": lambda: kr.refine_step(dog16, p, y0, x0, mask, cfg),
            "K10": lambda: kr.region_step(dog_flat, g, cfg),
            "K11": lambda: kr.refine_tile_slots(dog_flat, lay, pad, h, w, cfg)}


def graph_device_ms(torch, calls: dict) -> dict:
    """device_ms of each call; a call that cannot be captured in a CUDA
    graph gets the reason instead of a number."""
    out = {}
    for k, fn in calls.items():
        try:
            out[k] = device_ms(torch, fn)
        except RuntimeError as e:
            out[k] = f"not capturable in a CUDA graph ({str(e).splitlines()[0]})"
    return out


def refine_device_ms(torch, cap, cfg) -> dict:
    """Device time (device_ms) per call of the refine wrappers of
    `refine_calls`. This tree's wrappers launch their kernel alone on those
    inputs; an older checkout's may also cast or zero-fill on the card, and
    then its time includes those kernels (`kernel_alone_ms` separates
    them)."""
    return graph_device_ms(torch, refine_calls(torch, cap, cfg))


def bucket_lanes(plane, live, n_win, radii):
    """The perkey dispatch's per-bucket compaction of window-kernel lanes:
    for each scale bucket (level plane % n_win + 1) its lane indices as a
    count prefix, the count (a device tensor) and the bucket's r_max."""
    from sift_features_tpu_torch.utils.compact import compact_indices

    level = plane % n_win + 1
    out = []
    for si, r_max in radii.items():
        maskb = live.bool() & (level == si)
        idx, _, n = compact_indices(maskb, maskb.numel())
        out.append((idx, n, r_max))
    return out


def k8_runs(torch, args, cfg):
    """K8's launches on K5's lanes (args: orientation_hist_peaks's
    positional arguments), one
    per scale bucket as the perkey dispatcher makes them: [(K8's
    arguments, the bucket's live prefix as a bool mask, its lane indices
    into K5's lanes)]."""
    from sift_features_tpu_torch.ops.kernels import orientation as k5

    gflat, plane, y, x, scale, live, h, w, pad = args[:9]
    runs = []
    for idx, n, r_max in bucket_lanes(plane, live, cfg.scales_per_octave,
                                      k5.bucket_radii_ori(cfg)):
        a = (gflat, plane[idx], y[idx], x[idx], scale[idx], n, h, w, pad,
             r_max, cfg)
        runs.append((a, torch.arange(idx.numel(), device=idx.device) < n, idx))
    return runs


def window_calls(torch, args, cfg) -> dict:
    """K5 on every lane of its octave-0 call (args: orientation_hist_peaks's
    positional arguments, f32 or bf16 planes) and K8's three bucket launches on the same lanes
    (`k8_runs`), named by form. Uses only the wrapper names
    orientation_hist_peaks and orientation_hist_perkey, so kernel_ab.py can
    time an older checkout with it."""
    from sift_features_tpu_torch.ops.kernels import orientation as k5

    runs = k8_runs(torch, args, cfg)
    f = "" if args[0].dtype == torch.float32 else ":bf16"
    return {"K5" + f: lambda: k5.orientation_hist_peaks(*args),
            "K8" + f: lambda: [k5.orientation_hist_perkey(*a) for a, _, _ in runs]}


def window_device_ms(torch, args, cfg) -> dict:
    """Device time (device_ms) per call of `window_calls`: K5's one launch
    and K8's three (one per bucket) on the same lanes."""
    return graph_device_ms(torch, window_calls(torch, args, cfg))


# the kernels the profiler separates, by their demangled names (spaces
# dropped) up to the argument list: this tree's and an older checkout's
ALONE_KERNELS = {
    "K3": ("refine_walk_kernel",),
    "K4": ("refine_step_kernel<float>",),
    "K4:bf16": ("refine_step_kernel<__nv_bfloat16>",),
    "K10": ("refine_region_kernel",),
    "K11": ("refine_tile_kernel",),
    "K5": ("orientation_kernel<float,true>", "orientation_kernel<float>"),
    "K8": ("orientation_kernel<float,false>", "orientation_perkey_kernel<float>")}


def profiled_kernels(prof, names: dict) -> dict:
    """{kernel: (summed device ms, launches)} of a torch.profiler session
    for the kernels of `names` (ALONE_KERNELS' form)."""
    from torch.autograd import DeviceType

    by_name = {n: k for k, ns in names.items() for n in ns}
    out = dict.fromkeys(names, (0.0, 0))
    for e in prof.key_averages():
        k = by_name.get(e.key.removeprefix("void ").split("(")[0].replace(" ", ""))
        if e.device_type == DeviceType.CUDA and k is not None:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            out[k] = (out[k][0] + us / 1e3, out[k][1] + e.count)
    return out


def kernel_alone_ms(torch, cap, cfg, reps: int = 10) -> dict:
    """Device time per launch of each kernel of `refine_calls` and of the
    f32 `window_calls` alone: reps calls of every wrapper in one
    torch.profiler (CUPTI) session, each kernel's time summed by its name,
    so the other kernels a wrapper launches (an older checkout's casts and
    fills, K8's clamps) are left out; None where the session recorded no
    launch of it. Opens a profiler, which slows every later launch in the
    process: call it after all timing."""
    from torch.profiler import ProfilerActivity, profile

    calls = {**refine_calls(torch, cap, cfg),
             **window_calls(torch, cap["K5"][0], cfg)}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    got = profiled_kernels(prof, {k: ALONE_KERNELS[k] for k in calls})
    return {k: ms / n if n else None for k, (ms, n) in got.items()}


def k5_probe_lines(torch, k5, args, kw, ms):
    """Prints (not gated) two variants of K5 at the same inputs: every lane
    dead (the launch and the zero writes), and the per-sample math replaced
    by constants (window reads, the loop and the ordered adds); each with
    CUDA events around the wrapper, as the kernel lines time, and as
    device time (device_ms)."""
    import probes

    dead = torch.zeros_like(args[5])
    a_dead = (*args[:5], dead, *args[6:])
    runs = {"full K5": lambda: k5.orientation_hist_peaks(*args, **kw),
            f"all {dead.numel()} lanes dead":
                lambda: k5.orientation_hist_peaks(*a_dead, **kw),
            "per-sample math constant": lambda: probes.k5_const_math(*args, **kw)}
    ev = {k: ms if k == "full K5" else time_ms(torch, fn, 10) for k, fn in runs.items()}
    dv = {k: device_ms(torch, fn) for k, fn in runs.items()}
    print("[probe] K5 split, ms/launch (events / device): " + "; ".join(
        f"{k} {ev[k]:.4f} / {dv[k]:.4f}" for k in runs), flush=True)


def k3_probe_line(torch, kr, args, kw, cfg, ms):
    """Prints (not gated) K3 at its octave-0 inputs with every lane dead
    (the launch, the mask and position reads, the row stores: what no walk
    costs) and with the walk cut to one and to two Newton steps, beside the
    full walk; each by CUDA events around the wrapper, as the kernel lines
    time, and as device time (device_ms)."""
    import dataclasses

    dead = torch.zeros_like(args[4])
    cut = {n: dataclasses.replace(cfg, max_interpolation_steps=n) for n in (1, 2)}
    runs = {"full K3": lambda: kr.refine_walk(*args, **kw),
            f"all {dead.numel()} lanes dead":
                lambda: kr.refine_walk(*args[:4], dead, *args[5:], **kw),
            "one Newton step": lambda: kr.refine_walk(*args[:8], cut[1], **kw),
            "two Newton steps": lambda: kr.refine_walk(*args[:8], cut[2], **kw)}
    ev = {k: ms if k == "full K3" else time_ms(torch, fn, 10) for k, fn in runs.items()}
    dv = {k: device_ms(torch, fn) for k, fn in runs.items()}
    print("[probe] K3 split, ms/launch (events / device): " + "; ".join(
        f"{k} {ev[k]:.4f} / {dv[k]:.4f}" for k in runs), flush=True)


def check_kernels(torch, cap, cfg, dev):
    """Phase 3: every kernel against its plain version at octave 0."""
    from sift_features_tpu_torch.ops.extrema import newton_step, refine
    from sift_features_tpu_torch.ops.kernels import (
        descriptor as k6, extrema as k2, orientation as k5, pyramid as k1,
        refine as k34)

    rows = {}
    record = make_record(torch, rows)

    # K1: the blur chain + DoG of every fused octave (the tiles' edge cases
    # differ by shape) against the plain version; times at octave 0
    (base, _), _ = cap["K1"]
    bases = [a[0] for a, _ in cap["K1*"]]
    outs = [[t for b in bases for t in k1.octave_fused(b, cfg)[:2]]
            for _ in range(2)]
    plain = [t for b in bases for t in k1.octave_fused_plain(b, cfg)[:2]]
    nb, hp, wp = base.shape
    taps = k1.octave_taps(cfg)
    px = nb * hp * wp
    k1_bytes = 4 * px * (1 + cfg.scales_per_octave + len(taps))
    k1_ops = px * (sum(4 * len(t) for t in taps) + len(taps))
    ms = time_ms(torch, lambda: k1.octave_fused(base, cfg), 10)
    plain_ms = time_ms(torch, lambda: k1.octave_fused_plain(base, cfg), 2)
    # yardstick: one cuDNN convolution giving all Gaussian levels from the
    # base, each level's taps composed into one 2D kernel (f32, TF32 off)
    wgt, r = composed_kernels(torch, taps, dev)
    torch.backends.cudnn.allow_tf32 = False
    conv = torch.nn.functional.conv2d
    lib_ms = time_ms(torch, lambda: conv(base[:, None], wgt, padding=r), 3)
    record("K1", outs[0], outs[1], plain, True, 0.0, ms, plain_ms, k1_bytes,
           k1_ops, lib_ms, f"; library conv2d {lib_ms:.3f} ms; bit-exact at "
           f"{len(bases)} octaves {[tuple(b.shape[1:]) for b in bases]}")
    del outs, plain, bases

    # K2: extremum words at every fused octave (the strips' and warps' edge
    # cases differ by shape); times at octave 0
    (dog, bounds, _), _ = cap["K2"]
    calls = [a[:2] for a, _ in cap["K2*"]]
    outs = [[k2.extrema_words(d, b, cfg) for d, b in calls] for _ in range(2)]
    plain = [k2.extrema_words_plain(d, b, cfg) for d, b in calls]
    ms = time_ms(torch, lambda: k2.extrema_words(dog, bounds, cfg), 10)
    plain_ms = time_ms(torch, lambda: k2.extrema_words_plain(dog, bounds, cfg), 2)
    work = k2_work(dog, bounds, cfg.scales_per_octave)
    record("K2", outs[0], outs[1], plain, True, 0.0, ms, plain_ms, *work,
           note=f"; bit-exact at {len(calls)} octaves")
    stream_probe_line(torch, k2, dog, bounds, cfg, "K2", ms, work[0])
    del outs, plain, calls

    # K3: the whole Newton walk, and K4 (one step) at the same candidates
    refine_dev = refine_device_ms(torch, cap, cfg)
    args, kw = cap["K3"]
    dog_flat, s0, y0, x0, valid = args[:5]
    poff = kw["plane_off"]
    full = (*args[:9], poff)
    outs = [k34.refine_walk(*args, **kw) for _ in range(2)]
    plain = refine(*args, **kw)
    active = refine_steps_active(torch, full, cfg)
    k = s0.numel()
    # every lane's mask byte, start position and row, each live lane's plane
    # offset, each step's cubes
    k3_bytes = (k * (1 + 3 * 4 + 16 * 4) + 4 * active[0]
                + CUBE_VALUES * 4 * sum(active))
    ms = time_ms(torch, lambda: k34.refine_walk(*args, **kw), 10)
    plain_ms = time_ms(torch, lambda: refine(*args, **kw), 2)
    record("K3", [outs[0]], [outs[1]], [plain], True, 0.0, ms, plain_ms,
           k3_bytes, 150 * sum(active),
           note=f"; active lanes per step {active} of {k}", dev_ms=refine_dev["K3"])
    k3_probe_line(torch, k34, args, kw, cfg, ms)
    # K4 as the refine loop calls it: int32 positions, a bool mask
    p = torch.clamp(s0, 1, cfg.scales_per_octave).int() + poff.int()
    k4_args = (dog_flat, p, y0.int(), x0.int(), valid.bool(), cfg)
    outs = [k34.refine_step(*k4_args) for _ in range(2)]
    plain = newton_step(*k4_args)
    ms = time_ms(torch, lambda: k34.refine_step(*k4_args), 10)
    plain_ms = time_ms(torch, lambda: newton_step(*k4_args), 2)
    record("K4", [nan_safe(torch, outs[0])], [nan_safe(torch, outs[1])],
           [nan_safe(torch, plain)], True, 0.0, ms, plain_ms,
           step_bytes(k, active[0], CUBE_VALUES * 4, 1), 150 * active[0],
           note=f" (first step of the same candidates); K4:bf16 on a bf16 copy "
                f"of the DoG: device {refine_dev['K4:bf16']}", dev_ms=refine_dev["K4"])
    del outs, plain

    # K5: orientation histograms + peaks. The plain version sums in the
    # kernel's order; the tolerance covers the f64 exp of two libraries
    args, kw = cap["K5"]
    window_dev = window_device_ms(torch, args, cfg)
    outs = [k5.orientation_hist_peaks(*args, **kw) for _ in range(2)]
    plain = k5.orientation_plain(*args, **kw)
    scale, live = args[4], args[5]
    n_live, px, smp = window_samples(torch, scale, live,
                                     3.0 * cfg.lambda_ori, 16)
    ms = time_ms(torch, lambda: k5.orientation_hist_peaks(*args, **kw), 10)
    plain_ms = time_ms(torch, lambda: k5.orientation_plain(*args, **kw), 1, 0)
    record("K5", outs[0], outs[1], plain, False, 1e-4, ms, plain_ms,
           4 * px + live.numel() * (5 * 4 + 41 * 4), 60 * smp,
           note=f"; {n_live} live of {live.numel()} lanes", dev_ms=window_dev["K5"])
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
    del outs, plain

    # K9: the per-frame chain of every octave that takes it, one launch per
    # level; times and bound per launch at octave 0 (the mean over the
    # octave's levels)
    (base, _), _ = cap["K9"]
    bases = [a[0] for a, _ in cap["K9*"]]
    outs = [[t for b in bases for t in k1.build_octave_padded(b, cfg)]
            for _ in range(2)]
    plain = [t for b in bases for t in k1.build_octave_padded_plain(b, cfg)]
    n_lv = len(taps)
    px = base.numel()
    ms = time_ms(torch, lambda: k1.build_octave_padded(base, cfg), 5) / n_lv
    plain_ms = time_ms(torch, lambda: k1.build_octave_padded_plain(base, cfg),
                       2) / n_lv
    # yardstick: one cuDNN convolution of level 1's taps as a 2D kernel
    t0 = taps[0].astype(np.float64)
    r0 = len(t0) // 2
    w1 = torch.from_numpy(np.outer(t0, t0).astype(np.float32)[None, None]).to(dev)
    lib_ms = time_ms(torch, lambda: conv(base[None, None], w1, padding=r0), 5)
    record("K9", outs[0], outs[1], plain, True, 0.0, ms,
           plain_ms, 4 * px * 3, px * (sum(4 * len(t) for t in taps)
                                       + len(taps)) / n_lv,
           lib_ms, f" (per level, {n_lv} levels); library conv2d of level 1 "
           f"{lib_ms:.3f} ms; bit-exact at {len(bases)} octaves")
    del outs, plain, bases

    # K2': the per-frame octave-0 words (the K2 kernel, one frame)
    (dog1, bounds1, _), _ = cap["K2′"]
    outs = [k2.extrema_words_single(dog1, bounds1, cfg) for _ in range(2)]
    plain = k2.extrema_words_plain(dog1[None], bounds1, cfg)[0]
    ms = time_ms(torch, lambda: k2.extrema_words_single(dog1, bounds1, cfg), 10)
    plain_ms = time_ms(torch, lambda: k2.extrema_words_plain(
        dog1[None], bounds1, cfg), 2)
    record("K2′", [outs[0]], [outs[1]], [plain], True, 0.0, ms, plain_ms,
           *k2_work(dog1[None], bounds1, cfg.scales_per_octave))
    del outs, plain

    # K5' and K6': the count-prefix window kernels at the per-frame octave 0
    args, kw = cap["K5′"]
    outs = [k5.orientation_hist_prefix(*args, **kw) for _ in range(2)]
    count = args[5]
    scale = args[4]
    live = torch.arange(scale.numel(), device=dev) < count
    plain = k5.orientation_plain(*args[:5], live, *args[6:], **kw)
    n_live, px, smp = window_samples(torch, scale, live,
                                     3.0 * cfg.lambda_ori, 16)
    ms = time_ms(torch, lambda: k5.orientation_hist_prefix(*args, **kw), 10)
    plain_ms = time_ms(torch, lambda: k5.orientation_plain(
        *args[:5], live, *args[6:], **kw), 1, 0)
    record("K5′", outs[0], outs[1], plain, False, 1e-4, ms, plain_ms,
           4 * px + live.numel() * (4 * 4 + 41 * 4) + 4, 60 * smp,
           note=f"; count {n_live} of {live.numel()} lanes")
    del outs, plain

    args, kw = cap["K6′"]
    outs = [k6.descriptor_hist_prefix(*args, **kw) for _ in range(2)]
    count, scale = args[6], args[4]
    live = torch.arange(scale.numel(), device=dev) < count
    plain = k6.descriptor_plain(*args[:6], live, *args[7:], **kw)
    n_live, px, smp = window_samples(torch, scale, live, radius_factor, 39)
    ms = time_ms(torch, lambda: k6.descriptor_hist_prefix(*args, **kw), 5)
    plain_ms = time_ms(torch, lambda: k6.descriptor_plain(
        *args[:6], live, *args[7:], **kw), 1, 0)
    record("K6′", [outs[0]], [outs[1]], [plain], False, 1e-4, ms, plain_ms,
           4 * px + live.numel() * (5 * 4 + 128 * 4) + 4, 100 * smp,
           note=f"; count {n_live} of {live.numel()} lanes")
    del outs, plain
    check_mode_kernels(torch, cap, cfg, record, rows, refine_dev, window_dev)
    return rows


def nan_safe(torch, t):
    """The f32 rows as int32 bit patterns: NaN-safe bit equality."""
    return t.view(torch.int32)


def k8_calls_check(torch, calls, cfg, name):
    """K8 (or K8:bf16) at the captured arguments of every call of a perkey
    step (calls: capture_first_calls' "<kernel>*" list): two launches
    identical and bit-equal to the plain version at each. Returns the
    number of calls."""
    from sift_features_tpu_torch.ops.kernels import orientation as k5

    for args, _ in calls:
        live = torch.arange(args[1].numel(), device=args[1].device) < args[5]
        outs = [k5.orientation_hist_perkey(*args) for _ in range(2)]
        plain = k5.orientation_raw_plain(*args[:5], live, *args[6:9], cfg, args[9])
        if not (torch.equal(outs[0], outs[1]) and torch.equal(outs[0], plain)):
            raise SystemExit(f"chip_smoke: {name} differs from its plain version "
                             f"at a call of the perkey step (K={live.numel()}, "
                             f"r_max {args[9]})")
    if not calls:
        raise SystemExit(f"chip_smoke: the perkey step made no {name} call")
    return len(calls)


def k8_check(torch, record, name, args5, cfg, window_dev, note):
    """K8 (or K8:bf16) on K5's lanes (args5: orientation_hist_peaks's
    positional arguments), one launch per scale bucket: each bucket's raw
    rows bit-equal to the plain version and to K5's rows of the same lanes,
    two launches identical; window_dev: the device times of K5 and K8 on
    those lanes (window_device_ms)."""
    from sift_features_tpu_torch.ops.kernels import orientation as k5

    f = name[2:]
    k5_raw = k5.orientation_hist_peaks(*args5)[0]
    runs = k8_runs(torch, args5, cfg)
    outs = [[k5.orientation_hist_perkey(*a) for a, _, _ in runs] for _ in range(2)]
    plain = [k5.orientation_raw_plain(*a[:5], lv, *a[6:9], cfg, a[9])
             for a, lv, _ in runs]
    for o, (_, lv, idx) in zip(outs[0], runs):
        if not torch.equal(o[lv], k5_raw[idx[lv]]):
            raise SystemExit(f"chip_smoke: {name}'s raw rows differ from K5{f}'s")
    ms = time_ms(torch, lambda: [k5.orientation_hist_perkey(*a) for a, _, _ in runs],
                 10) / len(runs)
    plain_ms = time_ms(torch, lambda: [k5.orientation_raw_plain(
        *a[:5], lv, *a[6:9], cfg, a[9]) for a, lv, _ in runs], 1, 0) / len(runs)
    nb = [window_samples(torch, a[4], lv, 3.0 * cfg.lambda_ori, a[9])
          for a, lv, _ in runs]
    # each launch reads its live lanes' inputs (plane, y, x, scale: 16 B) and
    # the union of their windows once, and writes every lane's row and
    # reads the count
    px = [window_union_px(torch, a[1], a[2], a[3], a[4], lv, 3.0 * cfg.lambda_ori,
                          a[9], a[6], a[7]) for a, lv, _ in runs]
    n_lanes = sum(lv.numel() for _, lv, _ in runs)
    n_live = sum(n_ for n_, _, _ in nb)
    esz = args5[0].element_size()
    dev = window_dev[name]
    k5_dev = window_dev["K5" + f]
    ratio = (f"{dev / k5_dev:.3f}x K5{f}'s {k5_dev:.4f}"
             if isinstance(dev, float) and isinstance(k5_dev, float) else k5_dev)
    record(name, outs[0], outs[1], plain, True, 0.0, ms, plain_ms,
           (esz * sum(px) + n_live * 4 * 4 + n_lanes * 36 * 4 + 4 * len(runs))
           / len(runs), 60 * sum(sm for _, _, sm in nb) / len(runs),
           note=f" (per bucket launch, {len(runs)} buckets{note}); raw rows equal "
                f"K5{f}'s; live per bucket {[n_ for n_, _, _ in nb]}; window "
                f"pixels per bucket, union {px}, summed over lanes "
                f"{[int(p_) for _, p_, _ in nb]}; device "
                f"time of the {len(runs)} launches {dev}: {ratio}",
           dev_ms=dev / len(runs) if isinstance(dev, float) else dev)


def check_mode_kernels(torch, cap, cfg, record, rows, refine_dev, window_dev):
    """Phase 3 for the kernels of the other modes: K10 and K11 at K3's
    octave-0 candidates (refine_dev: their device times), K8 and K7 on
    K5's and K6's lanes (window_dev: K5's and K8's device times)."""
    from sift_features_tpu_torch.ops.kernels import descriptor as k6
    from sift_features_tpu_torch.ops.kernels import refine as kr

    args, kw = cap["K3"]
    dog_flat, s0, y0, x0, valid = args[:5]
    pad, h, w = args[5:8]
    poff = kw["plane_off"]
    full = (*args[:9], poff)
    active = refine_steps_active(torch, full, cfg)
    k = s0.numel()

    # K10: one region-grouped step at the first step's candidates; equal to
    # K4 and to the plain version bit for bit, non-finite values included
    p = torch.clamp(s0, 1, cfg.scales_per_octave) + poff
    k10_args = (dog_flat, p, y0, x0, valid, cfg)
    g = kr.region_order(p, y0, x0, valid, *dog_flat.shape)
    outs = [kr.region_step(dog_flat, g, cfg) for _ in range(2)]
    k4 = kr.refine_step(*k10_args)
    plain = kr.region_step_plain(dog_flat, g, cfg)
    if not torch.equal(nan_safe(torch, kr.refine_step_region(*k10_args)),
                       nan_safe(torch, k4)):
        raise SystemExit("chip_smoke: K10 disagrees with K4")
    ms = time_ms(torch, lambda: kr.region_step(dog_flat, g, cfg), 10)
    wrapper_ms = time_ms(torch, lambda: kr.refine_step_region(*k10_args), 10)
    plain_ms = time_ms(torch, lambda: kr.region_step_plain(dog_flat, g, cfg), 2)
    n_act = int(g["n_active"])
    keys = g["key"][:n_act]
    n_runs = int((keys[1:] != keys[:-1]).sum()) + 1 if n_act else 0
    record("K10", [nan_safe(torch, outs[0])], [nan_safe(torch, outs[1])],
           [nan_safe(torch, plain)], True, 0.0, ms, plain_ms,
           step_bytes(k, active[0], CUBE_VALUES * 4, 4), 150 * active[0],
           note=f"; equal to K4 bit for bit; {n_runs} region runs for {n_act} "
                f"active lanes; with the region sort {wrapper_ms:.4f} ms",
           dev_ms=refine_dev["K10"])
    rows["K10"]["wrapper_ms"] = wrapper_ms
    del outs, plain, k4

    # K11: the tile walk on the grouped slots (rows and escape flags against
    # the plain version), and the merged rows against K3's. The plain
    # version counts the walks going at each step, for the bound
    lay = kr.tile_layout(dog_flat, s0, y0, x0, valid, pad, cfg, poff)
    outs = [kr.refine_tile_slots(dog_flat, lay, pad, h, w, cfg) for _ in range(2)]
    walks = []
    plain = kr.refine_tile_plain(dog_flat, lay, pad, h, w, cfg, counts=walks)
    merged = kr.refine_tile(*args, **kw)
    k3 = kr.refine_walk(*args, **kw)
    if not torch.equal(merged, k3):
        raise SystemExit("chip_smoke: K11's merged rows differ from K3's")
    n_esc = int((outs[0][:, 9] > 0).sum())
    n_blocks = int((lay.active_b > 0).sum())
    n_live = int(lay.a_slot.bool().sum())
    ms = time_ms(torch, lambda: kr.refine_tile_slots(dog_flat, lay, pad, h, w,
                                                     cfg), 10)
    plain_ms = time_ms(torch, lambda: kr.refine_tile_plain(dog_flat, lay, pad,
                                                           h, w, cfg), 2)
    # every slot's row and every block's active count; the slot flags and
    # window origin (r0, c0, pb) of each active block; each live slot's
    # (s, y, x); each walk's cube per step
    k11_bytes = (lay.T_cap * 16 * 4 + lay.nb * 4
                 + n_blocks * (kr.TILE_BK * 4 + 3 * 4) + n_live * 3 * 4
                 + CUBE_VALUES * 4 * sum(walks))
    record("K11", [outs[0]], [outs[1]], [plain], True, 0.0, ms, plain_ms,
           k11_bytes, 150 * sum(walks),
           note=f"; merged rows equal K3's; {n_esc} escaped walks of "
                f"{int(valid.sum())} candidates; {n_blocks} of {lay.nb} "
                f"blocks active, {lay.T_cap} slots; active walks per step "
                f"{walks}", dev_ms=refine_dev["K11"])
    rows["K11"]["escapes"] = n_esc
    del outs, plain, merged, k3

    # K8 and K7: one launch per scale bucket on the compacted lanes of that
    # bucket, as the perkey dispatchers launch them
    S = cfg.scales_per_octave
    args5 = cap["K5"][0]
    k8_check(torch, record, "K8", args5, cfg, window_dev, "")
    args6, kw6 = cap["K6"]
    gflat, plane, xi, yi, scale, angle, live = args6[:7]
    k6_raw = k6.descriptor_hist(*args6, **kw6)
    runs = []
    for idx, n, r_max in bucket_lanes(plane, live, S, k6.bucket_radii(cfg)):
        a = (gflat, plane[idx], xi[idx], yi[idx], scale[idx], angle[idx], n, h,
             w, pad, r_max, cfg)
        lv = torch.arange(idx.numel(), device=idx.device) < n
        runs.append((a, lv, idx, n, r_max))
    outs = [[k6.descriptor_hist_perkey(*a) for a, *_ in runs] for _ in range(2)]
    plain = [k6.descriptor_plain(*a[:6], lv, *a[7:10], cfg, r_max=r_max)
             for a, lv, _, _, r_max in runs]
    for o, (_, lv, idx, _, _) in zip(outs[0], runs):
        if not torch.equal(o[lv], k6_raw[idx[lv]]):
            raise SystemExit("chip_smoke: K7's raw rows differ from K6's")
    ms = time_ms(torch, lambda: [k6.descriptor_hist_perkey(*a) for a, *_ in runs],
                 5) / len(runs)
    plain_ms = time_ms(torch, lambda: [k6.descriptor_plain(
        *a[:6], lv, *a[7:10], cfg, r_max=r_max) for a, lv, _, _, r_max in runs],
        1, 0) / len(runs)
    factor = cfg.lambda_descr * np.sqrt(2.0) * (cfg.descriptor_n_histograms + 1) / 2
    nb = [window_samples(torch, a[4], lv, factor, r_max)
          for a, lv, _, _, r_max in runs]
    n_lanes = sum(lv.numel() for _, lv, *_ in runs)
    record("K7", outs[0], outs[1], plain, False, 1e-4, ms, plain_ms,
           (4 * sum(px for _, px, _ in nb) + n_lanes * (5 * 4 + 128 * 4) + 4
            * len(runs)) / len(runs), 100 * sum(sm for _, _, sm in nb) / len(runs),
           note=f" (per bucket launch, {len(runs)} buckets); raw rows equal "
                f"K6's; live per bucket {[n_ for n_, _, _ in nb]}")


def main_path_step(torch, extract_batch, match_dense, frames, cfg, dev):
    """One step of the bench: extract, per-frame top-1024 by response,
    cross-check matching of frame i (queries) against frame i+1 (train)."""
    from sift_features_tpu_torch.models.extractor import stable_top_k

    res = extract_batch(frames, cfg, device=dev)
    resp = torch.where(res["valid"], res["kps"][..., 4],
                       torch.tensor(float("-inf"), device=dev))
    # jax.lax.top_k's tie rule (bench.py:90): lower index first
    top = stable_top_k(resp, N_MATCH)[1]
    desc = torch.gather(res["desc"], 1, top[..., None].expand(-1, -1, 128))
    d = desc.float()
    matches = [match_dense(d[(i + 1) % d.shape[0]], d[i])
               for i in range(d.shape[0])]
    return res, d, matches


def same_rows(torch, extractor, got, want, cfg):
    """got: _extract_single's result; want: extract_batch's row for that
    frame. Counters and valid must be identical. -> (share of rows
    byte-equal in kps and desc, max kps field difference, max descriptor
    byte difference, the octaves whose rows differ)."""
    for key in ("n_candidates", "n_survivors", "n_emitted", "valid"):
        if not torch.equal(got[key], want[key]):
            raise SystemExit(f"chip_smoke: per-frame: {key} differs from "
                             f"extract_batch")
    v = want["valid"]
    kg, kw = got["kps"][v], want["kps"][v]
    dg, dw = got["desc"][v], want["desc"][v]
    eq = (kg == kw).all(1) & (dg == dw).all(1)
    kp_err = float((kg - kw).abs().max()) if v.any() else 0.0
    d_err = int((dg.int() - dw.int()).abs().max()) if v.any() else 0
    # octave of each row, from the per-octave capacities
    caps, hh, ww = [], H * cfg.inv_delta_min, W * cfg.inv_delta_min
    for _ in range(want["n_emitted"].shape[0]):
        caps.append(extractor.octave_capacities(hh, ww, cfg)[2])
        hh, ww = hh // 2, ww // 2
    octave = np.repeat(np.arange(len(caps)), caps)[v.cpu().numpy()]
    bad = sorted(set(octave[~eq.cpu().numpy()].tolist()))
    return float(eq.float().mean()), kp_err, d_err, bad


def device_allocs(torch) -> int:
    """cudaMalloc calls of PyTorch's caching allocator so far (each one a
    new segment the cache could not serve)."""
    return int(torch.cuda.memory_stats().get("num_device_alloc", 0))


def port_kernel_names() -> set:
    """The __global__ functions of the port's CUDA sources."""
    import glob
    import os
    import re

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "sift_features_tpu_torch", "csrc", "*.cu")
    return {m for fn in glob.glob(src)
            for m in re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                                 open(fn).read())}


def profile_step(torch, step, step_ms: float, tag: str, top: int = 15) -> float:
    """Device kernel time of one step() by kernel and host-op time by
    operator (torch.profiler, CUPTI); prints the top entries and returns the
    summed device kernel ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
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
    print(f"[{tag}] one step: {busy_ms:.1f} ms of device kernels "
          f"({busy_ms / step_ms:.1%} of the median step)")
    for t, n, key in kern[:top]:
        print(f"[{tag}] kernel {t:9.3f} ms {n:6d}x  {key[:80]}")
    ours = port_kernel_names()
    for t, n, key in kern:
        name = key.removeprefix("void ").split("<")[0].split("(")[0]
        if name in ours:
            print(f"[{tag}] port kernel {t:9.3f} ms {n:6d}x  {key[:80]}")
    for t, n, key in ops[:top]:
        print(f"[{tag}] op     {t:9.3f} ms {n:6d}x  {key[:80]}")
    return busy_ms


def budget_phase(torch, extractor, match_dense, frames, res_full, cfg, dev):
    """bench.py's step_b: extract_batch with features_limit, then matching
    of the first min(1024, limit) rows of frame i against frame i+1."""
    from sift_features_tpu_torch.ops.kernels import build

    k = min(N_MATCH, BUDGET)

    def step():
        r = extractor.extract_batch(frames, cfg, features_limit=BUDGET,
                                    device=dev)
        d = r["desc"][:, :k].float()
        return r, [match_dense(d[(i + 1) % B], d[i]) for i in range(B)]

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    rb, matches = step()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not launches.get("K6′") or launches.get("K6"):
        raise SystemExit(f"chip_smoke: budget path must launch K6′ and not K6: "
                         f"{launches}")
    want = extractor._truncate_result(res_full, BUDGET)
    for key in ("kps", "desc", "valid", "src_idx"):
        if not torch.equal(rb[key], want[key]):
            raise SystemExit(f"chip_smoke: budgeted {key} differs from the "
                             f"truncated unbudgeted output")
    kps_frame = rb["valid"].sum(1).tolist()
    n_kept = [int(m[2].sum()) for m in matches]
    if min(kps_frame) < k or min(n_kept) < 1:
        raise SystemExit(f"chip_smoke: budget: {kps_frame} rows, {n_kept} kept")
    # 10 budget steps interleaved with 10 unbudgeted ones, so the host
    # clock's drift touches both alike
    step_s, full_s = [], []
    allocs = {"budget": 0, "unbudgeted": 0}
    for _ in range(10):
        for kind, fn, acc in (("budget", step, step_s), ("unbudgeted", lambda:
                main_path_step(torch, extractor.extract_batch, match_dense,
                               frames, cfg, dev), full_s)):
            n0 = device_allocs(torch)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            acc.append(time.perf_counter() - t0)
            allocs[kind] += device_allocs(torch) - n0
    med = statistics.median(step_s) * 1e3
    busy_ms = profile_step(torch, step, med, "budget-profile", top=8)
    row = {"e2e": f"1080p extract features_limit={BUDGET} + match first {k}, "
                  f"B={B}", "kps_per_frame": kps_frame, "matches_kept": n_kept,
           "median_step_ms": med, "step_ms": [t * 1e3 for t in step_s],
           "frames_per_s": B / statistics.median(step_s),
           "unbudgeted_median_step_ms_interleaved":
               statistics.median(full_s) * 1e3,
           "unbudgeted_step_ms_interleaved": [t * 1e3 for t in full_s],
           "profiled_step_kernel_ms": busy_ms,
           "device_allocs_in_interleaved_steps": allocs,
           "peak_mem_gb": peak_gb, "launches": launches,
           "identical_to_truncation": True}
    print(f"[budget] byte-identical to _truncate_result of the unbudgeted "
          f"output; K6′ launches {launches['K6′']}, K6 none", flush=True)
    print(json.dumps(row, ensure_ascii=False), flush=True)
    return row


def per_frame_phase(torch, extractor, frames, res_full, cfg, dev):
    """_extract_single on frame 0 against extract_batch's row 0."""
    from sift_features_tpu_torch.ops.kernels import build

    img = torch.as_tensor(frames[0], device=dev)
    n_oct = extractor._n_octaves(H, W, cfg)
    extractor._extract_single(img, n_oct, cfg)
    torch.cuda.synchronize()
    build.reset_launches()
    got = extractor._extract_single(img, n_oct, cfg)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    for k in ("K9", "K2′", "K3", "K5′", "K6′"):
        if not launches.get(k):
            raise SystemExit(f"chip_smoke: per-frame path did not launch {k}: "
                             f"{launches}")
    want = {k: v[0] for k, v in res_full.items()}
    frac, kp_err, d_err, bad = same_rows(torch, extractor, got, want, cfg)
    t_ms = time_ms(torch, lambda: extractor._extract_single(img, n_oct, cfg), 3)
    profile_step(torch, lambda: extractor._extract_single(img, n_oct, cfg), t_ms,
                 "per-frame-profile", top=8)
    print(f"[per-frame] launches {launches}; {int(want['valid'].sum())} "
          f"keypoints, counters and valid identical; rows byte-equal "
          f"{frac:.6f}, max field diff {kp_err:.3g}, max byte diff {d_err}, "
          f"octaves with differing rows {bad}; {t_ms:.1f} ms per frame",
          flush=True)
    if frac < 0.99 or kp_err > 1e-3:
        raise SystemExit("chip_smoke: per-frame path disagrees with "
                         "extract_batch")
    return launches


def split_phase(torch, extractor, frames, res_full, cfg, dev):
    """precompute + extract_with_precomputed on frame 0 against
    extract_batch's row 0, at tests/test_split_api.py's tolerance."""
    from sift_features_tpu_torch.ops.kernels import build

    build.reset_launches()
    t0 = time.perf_counter()
    octs, dogs = extractor.precompute(frames[:1], cfg, device=dev)
    got = extractor.extract_with_precomputed(octs, dogs, cfg, device=dev)
    torch.cuda.synchronize()
    t_s = time.perf_counter() - t0
    got = {k: v[0] for k, v in got.items()}
    want = {k: v[0] for k, v in res_full.items()}
    vs, vw = got["valid"], want["valid"]
    if int(vs.sum()) != int(vw.sum()):
        raise SystemExit(f"chip_smoke: split path found {int(vs.sum())} "
                         f"keypoints, extract_batch {int(vw.sum())}")
    kp_err = float((got["kps"][vs] - want["kps"][vw]).abs().max())
    d_err = int((got["desc"][vs].int() - want["desc"][vw].int()).abs().max())
    print(f"[split] launches {dict(build.LAUNCHES)}; {int(vs.sum())} "
          f"keypoints as extract_batch; max field diff {kp_err:.3g}, max byte "
          f"diff {d_err}; {t_s * 1e3:.1f} ms (first call)", flush=True)
    if kp_err > 1e-4 or d_err > 1:
        raise SystemExit("chip_smoke: split path disagrees with extract_batch")


# tests/test_fuzz.py's seeds and shapes
FUZZ_IMAGES = ((0, 64, 96), (1, 97, 65), (2, 80, 80), (3, 51, 127))


def fuzz_image(seed: int, h: int, w: int) -> np.ndarray:
    """A seeded smooth texture as tests/test_fuzz.py draws it (noise on a
    coarse grid, cubic zoom through scipy in place of cv2's resize)."""
    from scipy.ndimage import zoom

    base = np.random.RandomState(seed).rand(h // 4 + 2, w // 4 + 2)
    img = zoom(base, (h / base.shape[0], w / base.shape[1]), order=3)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def oracle_rows(img: np.ndarray, cfg):
    """The port's NumPy oracle (oracle.sift with NumpyProcessing, step by
    step) on img: keypoints (N, 5), descriptors (N, 128) u8 and the octave
    of each row."""
    from sift_features_tpu_torch.oracle import oracle as orc
    from sift_features_tpu_torch.oracle.processing import NumpyProcessing

    seed = orc.create_seed_image(img, NumpyProcessing, cfg)
    ss = orc.build_gaussian_scale_space(seed, cfg.n_octaves(*seed.shape),
                                        NumpyProcessing, cfg)
    kps = orc.find_keypoints(ss, orc.build_dog(ss), cfg)
    d = np.float32(cfg.delta_min)
    rows = np.asarray([[k.x * d, k.y * d, k.size * d, k.angle, k.response]
                       for k in kps], np.float32).reshape(-1, 5)
    return (rows, orc.compute_descriptors(ss, kps, cfg),
            np.asarray([k.octave for k in kps], np.int64))


def oracle_errors(kc, dc, ko, do):
    """(max x/y/size/response diff, max angle diff in degrees, share of
    descriptor rows byte-equal) of the card's rows against the oracle's."""
    f_err = float(np.abs(kc[:, [0, 1, 2, 4]] - ko[:, [0, 1, 2, 4]]).max())
    dang = np.abs(kc[:, 3] - ko[:, 3])
    a_err = float(np.minimum(dang, 360 - dang).max())
    return f_err, a_err, float((dc == do).all(1).mean())


def oracle_check(small: np.ndarray, res: dict, cfg) -> None:
    """The port's NumPy oracle (oracle.sift with NumpyProcessing) against
    sift on the card at the JAX package's extractor-to-oracle bar
    (tests/test_fuzz.py): equal counts; x, y, size and response within
    2e-3; angles within 0.5 degrees; >= 90% of descriptor rows byte-exact.
    On that test's four image shapes, whole images. On the 240 x 320 small
    image (res: extract_batch of it on the card), octave by octave: octave
    1 overflows the extractor's capacities (candidates 670 > 512, survivors
    > 256; the sizing rule of octave_capacities, the JAX package's), which
    keeps the first rows in scan order where the oracle keeps every one.
    So every octave within its capacities is held to the bar, and the
    overflowing one, which must be octave 1 and no other, has fewer rows
    than the oracle's, held to the bar against the oracle's first rows."""
    import sift_features_tpu_torch as port
    from sift_features_tpu_torch.models.extractor import octave_capacities
    from sift_features_tpu_torch.oracle import sift as oracle_sift
    from sift_features_tpu_torch.oracle.processing import NumpyProcessing

    oracle_s = card_s = 0.0
    n, errs = [], []
    for seed, h, w in FUZZ_IMAGES:
        img = fuzz_image(seed, h, w)
        t0 = time.perf_counter()
        ko, do = oracle_sift(img, proc=NumpyProcessing)
        oracle_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        kc, dc = port.sift(img, device="cuda")
        card_s += time.perf_counter() - t0
        if len(kc) != len(ko) or len(kc) < 20:
            raise SystemExit(f"chip_smoke: oracle: {h}x{w}: {len(ko)} "
                             f"keypoints, the card {len(kc)}")
        n.append(len(kc))
        errs.append(oracle_errors(kc, dc, ko, do))

    t0 = time.perf_counter()
    ko, do, octs = oracle_rows(small, cfg)
    small_s = time.perf_counter() - t0
    valid, kps, desc = (res[k][0].cpu().numpy() for k in ("valid", "kps", "desc"))
    h, w = small.shape[0] * cfg.inv_delta_min, small.shape[1] * cfg.inv_delta_min
    off, over, per_octave = 0, [], []
    for o in range(res["n_candidates"].shape[1]):
        caps = octave_capacities(h, w, cfg)
        counts = [int(res[c][0, o]) for c in ("n_candidates", "n_survivors",
                                               "n_emitted")]
        v = valid[off:off + caps[2]]
        kc, dc = kps[off:off + caps[2]][v], desc[off:off + caps[2]][v]
        ko_o, do_o = ko[octs == o], do[octs == o]
        off, h, w = off + caps[2], h // 2, w // 2
        per_octave.append((len(kc), len(ko_o)))
        if any(c > cap for c, cap in zip(counts, caps)):
            over.append(o)
            print(f"[oracle] {SMALL[0]}x{SMALL[1]} octave {o}: candidates / "
                  f"survivors / emitted {counts} against capacities "
                  f"{list(caps)}; the card {len(kc)} keypoints, the oracle "
                  f"{len(ko_o)}", flush=True)
            if len(kc) >= len(ko_o):
                raise SystemExit(f"chip_smoke: oracle: octave {o} overflows "
                                 "but keeps every oracle keypoint")
        elif len(kc) != len(ko_o):
            raise SystemExit(f"chip_smoke: oracle: octave {o}: {len(ko_o)} "
                             f"keypoints, the card {len(kc)}")
        if len(kc):
            errs.append(oracle_errors(kc, dc, ko_o[:len(kc)], do_o[:len(kc)]))
    if off != valid.shape[0] or over != [1]:
        raise SystemExit(f"chip_smoke: oracle: octaves {over} overflow on the "
                         f"small image (expected [1]); {off} rows of "
                         f"{valid.shape[0]} read")
    f_err, a_err = max(e[0] for e in errs), max(e[1] for e in errs)
    rows_eq = min(e[2] for e in errs)
    print(f"[oracle] tests/test_fuzz.py's {len(FUZZ_IMAGES)} images: oracle.sift "
          f"(NumpyProcessing) {n} keypoints in {oracle_s:.2f} s, sift on the "
          f"card {card_s:.3f} s (first calls); {SMALL[0]}x{SMALL[1]}: the "
          f"oracle {len(ko)} keypoints in {small_s:.2f} s, the card "
          f"{sum(c for c, _ in per_octave)}, (card, oracle) per octave "
          f"{per_octave}; all: max x/y/size/response diff {f_err:.3g}, max "
          f"angle diff {a_err:.3g} deg, descriptor rows byte-equal "
          f"{rows_eq:.4f} at least", flush=True)
    if f_err > 2e-3 or a_err >= 0.5 or rows_eq < 0.9:
        raise SystemExit("chip_smoke: the card disagrees with the oracle")


# mode -> (SiftConfig fields, kernels it must launch, kernels it replaces).
# region_steps defaults to max_interpolation_steps: every step is K10's
MODES = {"region": ({"refine_mode": "region"}, ("K10",), ("K3",)),
         "tile": ({"refine_mode": "tile"}, ("K11", "K4"), ("K3",)),
         "perkey": ({"window_kernel": "perkey"}, ("K8", "K7"), ("K5", "K6"))}


def modes_phase(torch, extractor, match_dense, frames, res_full, cfg, dev):
    """The main step in each other mode against the default step's output;
    then the budget step once with perkey."""
    import dataclasses

    from sift_features_tpu_torch.ops.kernels import build
    from sift_features_tpu_torch.ops.kernels import refine as kr

    out = {}
    for mode, (fields, need, never) in MODES.items():
        mcfg = dataclasses.replace(cfg, **fields)
        main_path_step(torch, extractor.extract_batch, match_dense, frames, mcfg,
                       dev)
        torch.cuda.synchronize()
        escapes = []
        tile_slots = kr.refine_tile_slots

        def counted(dog_flat, g, *a, **k):
            o = tile_slots(dog_flat, g, *a, **k)
            escapes.append((o[:, 9] > 0).sum())
            return o
        kr.refine_tile_slots = counted
        build.reset_launches()
        try:
            res, _, _ = main_path_step(torch, extractor.extract_batch,
                                       match_dense, frames, mcfg, dev)
            torch.cuda.synchronize()
        finally:
            kr.refine_tile_slots = tile_slots
        launches = dict(build.LAUNCHES)
        for key in res_full:
            if not torch.equal(res[key], res_full[key]):
                raise SystemExit(f"chip_smoke: {mode} mode differs from the "
                                 f"default step in {key}")
        if not all(launches.get(k) for k in need) or any(
                launches.get(k) for k in never):
            raise SystemExit(f"chip_smoke: {mode} mode must launch {need} and "
                             f"not {never}: {launches}")
        # 5 steps of the mode, each after one default step, so the host
        # clock's drift touches both alike
        step_s, base_s = [], []
        for _ in range(5):
            for c, acc in ((cfg, base_s), (mcfg, step_s)):
                t0 = time.perf_counter()
                main_path_step(torch, extractor.extract_batch, match_dense,
                               frames, c, dev)
                torch.cuda.synchronize()
                acc.append(time.perf_counter() - t0)
        med = statistics.median(step_s) * 1e3
        busy_ms = profile_step(torch, lambda: main_path_step(
            torch, extractor.extract_batch, match_dense, frames, mcfg, dev), med,
            f"{mode}-profile", top=6)
        n_esc = [int(e) for e in escapes]
        out[mode] = {"median_step_ms": med, "step_ms": [t * 1e3 for t in step_s],
                     "default_median_step_ms_interleaved":
                         statistics.median(base_s) * 1e3,
                     "default_step_ms_interleaved": [t * 1e3 for t in base_s],
                     "profiled_step_kernel_ms": busy_ms, "launches": launches}
        if mode == "tile":
            out[mode]["escapes_per_octave"] = n_esc
        print(f"[modes] {mode}: byte-identical to the default step; median "
              f"{med:.1f} ms of 5 steps against {statistics.median(base_s) * 1e3:.1f}"
              f" ms for the default steps between them; launches {launches}"
              + (f"; escaped walks per octave {n_esc}" if mode == "tile" else ""),
              flush=True)

    # the budget step once with perkey: K7 describes the chosen keypoints
    mcfg = dataclasses.replace(cfg, window_kernel="perkey")
    extractor.extract_batch(frames, mcfg, features_limit=BUDGET, device=dev)
    torch.cuda.synchronize()
    build.reset_launches()
    rb = extractor.extract_batch(frames, mcfg, features_limit=BUDGET, device=dev)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    want = extractor._truncate_result(res_full, BUDGET)
    for key in want:
        if not torch.equal(rb[key], want[key]):
            raise SystemExit(f"chip_smoke: perkey budget differs in {key}")
    if not launches.get("K7") or launches.get("K6′") or launches.get("K6"):
        raise SystemExit(f"chip_smoke: perkey budget must launch K7 and not "
                         f"K6/K6′: {launches}")
    out["perkey_budget"] = {"launches": launches}
    print(f"[modes] perkey budget: byte-identical to the default budget "
          f"output; launches {launches}", flush=True)
    print(json.dumps({"modes": out}, ensure_ascii=False), flush=True)
    return out


# storage mode -> (SiftConfig fields, kernels its main step must launch,
# kernels it must not launch)
STORAGE = {
    "bfloat16": ({"storage_dtype": "bfloat16"},
                 ("K1:bf16", "K2:bf16", "K4:bf16", "K5:bf16", "K6:bf16"),
                 ("K1", "K2", "K3", "K4", "K5", "K6")),
    "split": ({"storage_dtype": "split"},
              ("K1:split", "K2", "K3", "K5:bf16", "K6:bf16"),
              ("K1", "K4:bf16", "K5", "K6")),
    "gather16": ({"gather_dtype": "bfloat16"},
                 ("K1:g16", "K2", "K3", "K5:bf16", "K6:bf16"),
                 ("K1", "K4:bf16", "K5", "K6"))}
EXTRACTOR = "sift_features_tpu_torch.models.extractor"
KMOD = "sift_features_tpu_torch.ops.kernels."


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def check_storage_kernels(torch, extractor, frames, cfgs, cfg, dev, rows):
    """Phase 11a: each kernel form of the storage modes against its plain
    version at the octave-0 inputs of the path that runs it, and the split
    and gather16 K1 against the f32 K1 bit for bit. Returns the K9 forms'
    launches per build_octave_padded_batched call."""
    import dataclasses

    from sift_features_tpu_torch.ops.extrema import newton_step
    from sift_features_tpu_torch.ops.kernels import (
        build, descriptor as k6, extrema as k2, orientation as k5,
        pyramid as k1, refine as k34)

    record = make_record(torch, rows)
    bf16 = torch.bfloat16
    S = cfg.scales_per_octave
    cap = capture_first_calls(torch, {
        "K1": (EXTRACTOR, "octave_fused"), "K2": (EXTRACTOR, "extrema_words"),
        "K4": (KMOD + "refine", "refine_step"),
        "K5": (EXTRACTOR, "orientation_hist_peaks"),
        "K6": (EXTRACTOR, "descriptor_hist")},
        lambda: extractor.extract_batch(frames, cfgs["bfloat16"], device=dev),
        every=("K1", "K2"))
    cap_g = capture_first_calls(torch, {
        "K1": (EXTRACTOR, "octave_fused"),
        "K6′": (KMOD + "descriptor", "descriptor_hist_prefix")},
        lambda: extractor.extract_batch(frames, cfgs["gather16"],
                                        features_limit=BUDGET, device=dev),
        every=("K1",))
    cap_p = capture_first_calls(torch, {
        "K8": (KMOD + "orientation", "orientation_hist_perkey"),
        "K7": (KMOD + "descriptor", "descriptor_hist_perkey")},
        lambda: extractor.extract_batch(
            frames, dataclasses.replace(cfgs["bfloat16"], window_kernel="perkey"),
            device=dev), every=("K8",))
    base16, base32 = cap["K1"][0][0], cap_g["K1"][0][0]
    if base16.dtype != bf16 or base32.dtype != torch.float32:
        raise SystemExit("chip_smoke: storage bases of the wrong type")

    # K1 forms: bit-exact against the plain version at every fused octave;
    # split and gather16 against the f32 K1 on the same bases, bit for bit.
    # Times at octave 0
    bases16 = [a[0] for a, _ in cap["K1*"]]
    bases32 = [a[0] for a, _ in cap_g["K1*"]]
    taps = k1.octave_taps(cfg)
    px = base32.numel()
    k1_ops = px * (sum(4 * len(t) for t in taps) + len(taps))
    wgt, r = composed_kernels(torch, taps, dev)
    conv = torch.nn.functional.conv2d
    lib16 = time_ms(torch, lambda: conv(base16[:, None], wgt.to(bf16), padding=r), 2)
    f32_k1 = [k1.octave_fused(b, cfg)[:2] for b in bases32]
    for name, bases, kw in (("K1:bf16", bases16, {}),
                            ("K1:split", bases32, {"split": True}),
                            ("K1:g16", bases32, {"gather16": True})):
        base = bases[0]
        res = [[k1.octave_fused(b, cfg, **kw) for b in bases] for _ in range(2)]
        plain = [k1.octave_fused_plain(b, cfg, **kw) for b in bases]
        keep = [i for i, t in enumerate(plain[0]) if t is not None]
        ms = time_ms(torch, lambda: k1.octave_fused(base, cfg, **kw), 10)
        plain_ms = time_ms(torch, lambda: k1.octave_fused_plain(base, cfg, **kw), 2)
        note = ""
        for (g, d, g16, l3), (g32, d32) in zip(res[0], f32_k1):
            if name == "K1:split":
                if not (torch.equal(d, d32) and torch.equal(l3, g32[:, S - 1])
                        and torch.equal(g, g32.to(bf16))):
                    raise SystemExit("chip_smoke: split K1 differs from the f32 K1")
                note = "; DoG and l3 equal the f32 K1's, gauss its bf16 rounding"
            if name == "K1:g16":
                if not (torch.equal(g, g32) and torch.equal(d, d32)
                        and torch.equal(g16, g32.to(bf16))):
                    raise SystemExit("chip_smoke: gather16 K1 differs from the "
                                     "f32 K1")
                note = "; gauss and DoG equal the f32 K1's, g16 its bf16 rounding"
        lib = lib16 if name == "K1:bf16" else rows["K1"]["library_ms"]
        record(name, [r[i] for r in res[0] for i in keep],
               [r[i] for r in res[1] for i in keep],
               [p[i] for p in plain for i in keep], True, 0.0, ms, plain_ms,
               nbytes_of(base, *res[0][0]), k1_ops, lib,
               f"{note}; bit-exact at {len(bases)} octaves; library conv2d "
               f"({base.dtype}) {lib:.3f} ms")
        del res, plain
    del f32_k1

    # K9 forms: build_octave_padded_batched, which no entry point calls;
    # per level, as K9
    n_lv = len(taps)
    t0 = taps[0].astype(np.float64)
    w1 = torch.from_numpy(np.outer(t0, t0).astype(np.float32)[None, None]).to(dev)
    lib9 = time_ms(torch, lambda: conv(base16[:, None], w1.to(bf16),
                                       padding=len(t0) // 2), 5)
    k9_launches = {}
    for name, base, kw in (("K9:bf16", base16, {}),
                           ("K9:split", base32, {"split": True}),
                           ("K9:g16", base32, {"gather16": True})):
        build.reset_launches()
        res = [k1.build_octave_padded_batched(base, cfg, **kw) for _ in range(2)]
        k9_launches[name] = build.LAUNCHES.get(name, 0) // 2
        plain = k1.build_octave_padded_batched_plain(base, cfg, **kw)
        keep = [i for i, t in enumerate(plain) if t is not None]
        ms = time_ms(torch, lambda: k1.build_octave_padded_batched(
            base, cfg, **kw), 5) / n_lv
        plain_ms = time_ms(torch, lambda: k1.build_octave_padded_batched_plain(
            base, cfg, **kw), 2) / n_lv
        g, d, g16 = res[0]
        per_level = [base.element_size() if k == 0 else g.element_size() for k in
                     range(n_lv)]
        nbytes = px * (sum(per_level) + n_lv * (g.element_size() + d.element_size())
                       + (2 * S if g16 is not None else 0)) / n_lv
        lib = lib9 if name == "K9:bf16" else rows["K9"]["library_ms"]
        record(name, [res[0][i] for i in keep], [res[1][i] for i in keep],
               [plain[i] for i in keep], True, 0.0, ms, plain_ms, nbytes,
               px * (sum(4 * len(t) for t in taps) + n_lv) / n_lv, lib,
               f" (per level, {n_lv} levels, B={base.shape[0]}); library "
               f"conv2d of level 1 ({base.dtype}) {lib:.3f} ms")
        del res, plain

    # K2 (at every fused octave) and K4 on the bf16 DoG: bit-exact
    (dog, bounds, _), _ = cap["K2"]
    calls = [a[:2] for a, _ in cap["K2*"]]
    outs = [[k2.extrema_words(d, b, cfg) for d, b in calls] for _ in range(2)]
    plain = [k2.extrema_words_plain(d, b, cfg) for d, b in calls]
    ms = time_ms(torch, lambda: k2.extrema_words(dog, bounds, cfg), 10)
    plain_ms = time_ms(torch, lambda: k2.extrema_words_plain(dog, bounds, cfg), 2)
    work = k2_work(dog, bounds, cfg.scales_per_octave)
    record("K2:bf16", outs[0], outs[1], plain, True, 0.0, ms, plain_ms, *work,
           note=f"; bit-exact at {len(calls)} octaves")
    stream_probe_line(torch, k2, dog, bounds, cfg, "K2:bf16", ms, work[0])
    del outs, plain, calls
    # K4:bf16 as the bf16 step's refine loop calls it; its rows also equal
    # K10's on the f32 widening of the same DoG (exact)
    args, _ = cap["K4"]
    dog_flat, p, active = args[0], args[1], args[4]
    n_act = int(active.sum())
    outs = [k34.refine_step(*args) for _ in range(2)]
    plain = newton_step(*args)
    k10 = k34.refine_step_region(dog_flat.float(), *args[1:])
    if not torch.equal(nan_safe(torch, outs[0]), nan_safe(torch, k10)):
        raise SystemExit("chip_smoke: K4:bf16 disagrees with K10 on the widened DoG")
    ms = time_ms(torch, lambda: k34.refine_step(*args), 10)
    dev_ms = device_ms(torch, lambda: k34.refine_step(*args))
    plain_ms = time_ms(torch, lambda: newton_step(*args), 2)
    record("K4:bf16", [nan_safe(torch, outs[0])], [nan_safe(torch, outs[1])],
           [nan_safe(torch, plain)], True, 0.0, ms, plain_ms,
           step_bytes(p.numel(), n_act, CUBE_VALUES * 2, active.element_size()),
           150 * n_act,
           note=f" (first Newton step of the bf16 step at octave 0: {n_act} "
                f"active of {p.numel()} lanes); equal to K10 on the widened "
                f"DoG bit for bit", dev_ms=dev_ms)
    del outs, plain, k10

    # the window kernels on bf16 Gaussian levels: within 1e-4 of the plain
    # versions, two launches identical
    radius_factor = cfg.lambda_descr * np.sqrt(2.0) * (cfg.descriptor_n_histograms + 1) / 2
    args, kw = cap["K5"]
    outs = [k5.orientation_hist_peaks(*args, **kw) for _ in range(2)]
    plain = k5.orientation_plain(*args, **kw)
    n_live, wpx, smp = window_samples(torch, args[4], args[5],
                                      3.0 * cfg.lambda_ori, 16)
    ms = time_ms(torch, lambda: k5.orientation_hist_peaks(*args, **kw), 10)
    plain_ms = time_ms(torch, lambda: k5.orientation_plain(*args, **kw), 1, 0)
    record("K5:bf16", outs[0], outs[1], plain, False, 1e-4, ms, plain_ms,
           2 * wpx + args[5].numel() * (5 * 4 + 41 * 4), 60 * smp,
           note=f"; {n_live} live of {args[5].numel()} lanes")
    args, kw = cap["K6"]
    outs = [k6.descriptor_hist(*args, **kw) for _ in range(2)]
    plain = k6.descriptor_plain(*args, **kw)
    n_live, wpx, smp = window_samples(torch, args[4], args[6], radius_factor, 39)
    ms = time_ms(torch, lambda: k6.descriptor_hist(*args, **kw), 5)
    plain_ms = time_ms(torch, lambda: k6.descriptor_plain(*args, **kw), 1, 0)
    record("K6:bf16", [outs[0]], [outs[1]], [plain], False, 1e-4, ms, plain_ms,
           2 * wpx + args[6].numel() * (6 * 4 + 128 * 4), 100 * smp,
           note=f"; {n_live} live of {args[6].numel()} lanes")
    args, kw = cap_g["K6′"]
    outs = [k6.descriptor_hist_prefix(*args, **kw) for _ in range(2)]
    live = torch.arange(args[4].numel(), device=dev) < args[6]
    plain = k6.descriptor_plain(*args[:6], live, *args[7:], **kw)
    n_live, wpx, smp = window_samples(torch, args[4], live, radius_factor, 39)
    ms = time_ms(torch, lambda: k6.descriptor_hist_prefix(*args, **kw), 5)
    plain_ms = time_ms(torch, lambda: k6.descriptor_plain(
        *args[:6], live, *args[7:], **kw), 1, 0)
    record("K6′:bf16", [outs[0]], [outs[1]], [plain], False, 1e-4, ms, plain_ms,
           2 * wpx + live.numel() * (5 * 4 + 128 * 4) + 4, 100 * smp,
           note=f" (gather16 budget, octave 0); count {n_live} of "
                f"{live.numel()} lanes")
    # K8:bf16 at every call of the bf16 perkey step (each octave and
    # bucket) against the plain version bit for bit; then on the bf16
    # step's K5 lanes, one launch per bucket, against the plain version and
    # K5:bf16 bit for bit, with both device times
    n_calls = k8_calls_check(torch, cap_p.get("K8*", []), cfg, "K8:bf16")
    k8_check(torch, record, "K8:bf16", cap["K5"][0], cfg,
             window_device_ms(torch, cap["K5"][0], cfg),
             f", bf16 step; all {n_calls} calls of the bf16 perkey step bit-exact")
    args, _ = cap_p["K7"]
    live = torch.arange(args[1].numel(), device=dev) < args[6]
    outs = [k6.descriptor_hist_perkey(*args) for _ in range(2)]
    plain = k6.descriptor_plain(*args[:6], live, *args[7:10], cfg, r_max=args[10])
    n_live, wpx, smp = window_samples(torch, args[4], live, radius_factor, args[10])
    ms = time_ms(torch, lambda: k6.descriptor_hist_perkey(*args), 5)
    plain_ms = time_ms(torch, lambda: k6.descriptor_plain(
        *args[:6], live, *args[7:10], cfg, r_max=args[10]), 1, 0)
    record("K7:bf16", [outs[0]], [outs[1]], [plain], False, 1e-4, ms, plain_ms,
           2 * wpx + live.numel() * (5 * 4 + 128 * 4) + 4, 100 * smp,
           note=f" (perkey, octave 0, scale bucket 1 of 3, r_max {args[10]}); "
                f"count {n_live} of {live.numel()} lanes")
    return k9_launches


def detection_set(res, f: int) -> set:
    """Frame f's detected (x, y, size, response) rows as bytes: what the
    split mode keeps equal to the f32 run (orientation emission may repeat
    a row another number of times, since the windows read bf16)."""
    kps = res["kps"][f][res["valid"][f]][:, [0, 1, 2, 4]].cpu().numpy()
    return {row.tobytes() for row in kps}


def matched_share(kps_a: np.ndarray, kps_b: np.ndarray, tol: float) -> float:
    """Share of the rows of kps_a matched greedily to a row of kps_b whose
    |dx| + |dy| + |dsize| is below tol (tools/check_modes.py:compare, which
    takes tol = 1e-3)."""
    used = np.zeros(len(kps_b), bool)
    n = 0
    for row in kps_a:
        d = np.abs(kps_b[:, :3] - row[:3]).sum(1) + np.where(used, 1e9, 0)
        j = int(np.argmin(d)) if len(d) else -1
        if j >= 0 and d[j] < tol:
            used[j] = True
            n += 1
    return n / max(len(kps_a), 1)


STAGES = ("create_seed_image", "octave_fused", "_detect_octave_batched",
          "_tiny_octave")


def stage_peaks(torch, extractor, run) -> dict:
    """Peak device memory (GB, everything allocated) during each stage of
    extract_batch in one run(), the peak statistics reset as each stage
    starts."""
    peaks = {}
    saved = {n: getattr(extractor, n) for n in STAGES}

    def wrap(name, fn):
        def staged(*a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            peaks[name] = max(peaks.get(name, 0.0),
                              torch.cuda.max_memory_allocated() / 1e9)
            return out
        return staged
    for name, fn in saved.items():
        setattr(extractor, name, wrap(name, fn))
    try:
        run()
    finally:
        for name, fn in saved.items():
            setattr(extractor, name, fn)
    return peaks


def storage_phase(torch, extractor, match_dense, frames, res_full, cfg, dev,
                  rows):
    """Phase 11: the storage modes on the main step (B=4 1080p)."""
    import dataclasses

    from sift_features_tpu_torch.ops.kernels import build

    cfgs = {m: dataclasses.replace(cfg, **f) for m, (f, _, _) in STORAGE.items()}
    k9_launches = check_storage_kernels(torch, extractor, frames, cfgs, cfg, dev,
                                        rows)
    torch.cuda.empty_cache()

    def step(c):
        return main_path_step(torch, extractor.extract_batch, match_dense,
                              frames, c, dev)

    step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(cfg)
    torch.cuda.synchronize()
    out = {"default_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "default_stage_peak_gb": stage_peaks(torch, extractor,
                                                lambda: step(cfg)),
           "k9_launches_per_call": k9_launches}
    results = {}
    for mode, (_, need, never) in STORAGE.items():
        mcfg = cfgs[mode]
        step(mcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        res, _, matches = step(mcfg)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if not all(launches.get(k) for k in need) or any(
                launches.get(k) for k in never):
            raise SystemExit(f"chip_smoke: {mode} storage must launch {need} "
                             f"and not {never}: {launches}")
        kps_frame = res["valid"].sum(1).tolist()
        if not np.isfinite(res["kps"][res["valid"]].cpu().numpy()).all():
            raise SystemExit(f"chip_smoke: {mode}: non-finite keypoints")
        n_kept = [int(m[2].sum()) for m in matches]
        if min(kps_frame) < N_MATCH or min(n_kept) < 1:
            raise SystemExit(f"chip_smoke: {mode}: {kps_frame} keypoints, "
                             f"{n_kept} matches kept")
        row = {"launches": launches, "kps_per_frame": kps_frame,
               "peak_mem_gb": peak_gb, "matches_kept": n_kept,
               "stage_peak_gb": stage_peaks(torch, extractor,
                                            lambda: step(mcfg))}
        if mode == "bfloat16":
            # the f32 keypoints this mode finds again by position: to 1e-3
            # px as tools/check_modes.py, and to half a pixel
            share = {tol: [matched_share(
                res_full["kps"][f][res_full["valid"][f]].cpu().numpy(),
                res["kps"][f][res["valid"][f]].cpu().numpy(), tol)
                for f in range(B)] for tol in (1e-3, 0.5)}
            row["f32_kps_matched_by_position"] = {str(t): v for t, v in share.items()}
            note = "; ".join(f"f32 keypoints matched within {t:g} px "
                             f"{[round(v, 4) for v in vs]}"
                             for t, vs in share.items())
            note += f" (f32 kps/frame {res_full['valid'].sum(1).tolist()})"
        else:
            for key in ("n_candidates", "n_survivors"):
                if not torch.equal(res[key], res_full[key]):
                    raise SystemExit(f"chip_smoke: {mode}: {key} differs from "
                                     f"the f32 step")
            for f in range(B):
                if detection_set(res, f) != detection_set(res_full, f):
                    raise SystemExit(f"chip_smoke: {mode}: frame {f}'s "
                                     f"detection set differs from the f32 step")
            note = ("n_candidates, n_survivors and every frame's (x, y, size, "
                    "response) set equal to the f32 step's")
        # 5 steps of the mode, each after one default step
        step_s, base_s = [], []
        for _ in range(5):
            for c, acc in ((cfg, base_s), (mcfg, step_s)):
                t0 = time.perf_counter()
                step(c)
                torch.cuda.synchronize()
                acc.append(time.perf_counter() - t0)
        row.update({"median_step_ms": statistics.median(step_s) * 1e3,
                    "step_ms": [t * 1e3 for t in step_s],
                    "default_median_step_ms_interleaved":
                        statistics.median(base_s) * 1e3,
                    "default_step_ms_interleaved": [t * 1e3 for t in base_s]})
        row["profiled_step_kernel_ms"] = profile_step(
            torch, lambda: step(mcfg), row["median_step_ms"], f"{mode}-profile", top=6)
        print(f"[storage] {mode}: {note}; kps/frame {kps_frame}; median "
              f"{row['median_step_ms']:.1f} ms of 5 steps against "
              f"{row['default_median_step_ms_interleaved']:.1f} ms for the "
              f"default steps between them; peak {peak_gb:.3f} GB (default "
              f"{out['default_peak_mem_gb']:.3f} GB), by stage "
              f"{ {k: round(v, 3) for k, v in row['stage_peak_gb'].items()} } "
              f"(default {out['default_stage_peak_gb']}); launches {launches}",
              flush=True)
        out[mode] = row
        results[mode] = res
        del matches

    # bf16 storage with window_kernel="perkey": K8 and K7 on bf16 levels,
    # byte-identical to the packed bf16 step
    build.reset_launches()
    rp = extractor.extract_batch(frames, dataclasses.replace(
        cfgs["bfloat16"], window_kernel="perkey"), device=dev)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if not launches.get("K8:bf16") or not launches.get("K7:bf16") or any(
            launches.get(k) for k in ("K5:bf16", "K6:bf16", "K8", "K7")):
        raise SystemExit(f"chip_smoke: bf16 perkey must launch K8:bf16 and "
                         f"K7:bf16 only: {launches}")
    for key in rp:
        if not torch.equal(rp[key], results["bfloat16"][key]):
            raise SystemExit(f"chip_smoke: bf16 perkey differs from the bf16 "
                             f"step in {key}")
    out["bfloat16_perkey"] = {"launches": launches}
    print(f"[storage] bfloat16 + perkey: byte-identical to the bfloat16 step; "
          f"launches {launches}", flush=True)

    # the gather16 budget step: K6′ on the bf16 copy
    extractor.extract_batch(frames, cfgs["gather16"], features_limit=BUDGET,
                            device=dev)
    torch.cuda.synchronize()
    build.reset_launches()
    rb = extractor.extract_batch(frames, cfgs["gather16"], features_limit=BUDGET,
                                 device=dev)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if not launches.get("K6′:bf16") or any(
            launches.get(k) for k in ("K6", "K6:bf16", "K6′")):
        raise SystemExit(f"chip_smoke: gather16 budget must launch K6′:bf16 "
                         f"and not K6 / K6′: {launches}")
    want = extractor._truncate_result(results["gather16"], BUDGET)
    for key in want:
        if not torch.equal(rb[key], want[key]):
            raise SystemExit(f"chip_smoke: gather16 budget differs from the "
                             f"truncated gather16 output in {key}")
    out["gather16_budget"] = {"launches": launches}
    print(f"[storage] gather16 budget: byte-identical to _truncate_result of "
          f"the gather16 output; launches {launches}", flush=True)
    del results, rp, rb, want
    torch.cuda.empty_cache()

    # card against CPU on the small image, phase 8's bar
    img = small_image(torch)[None]
    for mode, mcfg in cfgs.items():
        rc = extractor.extract_batch(img, mcfg, device=dev)
        rh = extractor.extract_batch(img, mcfg, device="cpu")
        for key in ("n_candidates", "n_survivors", "n_emitted", "valid"):
            if not torch.equal(rc[key].cpu(), rh[key]):
                raise SystemExit(f"chip_smoke: {mode}: card and CPU differ in "
                                 f"{key}")
        v = rh["valid"]
        kp_err = float((rc["kps"].cpu()[v] - rh["kps"][v]).abs().max())
        rows_eq = float((rc["desc"].cpu()[v] == rh["desc"][v]).all(1).float().mean())
        print(f"[storage] {mode} card-vs-cpu {SMALL[0]}x{SMALL[1]}: "
              f"{int(v.sum())} keypoints, identical sets, max field diff "
              f"{kp_err:.3g}, descriptor rows byte-equal {rows_eq:.4f}",
              flush=True)
        if int(v.sum()) < 50 or kp_err > 1e-3 or rows_eq < 0.99:
            raise SystemExit(f"chip_smoke: {mode}: card and CPU disagree")
        out[mode]["card_vs_cpu"] = {"keypoints": int(v.sum()),
                                    "max_field_diff": kp_err,
                                    "desc_rows_equal": rows_eq}
    print(json.dumps({"storage": out}, ensure_ascii=False), flush=True)
    return out


SERVICE_FRAMES = 256


def service_frames(start: int, n: int, h: int = H, w: int = W) -> np.ndarray:
    """Frames start .. start + n - 1 of the service phase, each its own
    texture: bench.py's recipe with RandomState(f) for frame f (frame 0 is
    the main path's frame 0), so rows differ across frames."""
    out = []
    for f in range(start, start + n):
        base = (np.random.RandomState(f).rand(600, 800) * 255).astype(np.uint8)
        out.append(np.tile(base, (-(-h // 600), -(-w // 800)))[:h, :w])
    return np.stack(out)


def self_match_check(db, f: int, desc, r, what: str) -> int:
    """A query of frame f's own descriptors `desc`: every retained match
    lies in frame f at distance 0, and its keypoint index points to a row
    of frame f byte-equal to the query row (a frame may hold a row twice:
    its texture repeats). Returns the number of retained matches."""
    if len(r.query_idx) == 0:
        raise SystemExit(f"chip_smoke: service: {what} retained no match")
    if not ((r.frame_id == db.frame_ids[f]).all() and (r.distance == 0).all()):
        raise SystemExit(f"chip_smoke: service: {what} matched outside frame "
                         f"{f} or at a distance above 0")
    rows = db.frame(f)[1][r.keypoint_idx]
    if not np.array_equal(rows, np.asarray(desc)[r.query_idx]):
        raise SystemExit(f"chip_smoke: service: {what}: a matched row differs "
                         f"from its query row")
    return len(r.query_idx)


def int8_queries(torch, query, want, base_gb: float, reps: int = 3) -> dict:
    """reps calls of query() with SIFT_INT8_MATCH=1 (set around them only),
    each held equal to `want` (a QueryResult or Matches); their times and
    the peak device memory above the allocations before them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    saved = os.environ.get("SIFT_INT8_MATCH")
    os.environ["SIFT_INT8_MATCH"] = "1"
    try:
        for _ in range(reps):
            t0 = time.perf_counter()
            got = query()
            ms.append((time.perf_counter() - t0) * 1e3)
            for f, a in vars(want).items():
                b = getattr(got, f)
                if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                    raise SystemExit(f"chip_smoke: int8 matcher: {f} differs "
                                     f"from the f64 path's")
    finally:
        if saved is None:
            del os.environ["SIFT_INT8_MATCH"]
        else:
            os.environ["SIFT_INT8_MATCH"] = saved
    return {"ms": ms, "median_ms": statistics.median(ms),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "mem_before_gb": base_gb}


def m1_phase(torch, train_rows, query_rows, dev, n_query=M1_QUERY_ROWS):
    """M1, the matcher kernel, against the chunk loop (kernel_route forced
    False) on u8 rows on the card, at two shapes: the service's query (a
    new frame's rows against the whole index) and n_query rows (the index
    cell's, the new frame's repeated) against a map of the index's rows and
    as many seeded random rows again. Gated: best_train, distance and keep
    bit-equal with and without the cross-check, each match_dense call
    launching M1 once and nothing else (counts reset at the phase's start).
    Not gated: M1's launch time (CUDA events, mean of 3), the loop's, two
    bounds and the f64 GEMM alone over the same rows in the loop's chunks
    (the library yardstick). The bounds: the pairs' f64 work (2 x 128
    operations a pair) and the packed products M1 runs (two query rows
    to an operand: half of it), each against the f64 tensor rate, or bytes
    if more; M1's share is read against the packed one.
    Returns (M1's row at the second shape for the kernels line, with both
    shapes' numbers under "shapes"; the launch counts of the gated calls)."""
    from sift_features_tpu_torch.ops import matcher
    from sift_features_tpu_torch.ops.kernels import build
    from sift_features_tpu_torch.ops.kernels import matcher as kmatcher

    def loop(tr, qu, cc=True):
        saved = matcher.kernel_route
        matcher.kernel_route = lambda *a: False
        try:
            return matcher.match_dense(tr, qu, cc)
        finally:
            matcher.kernel_route = saved

    def gemm(tr, qu):
        b = qu.double()
        step = max(1, matcher.TEMP_BYTES // (8 * qu.shape[0]))
        for t0 in range(0, tr.shape[0], step):
            torch.matmul(b, tr[t0:t0 + step].double().T)

    train = torch.as_tensor(train_rows, device=dev)
    query = torch.as_tensor(query_rows, device=dev)
    rng = np.random.RandomState(16)
    big = torch.cat([train, torch.as_tensor(
        rng.randint(0, 256, train.shape, dtype=np.uint8), device=dev)])
    shapes = {"service": (train, query),
              f"{n_query} x map": (big, query.repeat(
                  -(-n_query // query.shape[0]), 1)[:n_query])}
    build.reset_launches()
    n_calls, kept = 0, {}
    for what, (tr, qu) in shapes.items():
        for cc in (True, False):
            got = matcher.match_dense(tr, qu, cc)
            torch.cuda.synchronize()
            n_calls += 1
            if build.LAUNCHES != {"M1": n_calls}:
                raise SystemExit(f"chip_smoke: M1: {n_calls} match_dense calls "
                                 f"on u8 rows launched {build.LAUNCHES}")
            want = loop(tr, qu, cc)
            for name, a, b in zip(("best_train", "distance", "keep"), got, want):
                if a.dtype != b.dtype or not torch.equal(a, b):
                    raise SystemExit(f"chip_smoke: M1 differs from the chunk "
                                     f"loop in {name} at {what} "
                                     f"(cross_check={cc})")
            if cc:
                kept[what] = int(got[2].sum())
    launches = dict(build.LAUNCHES)
    out = {}
    for what, (tr, qu) in shapes.items():
        n_t, n_q = tr.shape[0], qu.shape[0]
        ops = 2.0 * tr.shape[1] * n_q * n_t
        nbytes = tr.shape[1] * (n_t + n_q) + 8 * (n_t + n_q)
        t_pairs = ops / H100_F64_TENSOR_PER_S * 1e3
        t_o = ops * (-(-n_q // 2) / n_q) / H100_F64_TENSOR_PER_S * 1e3
        t_b = nbytes / H100_BYTES_PER_S * 1e3
        ms = time_ms(torch, lambda: kmatcher.match_keys(tr, qu), 3)
        plain_ms = time_ms(torch, lambda: loop(tr, qu), 1, 0)
        lib_ms = time_ms(torch, lambda: gemm(tr, qu), 1)
        r = out[what] = {
            "query_rows": n_q, "train_rows": n_t, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_o, t_b), "pairs_bound_ms": max(t_pairs, t_b),
            "bound_by": ("packed f64 tensor products" if t_o >= t_b
                         else "bytes"),
            "gpairs_per_s": n_q * n_t / ms / 1e6, "kept": kept[what]}
        print(f"[M1] {what}: {n_q} x {n_t} u8 rows: best_train, distance, keep "
              f"bit-equal to the chunk loop with and without the cross-check, "
              f"one launch a call; {ms:.1f} ms a launch "
              f"({r['gpairs_per_s']:.1f} Gpairs/s, {r['bound_ms'] / ms:.1%} of "
              f"the bound {r['bound_ms']:.1f} ms, {r['bound_by']}, which M1's "
              f"share reads against; the pairs' f64 work "
              f"{r['pairs_bound_ms']:.1f} ms), loop "
              f"{plain_ms:.1f} ms, f64 GEMM alone {lib_ms:.1f} ms; "
              f"{kept[what]} kept", flush=True)
    row = {k: v for k, v in out[what].items()
           if k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    row.update(max_abs_err=0.0, device_ms=None, shapes=out)
    return row, launches


def service_phase(torch, extractor, dev, smi: str) -> dict:
    """The descriptor-database service at full width: an index of 256
    1080p frames built by 64 add_frames calls at the main path's B=4 (the
    main path's kernels launched), queries of a new frame's descriptors
    against all of it (median of 3, distances/s, peak memory), the
    self-queries of frames 0 (through query_image), 127 and 255, the
    chunked matcher against its one-chunk form on the first 8 frames, M1
    against the chunk loop (m1_phase), and save / load byte-equal."""
    import tempfile

    from sift_features_tpu_torch.io.database import DescriptorDB
    from sift_features_tpu_torch.ops import matcher
    from sift_features_tpu_torch.ops.kernels import build
    from sift_features_tpu_torch.service import DescriptorIndex

    t_phase = time.perf_counter()
    idx = DescriptorIndex(device=dev)
    add_ms = []
    for i in range(SERVICE_FRAMES // B):
        batch = service_frames(B * i, B)
        torch.cuda.synchronize()
        if i == 0:
            build.reset_launches()
        t0 = time.perf_counter()
        idx.add_frames(batch)
        add_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = dict(build.LAUNCHES)
            missing = [k for k in WRAPPERS if not launches.get(k)]
            if missing:
                raise SystemExit(f"chip_smoke: service: add_frames launched no "
                                 f"{missing}: {launches}")
    db = idx.db
    n_rows = int(db.offsets[-1])
    db_bytes = db.descriptors.nbytes + db.keypoints.nbytes + db.offsets.nbytes \
        + db.frame_ids.nbytes
    if len(db.frame_ids) != SERVICE_FRAMES or np.diff(db.offsets).min() < N_MATCH:
        raise SystemExit(f"chip_smoke: service: {len(db.frame_ids)} frames, "
                         f"rows per frame {np.diff(db.offsets).tolist()}")

    # a new frame's descriptors against the whole index
    _, desc_new = extractor.extract(service_frames(SERVICE_FRAMES, 1)[0], device=dev)
    idx.query(desc_new[:8])        # descriptors to the card, cached
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    q_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        r_new = idx.query(desc_new)
        q_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    q_med = statistics.median(q_ms)
    if not len(r_new.query_idx) or not np.isfinite(r_new.distance).all():
        raise SystemExit("chip_smoke: service: the new frame's query failed")
    # the same query on the int8 path (SIFT_INT8_MATCH=1 around these
    # calls only): equal to the f64 path's, timed and its peak taken alike
    int8 = int8_queries(torch, lambda: idx.query(desc_new), r_new, base_gb)
    # M1 against the chunk loop on the index's rows
    m1_row, m1_launches = m1_phase(torch, db.descriptors, desc_new, dev)

    # self-queries: frame 0 through query_image, frames 127 and 255
    kps0, desc0, r0 = idx.query_image(service_frames(0, 1)[0])
    k_ref, d_ref = extractor.extract(service_frames(0, 1)[0], device=dev)
    if not (np.array_equal(kps0, k_ref) and np.array_equal(desc0, d_ref)):
        raise SystemExit("chip_smoke: service: query_image's keypoints or "
                         "descriptors differ from extract's")
    kept = {0: self_match_check(db, 0, desc0, r0, "query_image of frame 0")}
    for f in (SERVICE_FRAMES // 2 - 1, SERVICE_FRAMES - 1):
        desc_f = db.frame(f)[1]
        kept[f] = self_match_check(db, f, desc_f, idx.query(desc_f),
                                   f"the query of frame {f}")

    # the chunked matcher against its one-chunk form, frame 0 against the
    # first 8 frames (small enough for one chunk)
    train8 = torch.as_tensor(db.descriptors[:db.offsets[8]], device=dev).float()
    q0 = torch.as_tensor(db.frame(0)[1], device=dev).float()
    chunked = matcher.match_dense(train8, q0)
    n_chunks = -(-train8.shape[0] // max(1, matcher.TEMP_BYTES // (8 * q0.shape[0])))
    saved_bytes = matcher.TEMP_BYTES
    matcher.TEMP_BYTES = 8 * q0.shape[0] * train8.shape[0]
    try:
        whole = matcher.match_dense(train8, q0)
    finally:
        matcher.TEMP_BYTES = saved_bytes
    if n_chunks < 2 or not all(torch.equal(a, b) for a, b in zip(chunked, whole)):
        raise SystemExit(f"chip_smoke: service: the chunked matcher ({n_chunks} "
                         f"chunks) differs from its one-chunk form")
    del train8, q0, chunked, whole

    # save and load
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        idx.save(tmp, n_shards=4)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = DescriptorIndex.load(tmp, device=dev)
        load_s = time.perf_counter() - t0
        for f in ("frame_ids", "offsets", "keypoints", "descriptors"):
            a, b = getattr(back.db, f), getattr(db, f)
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise SystemExit(f"chip_smoke: service: save / load changed {f}")
    out = {"frames": SERVICE_FRAMES, "add_frames_calls": len(add_ms),
           "add_frames_median_ms": statistics.median(add_ms),
           "add_frames_ms": add_ms, "rows": n_rows, "db_bytes": db_bytes,
           "query_rows": int(len(desc_new)), "query_ms": q_ms,
           "query_median_ms": q_med,
           "distances_per_s": len(desc_new) * n_rows / (q_med / 1e3),
           "query_peak_mem_gb": peak_gb, "mem_before_query_gb": base_gb,
           "int8_query_ms": int8["ms"], "int8_query_median_ms": int8["median_ms"],
           "int8_query_peak_mem_gb": int8["peak_gb"],
           "new_frame_matches_kept": int(len(r_new.query_idx)),
           "self_matches_kept": kept, "chunks_on_8_frames": n_chunks,
           "save_s": save_s, "load_s": load_s,
           "launches_in_first_add_frames": launches,
           "m1": m1_row, "m1_launches": m1_launches,
           "phase_s": time.perf_counter() - t_phase, "card": smi}
    print(f"[service] {SERVICE_FRAMES} frames in {len(add_ms)} add_frames calls "
          f"of B={B}: median {out['add_frames_median_ms']:.1f} ms a call; {n_rows} "
          f"rows, {db_bytes / 1e6:.1f} MB; query of {len(desc_new)} rows: median "
          f"{q_med:.1f} ms of 3 ({out['distances_per_s']:.3e} distances/s), peak "
          f"{peak_gb:.3f} GB ({base_gb:.3f} before); int8 (SIFT_INT8_MATCH=1) "
          f"equal, median {int8['median_ms']:.1f} ms of 3, peak "
          f"{int8['peak_gb']:.3f} GB; self-queries of frames "
          f"{list(kept)} (0 by query_image) kept {list(kept.values())} matches, all in "
          f"their frame at distance 0; chunked matcher equal to one chunk on 8 "
          f"frames ({n_chunks} chunks); save {save_s:.1f} s, load {load_s:.1f} s "
          f"byte-equal; {smi}", flush=True)
    print(json.dumps({"service": out}), flush=True)
    return out


STREAM_FRAMES = 62     # not a multiple of B: the last batch is ragged


def jpeg_header() -> tuple[bool, str]:
    """Whether g++ finds libjpeg's header, which both native sources
    include; (False, why) when it does not."""
    try:
        out = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                             input="#include <jpeglib.h>\n", text=True,
                             capture_output=True, timeout=60)
    except OSError as e:
        return False, f"g++ did not run: {e}"
    if out.returncode != 0:
        return False, "g++ finds no jpeglib.h: " + out.stderr.strip()[-300:]
    return True, ""


class PinnedRotation:
    """Frames from memory through the decode pool's buffer contract, for a
    card without the native tier: n rotating pinned buffers, each
    rewritten only once the event after its last H2D copy has completed
    (the stream reports it through copy_done)."""

    def __init__(self, torch, frames, batches, n_buffers: int):
        self.frames, self.batches = frames, batches
        self.bufs = [torch.empty((B,) + frames.shape[1:], dtype=torch.uint8,
                                 pin_memory=True).numpy()
                     for _ in range(n_buffers)]
        self.events = [None] * n_buffers
        self.slot = 0

    def copy_done(self, event) -> None:
        self.events[self.slot] = event

    def __iter__(self):
        for i, s in enumerate(self.batches):
            self.slot = i % len(self.bufs)
            if self.events[self.slot] is not None:
                self.events[self.slot].synchronize()
            n = s.stop - s.start
            self.bufs[self.slot][:n] = self.frames[s]
            yield self.bufs[self.slot][:n]


def same_pairs(got: list, want: list, what: str) -> int:
    """Every frame's (kps, desc) byte-identical; returns the keypoints."""
    if len(got) != len(want):
        raise SystemExit(f"chip_smoke: stream: {what}: {len(got)} frames, "
                         f"{len(want)} expected")
    for f, ((k, d), (wk, wd)) in enumerate(zip(got, want)):
        if not (k.dtype == wk.dtype and d.dtype == wd.dtype
                and k.tobytes() == wk.tobytes() and d.tobytes() == wd.tobytes()):
            raise SystemExit(f"chip_smoke: stream: {what}: frame {f} differs "
                             f"from extract_batch ({len(k)} / {len(wk)} rows)")
    return sum(len(k) for k, _ in got)


def stream_phase(torch, extractor, cfg, dev, smi: str) -> dict:
    """The I/O tier and the streaming executor on 62 1080p frames (the
    service phase's textures) at B=4: JPEGs written with the native
    encoder (quality 92); the decode pool's frames byte-equal to
    decode_gray's; stream_extract_paths (depth 2) byte-identical to
    extract_batch on the decoded batches, with and without features_limit,
    launching the main path's kernels. Then, not gated, interleaved twice:
    frames/s of the decode pool alone, of the stream, of an extract_batch
    loop over the decoded frames and of a serial decode -> extract loop
    (each loop ends in per-frame pairs, as the stream does); then one
    instrumented stream run: the share of its window the card spends
    inside a batch's work (CUDA events around each extract_batch call),
    the host time in extract_batch and in the readback waits, and peak
    device memory. Every stream compacts its results per frame (the
    default compact=True), as the loops do, through the stream's own
    compact_frames. Without libjpeg's header the frames stream from memory
    through rotating pinned buffers (PinnedRotation) and the JPEG parts are
    left out."""
    import tempfile

    from sift_features_tpu_torch.ops.kernels import build
    from sift_features_tpu_torch.parallel import stream as st

    t_phase = time.perf_counter()
    frames = service_frames(0, STREAM_FRAMES)
    native, reason = jpeg_header()
    out = {"frames": STREAM_FRAMES, "batch": B, "depth": 2,
           "native_tier": native, "card": smi}
    if not native:
        print(f"[stream] native tier not built: {reason}", flush=True)
        out["native_tier_reason"] = reason
    batches = [slice(lo, min(lo + B, STREAM_FRAMES))
               for lo in range(0, STREAM_FRAMES, B)]
    with tempfile.TemporaryDirectory() as tmp:
        paths = [f"{tmp}/f{i:03d}.jpg" for i in range(STREAM_FRAMES)]
        if native:
            from sift_features_tpu_torch.io.native_loader import (BatchLoader,
                                                                  decode_gray)
            from sift_features_tpu_torch.io.native_output import write_jpeg

            t0 = time.perf_counter()
            for p, img in zip(paths, frames):
                write_jpeg(p, img, quality=92)
            out["jpeg_write_s"] = time.perf_counter() - t0
            out["jpeg_mb"] = sum(os.path.getsize(p) for p in paths) / 1e6
            decoded = np.stack([decode_gray(p) for p in paths])
            if decoded.shape != frames.shape:
                raise SystemExit(f"chip_smoke: stream: decoded {decoded.shape}")
            loader = BatchLoader(paths, B, (H, W), n_threads=4)
            try:
                got = np.concatenate([b.copy() for b in loader])
            finally:
                loader.close()
            if got.tobytes() != decoded.tobytes():
                raise SystemExit("chip_smoke: stream: BatchLoader's frames "
                                 "differ from decode_gray's")
        else:
            decoded = frames

        def run_stream(limit=None):
            if native:
                res = st.stream_extract_paths(paths, B, (H, W), cfg, limit,
                                              depth=2, device=dev)
                return [p for batch in res for p in batch]
            rot = PinnedRotation(torch, decoded, batches, n_buffers=4)
            res = st.stream_extract(rot, cfg, limit, depth=2,
                                    producer_rotates=True, device=dev,
                                    copy_done=rot.copy_done)
            return [p for batch in res for p in batch]

        def run_loop(limit=None, serial=False):
            pairs = []
            for s in batches:
                imgs = (np.stack([decode_gray(p) for p in paths[s]]) if serial
                        else decoded[s])
                res = extractor.extract_batch(imgs, cfg, limit, device=dev)
                host = {k: v.cpu().numpy() for k, v in res.items()}
                pairs += st.compact_frames(host)
            return pairs

        def run_pool():
            loader = BatchLoader(paths, B, (H, W), n_threads=4)
            try:
                return sum(len(b) for b in loader)
            finally:
                loader.close()

        # gated: the stream against the extract_batch loop, launches counted
        # over the stream's run alone; the budget likewise
        torch.cuda.synchronize()
        build.reset_launches()
        streamed = run_stream()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        missing = [k for k in WRAPPERS if not launches.get(k)]
        if missing or launches.get("K4"):
            raise SystemExit(f"chip_smoke: stream: launches {launches}")
        out["kps_total"] = same_pairs(streamed, run_loop(), "the stream")
        build.reset_launches()
        streamed = run_stream(BUDGET)
        torch.cuda.synchronize()
        launches_b = dict(build.LAUNCHES)
        if not launches_b.get("K6′") or launches_b.get("K6"):
            raise SystemExit(f"chip_smoke: stream: budget launches {launches_b}")
        same_pairs(streamed, run_loop(BUDGET), f"features_limit={BUDGET}")
        del streamed
        out["launches"], out["launches_budget"] = launches, launches_b

        # not gated: frames/s of each loop, interleaved twice
        loops = {"stream": run_stream, "extract_batch_loop": run_loop}
        if native:
            loops = {"decode_pool": run_pool, **loops,
                     "serial_decode_extract": lambda: run_loop(serial=True)}
        fps = {k: [] for k in loops}
        for _ in range(2):
            for k, fn in loops.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                fps[k].append(STREAM_FRAMES / (time.perf_counter() - t0))
        out["frames_per_s"] = fps

        # one instrumented stream run: batch spans by CUDA events, host time
        # in extract_batch and in the readback waits (_fetch), peak memory
        spans, host_s = [], {"extract_batch": 0.0, "fetch": 0.0}
        real_extract, real_fetch = extractor.extract_batch, st._fetch

        def timed_extract(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            res = real_extract(*a, **kw)
            e1.record()
            host_s["extract_batch"] += time.perf_counter() - t0
            spans.append((e0, e1))
            return res

        def timed_fetch(*a, **kw):
            t0 = time.perf_counter()
            res = real_fetch(*a, **kw)
            host_s["fetch"] += time.perf_counter() - t0
            return res

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        extractor.extract_batch, st._fetch = timed_extract, timed_fetch
        try:
            t0 = time.perf_counter()
            run_stream()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        finally:
            extractor.extract_batch, st._fetch = real_extract, real_fetch
    busy_ms = sum(a.elapsed_time(b) for a, b in spans)
    window_ms = spans[0][0].elapsed_time(spans[-1][1])
    out.update({"batch_span_share": busy_ms / window_ms,
                "batch_span_ms": busy_ms, "window_ms": window_ms,
                "instrumented_wall_s": wall_s,
                "host_s_in_extract_batch": host_s["extract_batch"],
                "host_s_in_fetch": host_s["fetch"],
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "phase_s": time.perf_counter() - t_phase})
    rounds = "; ".join(f"{k} {' / '.join(f'{v:.2f}' for v in vs)}"
                       for k, vs in fps.items())
    print(f"[stream] {STREAM_FRAMES} {H}x{W} frames at B={B}, depth 2"
          f"{', JPEG q92' if native else ', from memory via 4 pinned buffers'}"
          f": every frame "
          f"byte-identical to extract_batch, with and without features_limit"
          f"={BUDGET}; frames/s (rounds 1 / 2): {rounds}; {smi}", flush=True)
    print(f"[stream] one instrumented stream: the card inside a batch's work "
          f"{out['batch_span_share']:.3f} of the window ({busy_ms:.1f} of "
          f"{window_ms:.1f} ms, CUDA events around each extract_batch call); "
          f"host in extract_batch {host_s['extract_batch']:.2f} s, in _fetch "
          f"(readback waits, compaction) "
          f"{host_s['fetch']:.3f} s, of "
          f"{wall_s:.2f} s; peak device memory {out['peak_mem_gb']:.3f} GB; "
          f"{smi}", flush=True)
    print(json.dumps({"stream": out}, ensure_ascii=False), flush=True)
    return out


DIST_RANKS = 2          # the ranks phase 14 (b) starts on the one card


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_step(torch, got: dict, want: dict, what: str) -> int:
    """An extract_match_step result against extract_batch's on the same
    frames (want; its src_idx aside) and the tagged dense reference on the
    card (ring.match_tagged_dense): byte-equal. Returns the kept matches."""
    from sift_features_tpu_torch.parallel import pipeline, ring

    if set(got) != set(pipeline.OUTPUT_KEYS):
        raise SystemExit(f"chip_smoke: dist: {what}: keys {sorted(got)}")
    for k in pipeline.OUTPUT_KEYS[:6]:
        if not torch.equal(got[k], want[k]):
            raise SystemExit(f"chip_smoke: dist: {what}: {k} differs from "
                             f"extract_batch")
    _, q, qv, qt, t, tv, tt = pipeline.queries_and_database(
        got, 0, got["query_idx"].shape[1])
    ref = ring.match_tagged_dense(t, tv, tt, q, qv, qt)
    for k, r in zip(("match_train", "match_dist", "match_keep"), ref):
        if not torch.equal(got[k].reshape(-1), r):
            raise SystemExit(f"chip_smoke: dist: {what}: {k} differs from the "
                             f"tagged dense reference")
    kept = int(got["match_keep"].sum())
    if kept < got["match_keep"].shape[0]:
        raise SystemExit(f"chip_smoke: dist: {what}: only {kept} matches kept")
    return kept


def canon_rows(kps, desc, valid) -> np.ndarray:
    """A frame's valid rows [kps | desc], sorted: its keypoint set."""
    comb = np.concatenate([kps[valid], desc[valid].astype(np.float32)], 1)
    return comb[np.lexsort(comb.T[::-1])]


def check_matches_dense(torch, got: dict, what: str) -> int:
    """A step's matches (numpy) byte-equal to the tagged dense reference on
    the card, run on the step's own queries and rows. Returns the kept
    matches."""
    from sift_features_tpu_torch.parallel import pipeline, ring

    t = {k: torch.from_numpy(got[k]).cuda() for k in ("kps", "desc", "valid")}
    _, q, qv, qt, tr, tv, tt = pipeline.queries_and_database(
        t, 0, got["query_idx"].shape[1])
    for k, r in zip(("match_train", "match_dist", "match_keep"),
                    ring.match_tagged_dense(tr, tv, tt, q, qv, qt)):
        if got[k].reshape(-1).tobytes() != r.cpu().numpy().tobytes():
            raise SystemExit(f"chip_smoke: dist (d): {what}: {k} differs from "
                             f"the tagged dense reference")
    return int(got["match_keep"].sum())


def check_spatial(torch, got: dict, z) -> int:
    """Phase 14 (d): the spatial extract_match_step result (numpy) against
    the split path's rows (z["split_*"]: the plain reflect-101 blur chain,
    which the halo blurs compute): per frame the same keypoint set byte for
    byte and the same counters; against the one-rank step (z["step_*"],
    whose K1 blurs the padded plane) the same count of keypoints a frame,
    phase 7's rule; the matches byte-equal to the tagged dense reference.
    Returns the kept matches."""
    for f in range(got["valid"].shape[0]):
        a = canon_rows(got["kps"][f], got["desc"][f], got["valid"][f])
        b = canon_rows(z["split_kps"][f], z["split_desc"][f],
                       z["split_valid"][f])
        if a.shape != b.shape or a.tobytes() != b.tobytes():
            raise SystemExit(f"chip_smoke: dist (d): frame {f}: {len(a)} rows, "
                             f"not the split path's {len(b)}")
    for k in ("n_candidates", "n_survivors", "n_emitted"):
        if not np.array_equal(got[k], z[f"split_{k}"]):
            raise SystemExit(f"chip_smoke: dist (d): {k} differs from the "
                             f"split path's")
    n_got, n_one = got["valid"].sum(1), z["step_valid"].sum(1)
    if not np.array_equal(n_got, n_one):
        raise SystemExit(f"chip_smoke: dist (d): keypoints a frame "
                         f"{n_got.tolist()}, the one-rank step {n_one.tolist()}")
    return check_matches_dense(torch, got, "spatial step")


def check_spatial_budget(full: dict, lim: dict, limit: int) -> None:
    """The spatial budget against the unbudgeted spatial step (the rule of
    tests/test_parallel.py:test_extract_match_step_budget): per frame the
    same response set as its top-`limit`, each kept row's keypoint and
    descriptor bytes those of its row there, the same counters."""
    if lim["kps"].shape[1] != min(limit, full["kps"].shape[1]):
        raise SystemExit(f"chip_smoke: dist (d): budget rows {lim['kps'].shape}")
    for k in ("n_candidates", "n_survivors", "n_emitted"):
        if not np.array_equal(lim[k], full[k]):
            raise SystemExit(f"chip_smoke: dist (d): budget {k} differs")
    for f in range(full["valid"].shape[0]):
        resp = np.where(full["valid"][f], full["kps"][f][:, 4], -np.inf)
        order = np.argsort(-resp, kind="stable")[:limit]
        order = order[resp[order] > -np.inf]
        kept = lim["valid"][f]
        if kept.sum() != len(order) or not np.array_equal(
                np.sort(lim["kps"][f][kept][:, 4]),
                np.sort(full["kps"][f][order][:, 4])):
            raise SystemExit(f"chip_smoke: dist (d): frame {f}: the budget's "
                             f"responses are not the top-{limit}")
        rows = {full["kps"][f][i].tobytes(): full["desc"][f][i].tobytes()
                for i in order}
        for kp, d in zip(lim["kps"][f][kept], lim["desc"][f][kept]):
            if rows.get(kp.tobytes()) != d.tobytes():
                raise SystemExit(f"chip_smoke: dist (d): frame {f}: a kept "
                                 f"row differs from its unbudgeted row")


def spatial_child(torch, z, n_oct: int, cfg) -> dict:
    """Phase 14 (d) on one rank: extract_match_step on a (data=1, space=2)
    mesh of the two ranks (octaves 0-2 of the 1080p seed row-sharded with
    halo-exchange blurs, detection by row band), first and warm without a
    limit and with features_limit=BUDGET, each checked; on the warm steps
    the launches, halo hops and bytes, bytes gathered over space and peak
    memory; then one more unbudgeted step with each gather and hop inside
    _extract_single_spatial timed (host clock, each call synchronised)."""
    from sift_features_tpu_torch.ops.kernels import build
    from sift_features_tpu_torch.parallel import extract as textract
    from sift_features_tpu_torch.parallel import halo, pipeline
    from sift_features_tpu_torch.parallel import mesh as tmesh
    from sift_features_tpu_torch.parallel.runner import barrier

    smesh = tmesh.make_mesh(1, DIST_RANKS, device="cuda")
    frames = z["frames"]
    out = {"mesh": smesh.shape, "space_rank": smesh.coords["space"]}

    def step(limit):
        got = pipeline.extract_match_step(frames, n_oct, cfg, smesh, 128, limit)
        torch.cuda.synchronize()
        return got

    runs = {}
    for limit in (None, BUDGET):
        name = "spatial" if limit is None else "spatial_budget"
        barrier(f"{name} first", 120.0)
        t0 = time.perf_counter()
        step(limit)
        first_s = time.perf_counter() - t0
        barrier(f"{name} warm", 120.0)
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        base = dict(tmesh.TRAFFIC)
        t0 = time.perf_counter()
        got = step(limit)
        warm_s = time.perf_counter() - t0
        traffic = {k: tmesh.TRAFFIC[k] - base[k] for k in base}
        got = {k: v.cpu().numpy() for k, v in got.items()}
        runs[name] = got
        out[name] = {
            "first_s": first_s, "warm_s": warm_s,
            "launches": dict(build.LAUNCHES),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "halo_hops": traffic["hops_space"],
            "halo_bytes_per_hop": (traffic["hop_bytes_space"]
                                   / max(traffic["hops_space"], 1)),
            "space_gather_bytes": traffic["gather_bytes_space"],
            "psums": traffic["reduces_space"]}
    out["kept"] = check_spatial(torch, runs["spatial"], z)
    check_spatial_budget(runs["spatial"], runs["spatial_budget"], BUDGET)
    out["kept_budget"] = check_matches_dense(
        torch, runs["spatial_budget"], f"features_limit={BUDGET}")

    timed = {"gather": [], "hop": [], "wire": []}

    def timer(fn, acc):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            acc.append(((time.perf_counter() - t0) * 1e3,
                        r.numel() * r.element_size(), list(r.shape)))
            return r
        return wrapped

    saved = textract.all_gather, halo.shift, tmesh._wire
    textract.all_gather = timer(saved[0], timed["gather"])
    halo.shift = timer(saved[1], timed["hop"])
    # _wire: the copy of what a collective sends into fresh pinned memory
    tmesh._wire = timer(saved[2], timed["wire"])
    barrier("spatial timed", 120.0)
    try:
        t0 = time.perf_counter()
        step(None)
        out["timed_step_s"] = time.perf_counter() - t0
    finally:
        textract.all_gather, halo.shift, tmesh._wire = saved
    big = sorted(timed["gather"], key=lambda e: -e[1])
    out["largest_gathers"] = [{"ms": ms, "bytes": nb, "shape": sh}
                              for ms, nb, sh in big[:4]]
    out["gather_ms_total"] = sum(e[0] for e in timed["gather"])
    out["hop_ms_total"] = sum(e[0] for e in timed["hop"])
    out["hop_ms_max"] = max((e[0] for e in timed["hop"]), default=0.0)
    out["wire_ms_total"] = sum(e[0] for e in timed["wire"])
    out["largest_wire_ms"] = max(timed["wire"], key=lambda e: e[1])[0]
    return out


def dist_child(rank: int, port: int, inputs: str, out: str) -> None:
    """One of phase 14 (b)'s ranks, both on cuda:0 over gloo: ring_match of
    the inputs' query rows against their train rows and extract_match_step
    of their frames, each against the parent's results; writes its times
    and traffic to `out`. Raises (a non-zero exit) on any difference."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from sift_features_tpu_torch.config import DEFAULT_CONFIG
    from sift_features_tpu_torch.models import extractor
    from sift_features_tpu_torch.parallel import mesh as tmesh
    from sift_features_tpu_torch.parallel import pipeline, ring
    from sift_features_tpu_torch.parallel.runner import (barrier,
                                                         init_distributed)

    init_distributed(f"127.0.0.1:{port}", DIST_RANKS, rank, device="cuda")
    try:
        z = np.load(inputs)
        mesh = tmesh.make_mesh(device="cuda")
        res = {"rank": rank, "backend": dist.get_backend(),
               "device": str(mesh.device), "barrier_s": barrier("start", 120.0)}
        ring.ring_match(z["train"][:64], z["query"][:64], mesh)  # warm
        torch.cuda.synchronize()
        base = dict(tmesh.TRAFFIC)
        t0 = time.perf_counter()
        qi, ti, d = ring.ring_match(z["train"], z["query"], mesh)
        res["ring_s"] = time.perf_counter() - t0
        hops = tmesh.TRAFFIC["hops"] - base["hops"]
        res["ring_hops"] = hops
        res["ring_bytes_per_hop"] = (tmesh.TRAFFIC["hop_bytes"]
                                     - base["hop_bytes"]) / max(hops, 1)
        for name, a in (("query_idx", qi), ("train_idx", ti), ("distance", d)):
            w = z[f"ring_{name}"]
            if a.dtype.kind != w.dtype.kind or not np.array_equal(a, w):
                raise SystemExit(f"rank {rank}: ring_match {name} differs from "
                                 f"match_brute_force")
        res["ring_kept"] = int(len(qi))
        frames = z["frames"]
        n_oct = extractor._n_octaves(*frames.shape[1:], DEFAULT_CONFIG)
        steps = []
        for _ in range(2):
            barrier("step", 120.0)
            base = dict(tmesh.TRAFFIC)
            t0 = time.perf_counter()
            got = pipeline.extract_match_step(frames, n_oct, DEFAULT_CONFIG,
                                              mesh, 128)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        res["step_s"] = steps
        hops = tmesh.TRAFFIC["hops"] - base["hops"]
        res["step_hops"] = hops
        res["step_bytes_per_hop"] = (tmesh.TRAFFIC["hop_bytes"]
                                     - base["hop_bytes"]) / max(hops, 1)
        res["step_gather_bytes"] = (tmesh.TRAFFIC["gather_bytes"]
                                    - base["gather_bytes"])
        for k in pipeline.OUTPUT_KEYS:
            a, w = got[k].cpu().numpy(), z[f"step_{k}"]
            if a.dtype != w.dtype or a.tobytes() != w.tobytes():
                raise SystemExit(f"rank {rank}: extract_match_step {k} differs "
                                 f"from the one-rank step's")
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["spatial"] = spatial_child(torch, z, n_oct, DEFAULT_CONFIG)
        with open(out, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def spatial_summary(ranks: list, n_oct: int, cfg) -> dict:
    """Phase 14 (d)'s figures over the ranks (the slowest rank's times, the
    largest peak), with its launch gate: on each rank K2′ never launched,
    and K3, K5′ and K6′ at least once per row-sharded octave and frame."""
    from sift_features_tpu_torch.parallel.extract import shards_rows

    hh = H * cfg.inv_delta_min
    sharded = [o for o in range(n_oct)
               if shards_rows(hh >> o, DIST_RANKS, cfg)]
    floor = len(sharded) * B
    sp = [r["spatial"] for r in ranks]
    for r in sp:
        la = r["spatial"]["launches"]
        if la.get("K2′") or any(la.get(k, 0) < floor
                                for k in ("K3", "K5′", "K6′")):
            raise SystemExit(f"chip_smoke: dist (d): spatial launches {la}, "
                             f"want K2′ 0 and K3, K5′, K6′ >= {floor}")
        if r["spatial_budget"]["launches"].get("K2′"):
            raise SystemExit("chip_smoke: dist (d): K2′ on the budget step")
    big = sp[0]["largest_gathers"][0]
    return {
        "sharded_octaves": sharded, "launch_floor": floor,
        "launches": sp[0]["spatial"]["launches"],
        "launches_budget": sp[0]["spatial_budget"]["launches"],
        "kept": sp[0]["kept"], "kept_budget": sp[0]["kept_budget"],
        "first_ms": max(r["spatial"]["first_s"] for r in sp) * 1e3,
        "warm_ms": max(r["spatial"]["warm_s"] for r in sp) * 1e3,
        "budget_first_ms": max(r["spatial_budget"]["first_s"] for r in sp) * 1e3,
        "budget_warm_ms": max(r["spatial_budget"]["warm_s"] for r in sp) * 1e3,
        "halo_hops": sp[0]["spatial"]["halo_hops"],
        "halo_bytes_per_hop": sp[0]["spatial"]["halo_bytes_per_hop"],
        "space_gather_bytes": sp[0]["spatial"]["space_gather_bytes"],
        "largest_gather_mb": big["bytes"] / 1e6, "largest_gather_ms": big["ms"],
        "timed_step_ms": sp[0]["timed_step_s"] * 1e3,
        "gather_ms_in_step": sp[0]["gather_ms_total"],
        "wire_ms_in_step": sp[0]["wire_ms_total"],
        "largest_wire_ms": sp[0]["largest_wire_ms"],
        "hop_ms_in_step": sp[0]["hop_ms_total"],
        "peak_mem_gb": max(r["spatial"]["peak_mem_gb"] for r in sp)}


def two_ranks_on_card(torch, inputs: dict, tmp: str) -> list:
    """Phase 14 (b): DIST_RANKS processes (start method spawn: CUDA is live
    here) on the one card over gloo, each running dist_child; every one
    must exit 0. Returns their result dicts."""
    import multiprocessing

    path = os.path.join(tmp, "dist_inputs.npz")
    np.savez(path, **inputs)
    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(DIST_RANKS)]
    procs = [ctx.Process(target=dist_child, args=(r, port, path, outs[r]))
             for r in range(DIST_RANKS)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise SystemExit(f"chip_smoke: dist: a rank on the card failed, exit "
                         f"codes {codes}")
    results = []
    for o in outs:
        with open(o) as f:
            results.append(json.load(f))
    return results


def dist_phase(torch, extractor, cfg, dev, frames, service: dict,
               smi: str) -> dict:
    """The distributed path. (a) One rank on a NCCL group: extract_match_step
    on the B=4 1080p batch, then with features_limit, each byte-equal to
    extract_batch (budgeted likewise) and its matches to the tagged dense
    reference, launching the main path's kernels; the median of 10 steps
    interleaved with 10 extract_batch steps; the step's peak memory. (b)
    Two ranks on the one card over gloo (dist_child): ring_match of a new
    frame's rows against the four frames' rows equal to match_brute_force,
    and extract_match_step equal to (a)'s; wall times, bytes per hop. (c)
    SIFT_INT8_MATCH=1: the main step's matching (each frame's top-1024 u8
    rows against the next frame's) equal to the f64 path's, timed beside
    it, with phase 12's 2.2M-row query times."""
    import tempfile

    import torch.distributed as dist

    from sift_features_tpu_torch.ops import matcher
    from sift_features_tpu_torch.ops.kernels import build
    from sift_features_tpu_torch.parallel import mesh as tmesh
    from sift_features_tpu_torch.parallel import pipeline
    from sift_features_tpu_torch.parallel.runner import (barrier,
                                                         init_distributed)

    t_phase = time.perf_counter()
    n_oct = extractor._n_octaves(H, W, cfg)
    out = {"frames": B, "queries_per_frame": 128, "card": smi}

    # (a) one rank, NCCL
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    try:
        out["backend"] = dist.get_backend()
        out["barrier_s"] = barrier("phase 14", 60.0)
        mesh = tmesh.make_mesh(device=dev)

        def step(limit=None):
            return pipeline.extract_match_step(frames, n_oct, cfg, mesh, 128,
                                               limit)

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        build.reset_launches()
        traffic = dict(tmesh.TRAFFIC)
        got = step()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["mem_before_gb"] = base_gb
        out["nccl_gathers_per_step"] = tmesh.TRAFFIC["gathers"] - traffic["gathers"]
        missing = [k for k in WRAPPERS if not launches.get(k)]
        if missing or launches.get("K4"):
            raise SystemExit(f"chip_smoke: dist: step launches {launches}")
        want = extractor.extract_batch(frames, cfg, device=dev)
        out["kept"] = check_step(torch, got, want, "extract_match_step")
        build.reset_launches()
        got_b = step(BUDGET)
        torch.cuda.synchronize()
        launches_b = dict(build.LAUNCHES)
        if not launches_b.get("K6′") or launches_b.get("K6"):
            raise SystemExit(f"chip_smoke: dist: budget launches {launches_b}")
        out["kept_budget"] = check_step(
            torch, got_b, extractor.extract_batch(frames, cfg, BUDGET, device=dev),
            f"extract_match_step, features_limit={BUDGET}")
        del got_b
        out["launches"], out["launches_budget"] = launches, launches_b

        # not gated: 10 steps interleaved with 10 extract_batch steps
        step_s, eb_s = [], []
        for _ in range(10):
            for fn, acc in ((step, step_s), (lambda: extractor.extract_batch(
                    frames, cfg, device=dev), eb_s)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                acc.append((time.perf_counter() - t0) * 1e3)
        out.update({"step_ms": step_s, "extract_batch_ms": eb_s,
                    "step_median_ms": statistics.median(step_s),
                    "extract_batch_median_ms": statistics.median(eb_s)})
        out["step_ratio"] = out["step_median_ms"] / out["extract_batch_median_ms"]
    finally:
        dist.destroy_process_group()

    # (c) int8: the main step's matching, each frame's top-1024 u8 rows
    from sift_features_tpu_torch.models.extractor import stable_top_k

    resp = torch.where(want["valid"], want["kps"][..., 4],
                       torch.tensor(float("-inf"), device=dev))
    top = stable_top_k(resp, N_MATCH)[1]
    d8 = torch.gather(want["desc"], 1, top[..., None].expand(-1, -1, 128))

    def main_matches():
        return [matcher.match_brute_force(d8[(i + 1) % B], d8[i], device=dev)
                for i in range(B)]

    class Pairs:       # the B Matches as one object of arrays
        def __init__(self, ms):
            for f in ("query_idx", "train_idx", "distance"):
                setattr(self, f, np.concatenate([getattr(m, f) for m in ms]))

    f64 = Pairs(main_matches())
    f32 = [matcher.match_dense(d8[(i + 1) % B].float(), d8[i].float())
           for i in range(B)]
    if not np.array_equal(f64.distance, np.concatenate(
            [m[1][m[2]].cpu().numpy() for m in f32])):
        raise SystemExit("chip_smoke: dist: the u8 matches differ from the f32 "
                         "step's")
    f64_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        main_matches()
        f64_ms.append((time.perf_counter() - t0) * 1e3)
    int8 = int8_queries(torch, lambda: Pairs(main_matches()), f64, 0.0, reps=5)
    out["int8_main_step"] = {"f64_ms": f64_ms, "f64_median_ms": statistics.median(f64_ms),
                             "int8_ms": int8["ms"], "int8_median_ms": int8["median_ms"]}
    out["int8_service_query"] = {
        "f64_median_ms": service["query_median_ms"],
        "f64_peak_mem_gb": service["query_peak_mem_gb"],
        "int8_median_ms": service["int8_query_median_ms"],
        "int8_peak_mem_gb": service["int8_query_peak_mem_gb"]}

    # (b) two ranks on the one card over gloo, and (d) the spatial mesh of
    # the same ranks, against the split path of the four frames on the card
    valid = want["valid"].cpu().numpy()
    train = want["desc"].cpu().numpy()[valid]
    _, query = extractor.extract(service_frames(1, 1)[0], device=dev)
    ref = matcher.match_brute_force(train, query, device=dev)
    split = extractor.extract_with_precomputed(
        *extractor.precompute(frames, cfg, device=dev), cfg, device=dev)
    inputs = {"frames": frames, "train": train, "query": query,
              "ring_query_idx": ref.query_idx, "ring_train_idx": ref.train_idx,
              "ring_distance": ref.distance,
              **{f"step_{k}": v.cpu().numpy() for k, v in got.items()},
              **{f"split_{k}": v.cpu().numpy() for k, v in split.items()}}
    del got, want, split
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = two_ranks_on_card(torch, inputs, tmp)
        out["two_ranks_wall_s"] = time.perf_counter() - t0
    out["two_ranks"] = ranks
    out["spatial"] = spatial_summary(ranks, n_oct, cfg)
    out["ring_rows"] = {"train": int(len(train)), "query": int(len(query))}
    out["phase_s"] = time.perf_counter() - t_phase
    r0 = ranks[0]
    print(f"[dist] (a) one rank, {out['backend']}: extract_match_step at B={B} "
          f"{H}x{W}, 128 queries a frame, byte-equal to extract_batch and its "
          f"matches to the tagged dense reference ({out['kept']} kept; "
          f"features_limit={BUDGET}: {out['kept_budget']}); median step "
          f"{out['step_median_ms']:.1f} ms against extract_batch "
          f"{out['extract_batch_median_ms']:.1f} ms (10 each, interleaved): "
          f"{out['step_ratio']:.3f}x; peak {out['peak_mem_gb']:.3f} GB; {smi}",
          flush=True)
    print(f"[dist] (b) {DIST_RANKS} ranks on one card over "
          f"{r0['backend']} ({', '.join(r['device'] for r in ranks)}): "
          f"ring_match of {len(query)} rows against {len(train)} equal to "
          f"match_brute_force ({r0['ring_kept']} kept) in "
          f"{max(r['ring_s'] for r in ranks) * 1e3:.1f} ms, "
          f"{r0['ring_bytes_per_hop']:.0f} bytes a hop; extract_match_step "
          f"equal to (a)'s in {max(r['step_s'][-1] for r in ranks) * 1e3:.1f} ms "
          f"(first {max(r['step_s'][0] for r in ranks) * 1e3:.1f}), "
          f"{r0['step_bytes_per_hop']:.0f} bytes a hop; wall "
          f"{out['two_ranks_wall_s']:.1f} s with process start; {smi}",
          flush=True)
    s8 = out["int8_service_query"]
    m8 = out["int8_main_step"]
    sp = out["spatial"]
    print(f"[dist] (d) spatial mesh data=1 x space={DIST_RANKS} on the same "
          f"ranks: extract_match_step of the {B} frames (octaves "
          f"{sp['sharded_octaves']} row-sharded), its keypoint sets and "
          f"counters byte-equal to the split path's, keypoints a frame equal "
          f"to (a)'s, matches equal to the tagged dense reference "
          f"({sp['kept']} kept; features_limit={BUDGET}: the top-{BUDGET} of "
          f"the unbudgeted step, {sp['kept_budget']} kept); step "
          f"{sp['warm_ms']:.1f} ms (first {sp['first_ms']:.1f}), budget "
          f"{sp['budget_warm_ms']:.1f} ms (first {sp['budget_first_ms']:.1f}); "
          f"{sp['halo_hops']} halo hops a rank, {sp['halo_bytes_per_hop']:.0f} "
          f"bytes a hop; {sp['space_gather_bytes']} bytes gathered over space a "
          f"rank (the space axis's gathers alone); in one timed step ({sp['timed_step_ms']:.1f} ms, each "
          f"collective synchronised) the gathers inside _extract_single_spatial "
          f"{sp['gather_ms_in_step']:.1f} ms (the largest, "
          f"{sp['largest_gather_mb']:.1f} MB received, {sp['largest_gather_ms']:.1f} "
          f"ms), copies into pinned memory {sp['wire_ms_in_step']:.1f} ms (the "
          f"largest {sp['largest_wire_ms']:.1f} ms), halo hops "
          f"{sp['hop_ms_in_step']:.1f} ms; peak {sp['peak_mem_gb']:.3f} GB a "
          f"rank; launches a rank {sp['launches']}; {smi}", flush=True)
    print(f"[dist] (c) SIFT_INT8_MATCH=1 equal to the f64 path: the main step's "
          f"{B} matches of {N_MATCH} u8 rows {m8['int8_median_ms']:.2f} ms "
          f"against {m8['f64_median_ms']:.2f} ms (median of 5); the "
          f"{service['rows']}-row query {s8['int8_median_ms']:.1f} ms against "
          f"{s8['f64_median_ms']:.1f} ms, peak {s8['int8_peak_mem_gb']:.3f} "
          f"against {s8['f64_peak_mem_gb']:.3f} GB; phase {out['phase_s']:.1f} s; "
          f"{smi}", flush=True)
    print(json.dumps({"dist": out}, ensure_ascii=False), flush=True)
    return out


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
    logs = build.build_all(build.SOURCES + ("matcher",))
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
    n_alloc = device_allocs(torch)
    for _ in range(10):
        t0 = time.perf_counter()
        main_path_step(torch, extractor.extract_batch, match_dense, frames,
                       cfg, dev)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    n_alloc = device_allocs(torch) - n_alloc
    step_med = statistics.median(step_s)
    # device time over one step by kernel and by operator (torch.profiler,
    # CUPTI), after the timed steps so its overhead touches none of them
    busy_ms = profile_step(torch, lambda: main_path_step(
        torch, extractor.extract_batch, match_dense, frames, cfg, dev),
        step_med * 1e3, "profile")

    dt = torch.roll(d, -1, 0)
    match_ms = time_ms(torch, lambda: [match_dense(d[(i + 1) % B], d[i])
                                       for i in range(B)], 5)
    cdist_ms = time_ms(torch, lambda: torch.cdist(d, dt), 5)
    print(f"[match] {B} cross-check matches of {N_MATCH} x {N_MATCH} rows: "
          f"match_ms {match_ms:.4f} (library cdist {cdist_ms:.4f})", flush=True)
    print(json.dumps({
        "e2e": "1080p extract + match, B=4", "card": smi,
        "kps_per_frame": kps_frame, "matches_kept": n_kept,
        "median_step_ms": step_med * 1e3, "step_ms": [s * 1e3 for s in step_s],
        "frames_per_s": B / step_med, "first_counted_step_ms": first_s * 1e3,
        "peak_mem_gb": peak_gb, "launches": launches,
        "kernel_ms_in_step": in_step,
        "kernel_ms_per_launch_in_step": {k: v / launches[k] for k, v in in_step.items()},
        "profiled_step_kernel_ms": busy_ms, "device_allocs_in_timed_steps": n_alloc,
        "match_ms": match_ms,
        "match_library_cdist_ms": cdist_ms, "capacity_overflow": overflow}),
        flush=True)

    # 5. budget: bench.py's step_b at features_limit=2048
    budget_row = budget_phase(torch, extractor, match_dense, frames, res, cfg,
                              dev)

    # 6. per-frame path, 7. split path: frame 0 against extract_batch's row
    single_launches = per_frame_phase(torch, extractor, frames, res, cfg, dev)
    split_phase(torch, extractor, frames, res, cfg, dev)
    res_full = res
    del res, d, matches
    torch.cuda.empty_cache()

    # 8. card against CPU on a small image
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
    oracle_check(img[0], rc, cfg)

    # 9. refine_mode="step" (K4) against the default walk
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

    # 10. the other modes at B=4 1080p
    modes = modes_phase(torch, extractor, match_dense, frames, res_full, cfg,
                        dev)
    torch.cuda.empty_cache()

    # 11. the storage modes at B=4 1080p
    storage = storage_phase(torch, extractor, match_dense, frames, res_full,
                            cfg, dev, rows)
    del res_full
    torch.cuda.empty_cache()

    # 12. the descriptor-database service at 256 frames
    service = service_phase(torch, extractor, dev, smi)
    rows["M1"] = service["m1"]
    torch.cuda.empty_cache()

    # 13. the I/O tier and the streaming executor on 62 1080p frames
    stream_phase(torch, extractor, cfg, dev, smi)
    torch.cuda.empty_cache()

    # 14. the distributed path: one NCCL rank, two ranks on the card, int8
    dist_out = dist_phase(torch, extractor, cfg, dev, frames, service, smi)
    torch.cuda.empty_cache()

    # 15. K5's probe lines
    from sift_features_tpu_torch.ops.kernels import orientation as k5

    cap5 = capture_first_calls(torch, {"K5": (EXTRACTOR, "orientation_hist_peaks")},
                               lambda: extractor.extract_batch(frames, cfg, device=dev))
    k5_probe_lines(torch, k5, *cap5["K5"], rows["K5"]["ms"])
    del cap5

    # 16. the kernels line
    paths = {"K4": ("refine_mode=step, 240x320", step_launches),
             "K6′": (f"budget, features_limit={BUDGET}", budget_row["launches"]),
             "K10": ("refine_mode=region main step", modes["region"]["launches"]),
             "K11": ("refine_mode=tile main step", modes["tile"]["launches"])}
    for k in ("K7", "K8"):
        paths[k] = ("window_kernel=perkey main step", modes["perkey"]["launches"])
    for k in ("K9", "K2′", "K5′"):
        paths[k] = ("per-frame _extract_single, 1080p frame 0", single_launches)
    for k in ("K1:bf16", "K2:bf16", "K4:bf16", "K5:bf16", "K6:bf16"):
        paths[k] = ("storage_dtype=bfloat16 main step",
                    storage["bfloat16"]["launches"])
    paths["M1"] = ("service phase: match_dense on u8 rows, the new frame's "
                   f"query and {M1_QUERY_ROWS} x map, with and without "
                   "the cross-check", service["m1_launches"])
    paths["K1:split"] = ("storage_dtype=split main step",
                         storage["split"]["launches"])
    paths["K1:g16"] = ("gather_dtype=bfloat16 main step",
                       storage["gather16"]["launches"])
    paths["K6′:bf16"] = (f"gather_dtype=bfloat16 budget, features_limit={BUDGET}",
                         storage["gather16_budget"]["launches"])
    for k in ("K7:bf16", "K8:bf16"):
        paths[k] = ("storage_dtype=bfloat16 window_kernel=perkey main step",
                    storage["bfloat16_perkey"]["launches"])
    for k, n in storage["k9_launches_per_call"].items():
        paths[k] = ("kernel phase only: one build_octave_padded_batched call "
                    "(no entry point reaches it)", {k: n})
    kernels = []
    for k, (src, replaces) in KERNELS.items():
        path, counts = paths.get(k, ("main path", launches))
        row = {"name": k, "route": "cuda", "source": src,
               "replaces": replaces, "launches": counts.get(k, 0),
               "launches_path": path, **rows[k]}
        if k in WRAPPERS or k == "K6′":
            # phase 14's one-rank extract_match_step (K6′: with the budget)
            row["launches_dist"] = dist_out[
                "launches_budget" if k == "K6′" else "launches"].get(k, 0)
        spatial = dist_out["spatial"]["launches"]
        if spatial.get(k) or k == "K2′":
            # phase 14 (d): rank 0's warm spatial step (K2′ must read 0)
            row["launches_spatial"] = spatial.get(k, 0)
        kernels.append(row)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}, ensure_ascii=False))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
