"""Tracing / profiling / metrics (the port of
sift_features_tpu/utils/profiling.py).

Per-stage wall times, keypoint and rejection counters, and torch.profiler
traces. The rejection counters are the primary parity-debugging tool: a
divergence against the JAX package or the oracle localizes to the first
stage whose count differs.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the host and, where there is a card, its
    kernels; written as a Chrome trace to log_dir/trace.json (open it in
    chrome://tracing or Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of the tensors in a result (tensor, dict, list or
    tuple, nested)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    return out


class StageTimer:
    """Wall-clock stage timer with device synchronization at stage edges."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result_holder: list | None = None):
        """Time the block; when result_holder is given, the stage ends once
        the card has finished the work of its last item (a result holding
        CUDA tensors: torch.cuda.synchronize on their devices)."""
        t0 = time.perf_counter()
        yield
        if result_holder:
            for dev in _cuda_devices(result_holder[-1], set()):
                torch.cuda.synchronize(dev)
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{k:>12s}: {v * 1e3:8.2f} ms ({v / total:5.1%})"
                 for k, v in self.times.items()]
        lines.append(f"{'total':>12s}: {total * 1e3:8.2f} ms")
        return "\n".join(lines)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def extraction_metrics(res, image_hw=None, cfg=None) -> dict:
    """Structured per-batch metrics from an extract_batch result dict
    (tensors on any device, or arrays): keypoints/frame, per-octave stage
    counts, refinement-rejection totals, and capacity-overflow flags when
    (image_hw, cfg) are given (n_candidates is the TRUE discrete-extrema
    count; exceeding the octave's static buffer means the survivor set was
    truncated)."""
    valid = _host(res["valid"])
    n_cand = _host(res["n_candidates"])
    n_surv = _host(res["n_survivors"])
    n_emit = _host(res["n_emitted"])
    out = {
        "frames": int(valid.shape[0]),
        "keypoints_per_frame": valid.sum(axis=1).tolist(),
        "candidates_per_octave": n_cand.tolist(),
        "survivors_per_octave": n_surv.tolist(),
        "emitted_per_octave": n_emit.tolist(),
        "rejected_refine": (n_cand - n_surv).sum(axis=-1).tolist(),
    }
    if image_hw is not None and cfg is not None:
        from ..models.extractor import octave_capacities

        h = image_hw[0] * cfg.inv_delta_min
        w = image_hw[1] * cfg.inv_delta_min
        overflow = []
        for o in range(n_cand.shape[-1]):
            k, k2, m = octave_capacities(h, w, cfg)
            overflow.append(bool((n_cand[..., o] > k).any()
                                 or (n_surv[..., o] > k2).any()
                                 or (n_emit[..., o] > m).any()))
            h, w = h // 2, w // 2
        out["capacity_overflow_per_octave"] = overflow
    return out
