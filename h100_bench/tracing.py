"""The traced part of a `--trace 1` run: a bounded number of steps under
`torch.profiler`, read back from its Chrome trace into intervals that the
per-layer readers (`metrics/<name>.py`) take their numbers from.

Spans are the benchmark's own `record_function` ranges around its calls
into the program (`bench.step`, and inside it `bench.extract`,
`bench.match`, `bench.query`). Device activity is every kernel, copy and
fill the profiler saw on the card. The traced window is the traced steps'
spans together: the harness's own work between steps (making the next
step's inputs) is not the program's and is left out.
"""

from __future__ import annotations

import bisect
import contextlib
import glob
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def span(name: str, on: bool):
    """A `record_function` range named `name` when tracing, else nothing."""
    if not on:
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


def kernel_short_name(name: str) -> str:
    """A device kernel's name without `void `, template arguments and
    parameters, as the program's sources spell it."""
    return name.removeprefix("void ").split("<")[0].split("(")[0].strip()


def program_kernels(package_dir: str) -> dict[str, str]:
    """{kernel name: source stem} of the __global__ functions in the
    program's CUDA sources (`csrc/*.cu`)."""
    out = {}
    for fn in sorted(glob.glob(os.path.join(package_dir, "csrc", "*.cu"))):
        with open(fn) as f:
            src = f.read()
        stem = os.path.splitext(os.path.basename(fn))[0]
        for m in re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src):
            out[m] = stem
    return out


def union_s(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by the (start, end) intervals, sorted
    by start."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class Trace:
    """What the profiler saw over the traced steps. Times in seconds on the
    profiler's clock.

    spans:    {span name: [(start, end), ...]} in order
    device:   [(start, end, name, category)] sorted by start
    host_ops: [(start, end, name, tid)] of the host's operators
    steps:    [(start, end)] of the traced steps: the traced window
    n_steps:  steps traced
    kernels:  {kernel name: source stem} of the program's own kernels
    cell:     what the readers need of the cell (shapes, parameters)
    """

    def __init__(self, events: list, n_steps: int, kernels: dict, cell: dict):
        self.spans: dict[str, list] = {}
        self.device, self.host_ops, self.runtime = [], [], []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            s = float(ev["ts"]) * 1e-6
            e = s + float(ev["dur"]) * 1e-6
            cat, name = ev.get("cat", ""), ev.get("name", "")
            if cat in DEVICE_CATS:
                self.device.append((s, e, name, cat))
            elif cat == "user_annotation" and name.startswith("bench."):
                self.spans.setdefault(name, []).append((s, e))
            elif cat == "cpu_op":
                self.host_ops.append((s, e, name, ev.get("tid")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                self.runtime.append((s, e, name, ev.get("tid")))
        for v in self.spans.values():
            v.sort()
        self.device.sort()
        self.host_ops.sort()
        self.runtime.sort()
        self.steps = self.spans.get("bench.step", [])
        self.n_steps = n_steps
        self.kernels = kernels
        self.cell = cell

    # --- device --------------------------------------------------------

    def device_in(self, lo: float, hi: float, kernels_only: bool = False):
        """Device intervals overlapping [lo, hi], clipped to it."""
        out = []
        for s, e, name, cat in self.device:
            if s >= hi:
                break
            if e > lo and (not kernels_only or cat == "kernel"):
                out.append((max(s, lo), min(e, hi), name, cat))
        return out

    def busy_s(self, lo=None, hi=None) -> float:
        """Seconds of [lo, hi] in which the card was busy; without bounds,
        of the traced window."""
        ivals = [(s, e) for s, e, _, _ in self.device]
        if lo is not None:
            return union_s(ivals, lo, hi)
        return sum(union_s(ivals, s, e) for s, e in self.steps)

    def window_s(self) -> float:
        return sum(e - s for s, e in self.steps)

    def kernel_s(self, sources=None) -> float:
        """Summed device time, within the window, of the program's kernels
        (of those whose source stem is in `sources`, when given)."""
        total = 0.0
        for lo, hi in self.steps:
            for s, e, name, _ in self.device_in(lo, hi, kernels_only=True):
                src = self.kernels.get(kernel_short_name(name))
                if src is not None and (sources is None or src in sources):
                    total += e - s
        return total

    # --- host ----------------------------------------------------------

    def top_level_ops(self, lo: float, hi: float, prefix: str = "aten::") -> int:
        """Host operators named prefix* inside [lo, hi] that no other such
        operator encloses (what the host dispatched, not the ops those
        ops call)."""
        n, open_ends = 0, {}
        for s, e, name, tid in self.host_ops:
            if s < lo or e > hi or not name.startswith(prefix):
                continue
            ends = open_ends.setdefault(tid, [])
            while ends and ends[-1] <= s:
                ends.pop()
            if not ends:
                n += 1
            ends.append(e)
        return n

    def _host_at(self, t: float) -> str:
        """The innermost host operator or runtime call running at t."""
        best = None
        for seq in (self.host_ops, self.runtime):
            i = bisect.bisect_right(seq, (t, float("inf")))
            for s, e, name, _ in reversed(seq[max(0, i - 400):i]):
                if s <= t < e and (best is None or e - s < best[0]):
                    best = (e - s, name)
        return best[1] if best else "host (no operator)"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time in the window, and the
        idle time of the card by what the host was running."""
        by_op: dict[str, float] = {}
        gaps: dict[str, float] = {}
        for lo, hi in self.steps:
            ivals = self.device_in(lo, hi)
            for s, e, name, _ in ivals:
                key = name[:120]
                by_op[key] = by_op.get(key, 0.0) + (e - s)
            cur = lo
            for s, e in [(s, e) for s, e, _, _ in ivals] + [(hi, hi)]:
                if s > cur:
                    name = self._host_at(0.5 * (cur + s))
                    gaps[name] = gaps.get(name, 0.0) + (s - cur)
                cur = max(cur, e)
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order(by_op)],
                "idle_gaps": [[k, v] for k, v in order(gaps)]}


def record(run_steps, n_steps: int, kernels: dict, cell: dict) -> Trace:
    """Run run_steps() under the profiler (host and, with a card, device)
    and read its trace; the trace file lives in a temporary directory
    under TMPDIR and is deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        run_steps()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return Trace(events, n_steps, kernels, cell)
