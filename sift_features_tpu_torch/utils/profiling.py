"""Tracing / profiling / metrics (the port of
sift_features_tpu/utils/profiling.py).

Program spans, torch.profiler traces, and keypoint and rejection counters.
The rejection counters are the primary parity-debugging tool: a
divergence against the JAX package or the oracle localizes to the first
stage whose count differs.

Spans. `span(name, **attrs)` times one call of a layer (the service's
query and ingest, the matcher's stages), never one iteration of a loop, so
a query leaves O(10) spans. Each records its start and end in Unix
nanoseconds (`time.time_ns()`: the clock of an exported torch.profiler
trace, whose `ts` x 1000 + `baseTimeNanoseconds` is the same instant), its
parent span and its request (the id of the outermost span around it,
shared by every span of one `DescriptorIndex.query` or `add_*` call). The
last `SPAN_BUFFER` spans are kept in memory (`spans()`); `totals()` keeps
each name's calls and seconds since the last `clear()`, whatever the
buffer has dropped. While a torch.profiler session runs, each span also
opens a `record_function` range of its name, so the exported trace shows
the program's spans on its kernels' timeline; with none running a span
costs a few microseconds of host time.

Stream time of a loop's stages (`stage_clock`): only while a profiler
session runs, on a CUDA device, CUDA events on the current stream mark the
edges of each stage of each iteration. Their sums become child spans of
the span around the loop, with `stream_ms`, when `spans()` is next read
(by then the caller has read its results back, so the events have
completed and reading them costs the timed path nothing). An event pair
times everything between its two records on the stream: the stage's
kernels and the gaps in which the card waited for the host to launch
them. Outside a session the loop pays one test of None an iteration.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import os
import time

import numpy as np
import torch

# spans kept in memory (the oldest go first)
SPAN_BUFFER = 4096


@dataclasses.dataclass
class Span:
    """One call of a layer. start_ns / end_ns: Unix nanoseconds; parent:
    the enclosing span's id (None for a request's outermost span);
    request: the outermost span's id; stream_ms: where a stage clock
    measured the stage, its elapsed time on the stream, launch gaps
    included (module note)."""

    name: str
    id: int
    parent: int | None
    request: int
    start_ns: int
    end_ns: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)
    stream_ms: float | None = None


_spans: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_totals: dict[str, list] = {}
_clocks: collections.deque = collections.deque()
_ids = itertools.count(1)
_current: contextvars.ContextVar = contextvars.ContextVar("span", default=None)
_profiling = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time the block as a span named `name` (module note); yields the
    Span, whose attrs the block may add to."""
    parent = _current.get()
    sid = next(_ids)
    ranged = (torch.profiler.record_function(name) if _profiling()
              else contextlib.nullcontext())
    with ranged:
        sp = Span(name, sid, None if parent is None else parent.id,
                  sid if parent is None else parent.request, time.time_ns(),
                  attrs=attrs)
        token = _current.set(sp)
        try:
            yield sp
        finally:
            sp.end_ns = time.time_ns()
            _current.reset(token)
            _spans.append(sp)
            t = _totals.setdefault(name, [0, 0])
            t[0] += 1
            t[1] += sp.end_ns - sp.start_ns


class StageClock:
    """CUDA events at the edges of the stages of a loop's iterations: each
    iteration calls `mark()` before each of its stages, and the loop once
    more after its last iteration, so one event ends a stage and starts
    the next (an event with timing on holds the stream's next kernel until
    the previous one has drained: fewer events, less cost)."""

    def __init__(self, names: tuple, unit: str, parent: Span,
                 stream: torch.cuda.Stream):
        self.names, self.unit, self.parent = names, unit, parent
        self.stream = stream
        self.events: list = []

    def mark(self) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        self.events.append(ev)

    def _emit(self) -> None:
        """Each stage's summed stream time as a child span of the parent
        (waits for the last event)."""
        k = len(self.names)
        n = (len(self.events) - 1) // k if self.events else 0
        ms = [0.0] * k
        if n:
            self.events[n * k].synchronize()
        for i in range(n * k):
            ms[i % k] += self.events[i].elapsed_time(self.events[i + 1])
        p = self.parent
        for name, t in zip(self.names, ms):
            _spans.append(Span(name, next(_ids), p.id, p.request, p.start_ns,
                               p.end_ns, {self.unit: n}, stream_ms=t))


def stage_clock(device: torch.device, names: tuple,
                unit: str) -> StageClock | None:
    """A StageClock for the stages `names` of a loop inside the current
    span, counting its iterations as `unit`; None outside a torch.profiler
    session, off CUDA or outside a span (module note)."""
    parent = _current.get()
    if device.type != "cuda" or parent is None or not _profiling():
        return None
    clock = StageClock(names, unit, parent, torch.cuda.current_stream(device))
    _clocks.append(clock)
    return clock


def spans() -> list[Span]:
    """The spans in memory, in the order they ended; stage clocks' spans
    after them, once read (module note)."""
    while _clocks:
        _clocks.popleft()._emit()
    return list(_spans)


def totals() -> dict[str, tuple[int, float]]:
    """name -> (calls, seconds) of every span that ended since the last
    clear(), the spans the buffer has dropped included."""
    return {k: (n, ns * 1e-9) for k, (n, ns) in _totals.items()}


def clear() -> None:
    """Forget every span, total and unread stage clock."""
    _clocks.clear()
    _totals.clear()
    _spans.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the host and, where there is a card, its
    kernels; written as a Chrome trace to log_dir/trace.json (open it in
    chrome://tracing or Perfetto). The program's spans appear in it as
    ranges of their names."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
