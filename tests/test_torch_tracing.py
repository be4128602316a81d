"""The port's spans (`utils/profiling.py`) on the CPU:

- a query's and an ingest's spans nest under one request id, with their
  parents' ids;
- under torch.profiler the spans are `record_function` ranges of the
  exported Chrome trace, stamped on its clock (ts x 1000 +
  baseTimeNanoseconds);
- with no profiler `match_dense` takes no stage clock and leaves only its
  per-call spans; a stage clock (fake CUDA events) sums each stage over the
  iterations into child spans of the loop's span;
- the `matcher.chunks` span's `chunks` and `pairs` at chunks of 7 train
  rows, the service's upload and row-map attributes, and the totals by
  name;
- `DescriptorIndex.query` answers the same with tracing on and off;
- the matcher on an empty side keeps no row.
"""

import collections
import json

import numpy as np
import pytest
import torch

from sift_features_tpu_torch.ops import matcher
from sift_features_tpu_torch.service import DescriptorIndex
from sift_features_tpu_torch.utils import profiling

from test_torch_gpu import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

QUERY = ("matcher.prepare", "matcher.chunks", "matcher.readback",
         "service.row_maps", "service.result")


def _index(seed=5, frames=4, rows=30):
    """A CPU index of `frames` frames of `rows` random u8 rows, and a query
    of some of their rows and fresh ones."""
    rng = np.random.RandomState(seed)
    desc = rng.randint(0, 256, (frames, rows, 128)).astype(np.uint8)
    res = {"kps": torch.from_numpy(rng.rand(frames, rows, 5).astype(np.float32)),
           "desc": torch.from_numpy(desc),
           "valid": torch.ones((frames, rows), dtype=torch.bool)}
    idx = DescriptorIndex(device="cpu")
    idx.add_batch_result(res, np.arange(frames) + 10)
    q = np.concatenate([desc[1, :12], rng.randint(0, 256, (9, 128)).astype(np.uint8)])
    return idx, q


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_under_one_request():
    profiling.clear()
    idx, q = _index()
    idx.query(q)
    idx.query(q)
    s = _by_name(profiling.spans())
    ingest, = s["service.ingest"]
    assert ingest.parent is None and ingest.request == ingest.id
    for name in ("db.from_batch", "db.extend"):
        child, = s[name]
        assert child.parent == ingest.id and child.request == ingest.id
        assert ingest.start_ns <= child.start_ns <= child.end_ns <= ingest.end_ns
    first, second = s["service.query"]
    assert first.parent is None and first.request == first.id
    assert second.request == second.id != first.id
    assert first.attrs == {"rows": len(q)}
    upload, = s["service.train_upload"]
    assert upload.parent == first.id and upload.attrs == {"bytes": 4 * 30 * 128}
    for name in QUERY:
        a, b = s[name]
        assert (a.parent, a.request) == (first.id, first.id), name
        assert (b.parent, b.request) == (second.id, second.id), name
        assert first.start_ns <= a.start_ns <= a.end_ns <= first.end_ns
    assert [m.attrs["cache_hit"] for m in s["service.row_maps"]] == [False, True]
    assert "matcher.distance" not in s and "matcher.select" not in s
    assert [c.attrs for c in s["matcher.chunks"]] == [
        {"chunks": 1, "pairs": 21 * 120, "route": "plain"}] * 2
    totals = profiling.totals()
    assert set(totals) == set(s)
    for name, got in s.items():
        calls, seconds = totals[name]
        assert calls == len(got)
        assert seconds == pytest.approx(sum(x.end_ns - x.start_ns for x in got) * 1e-9)
    profiling.clear()
    assert profiling.spans() == [] and profiling.totals() == {}


def test_totals_outlive_the_buffer(monkeypatch):
    """Spans the buffer drops still count in the totals by name."""
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=2))
    profiling.clear()
    for _ in range(3):
        with profiling.span("service.ingest"):
            with profiling.span("db.extend"):
                pass
    assert [s.name for s in profiling.spans()] == ["db.extend", "service.ingest"]
    totals = profiling.totals()
    assert {k: n for k, (n, _) in totals.items()} == {"service.ingest": 3, "db.extend": 3}
    assert totals["service.ingest"][1] >= totals["db.extend"][1] > 0
    profiling.clear()


def test_spans_on_the_profiler_clock(tmp_path):
    """Each span is a range of its name in the exported Chrome trace; its
    stamps are the trace's ts x 1000 + baseTimeNanoseconds within 1 ms, and
    tracing changes no answer."""
    idx, q = _index(seed=8)
    plain = idx.query(q)
    profiling.clear()
    with profiling.device_trace(str(tmp_path)):
        # the first range of a process takes the profiler ~1 ms to open
        with torch.profiler.record_function("warm-up"):
            pass
        traced = idx.query(q)
    for f in ("query_idx", "frame_id", "keypoint_idx", "distance"):
        a, b = getattr(plain, f), getattr(traced, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    ranges = {}
    for ev in doc["traceEvents"]:
        if ev.get("cat") == "user_annotation" and ev.get("ph") == "X":
            ranges.setdefault(ev["name"], []).append(ev)
    spans = profiling.spans()
    assert {s.name for s in spans} == {"service.query", *QUERY}
    for s in spans:
        ev, = ranges[s.name]
        start = float(ev["ts"]) * 1e3 + base
        end = start + float(ev["dur"]) * 1e3
        assert abs(start - s.start_ns) < 1e6 and abs(end - s.end_ns) < 1e6, s.name


@pytest.mark.parametrize("int8", [False, True])
def test_chunk_counters_and_no_clock_without_profiler(monkeypatch, int8):
    """At chunks of 7 train rows the `matcher.chunks` span counts
    ceil(T / 7) chunks and Q x T pairs, and names the route (the loop, on
    the CPU); one prepare and one chunks span, and no stage clock is taken
    with no profiler running."""
    rng = np.random.RandomState(4)
    t = torch.from_numpy(rng.randint(0, 256, (95, 128)).astype(np.uint8))
    q = torch.from_numpy(rng.randint(0, 256, (40, 128)).astype(np.uint8))
    # 7 rows of f64 temporaries; the int8 path rounds its chunk to 8 rows
    monkeypatch.setattr(matcher, "TEMP_BYTES", 7 * 8 * len(q))
    rows = 8 if int8 else 7
    taken = []
    real = profiling.stage_clock
    monkeypatch.setattr(matcher, "stage_clock",
                        lambda *a: taken.append(real(*a)) or taken[-1])
    # a clock asked for on a card, inside a span, outside a session
    with profiling.span("outer"):
        assert profiling.stage_clock(torch.device("cuda"), matcher.STAGES, "chunks") is None
    profiling.clear()
    got = matcher.match_dense(t, q, True, int8)
    assert taken == [None]
    s = _by_name(profiling.spans())
    assert set(s) == {"matcher.prepare", "matcher.chunks"}
    chunks, = s["matcher.chunks"]
    assert chunks.attrs == {"chunks": -(-95 // rows), "pairs": 40 * 95,
                            "route": "plain"}
    whole = matcher.match_dense(t, q.float(), True)
    for a, b in zip(got, whole):
        assert torch.equal(a, b)


class _FakeEvent:
    """A CUDA event stand-in: the k-th record() stamps k (k + 1) / 2 ms."""

    recorded = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        k = _FakeEvent.recorded
        self.t = k * (k + 1) / 2
        _FakeEvent.recorded = k + 1

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


def test_stage_clock_sums_stages_into_child_spans(monkeypatch):
    """Under a (pretended) profiler session on a card, match_dense marks
    each chunk's stages, and the clock's sums become `matcher.distance` /
    `matcher.select` spans under `matcher.chunks` once spans() is read."""
    monkeypatch.setattr(profiling, "_profiling", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "recorded", 0)
    profiling.clear()
    with profiling.span("matcher.chunks") as outer:
        clock = profiling.stage_clock(torch.device("cuda", 0), matcher.STAGES,
                                      "chunks")
        assert clock is not None
        for _ in range(3):
            clock.mark()
            clock.mark()
        clock.mark()
    stamps = [ev.t for ev in clock.events]
    want_d = sum(stamps[2 * j + 1] - stamps[2 * j] for j in range(3))
    want_s = sum(stamps[2 * j + 2] - stamps[2 * j + 1] for j in range(3))
    s = _by_name(profiling.spans())
    dist, = s["matcher.distance"]
    sel, = s["matcher.select"]
    for sp, want in ((dist, want_d), (sel, want_s)):
        assert sp.parent == outer.id and sp.request == outer.request
        assert sp.attrs == {"chunks": 3} and sp.stream_ms == pytest.approx(want)
        assert (sp.start_ns, sp.end_ns) == (outer.start_ns, outer.end_ns)
    profiling.clear()

    # a clock is read only by spans(); clear() drops an unread one
    with profiling.span("matcher.chunks"):
        for _ in range(2):
            clock = profiling.stage_clock(torch.device("cuda", 0), matcher.STAGES,
                                          "chunks")
            clock.mark()
            clock.mark()
            clock.mark()
    assert [s.name for s in profiling._spans] == ["matcher.chunks"]
    assert len(profiling.spans()) == 5
    with profiling.span("matcher.chunks"):
        profiling.stage_clock(torch.device("cuda", 0), matcher.STAGES, "chunks").mark()
    profiling.clear()
    assert profiling.spans() == []

    # match_dense's marks: two a chunk and one after the last, from a fake
    # clock
    marks = []

    class Clock:
        def mark(self):
            marks.append(1)

    monkeypatch.setattr(matcher, "stage_clock", lambda *a: Clock())
    monkeypatch.setattr(matcher, "TEMP_BYTES", 7 * 8 * 5)
    rng = np.random.RandomState(1)
    t = torch.from_numpy(rng.randint(0, 256, (30, 128)).astype(np.uint8))
    matcher.match_dense(t, t[:5])
    assert len(marks) == 2 * 5 + 1


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("cross_check", [True, False])
def test_empty_side_keeps_nothing(dtype, cross_check):
    rng = np.random.RandomState(2)
    rows = rng.randint(0, 256, (9, 128)).astype(dtype)
    none = np.zeros((0, 128), dtype)
    for train, query in ((rows, none), (none, rows), (none, none)):
        m = matcher.match_brute_force(train, query, cross_check, device="cpu")
        assert len(m.query_idx) == len(m.train_idx) == len(m.distance) == 0
        assert (m.query_idx.dtype, m.train_idx.dtype, m.distance.dtype) == (
            np.int64, np.int64, np.float32)
        bt, dist, keep = matcher.match_dense(torch.from_numpy(train),
                                             torch.from_numpy(query),
                                             cross_check, dtype == np.uint8)
        assert bt.shape == dist.shape == keep.shape == (len(query),)
        assert not keep.any()
