"""The readers of the program's spans (`program_spans.py` and the metrics
that use it) on a synthetic Trace: two traced queries after a warm-up one,
placed on the trace's clock by a known offset, with known idle gaps of the
card inside and outside the chunk loop. A program without spans gives no
reading; a tiny traced run on the CPU reports the set-up spans."""

import dataclasses

import pytest

from h100_bench import harness, program_spans
from h100_bench.tracing import Trace
from h100_bench_support import BENCH, run_cell

NEW = ("matcher.distance_stream_ms_per_query", "matcher.select_stream_ms_per_query",
       "matcher.gpairs_per_device_s", "matcher.idle_ms_in_chunks_per_query",
       "service.idle_ms_outside_chunks_per_query", "service.ingest_s",
       "service.train_upload_s")
# the program's clock (Unix ns) at the trace's 0 s, less a few microseconds
# that differ per query
BASE_NS = 1_790_000_000_000_000_000
MS = 1_000_000


@dataclasses.dataclass
class Span:
    name: str
    id: int
    parent: int | None
    request: int
    start_ns: int
    end_ns: int
    attrs: dict = dataclasses.field(default_factory=dict)
    stream_ms: float | None = None


def _query(rid: int, t0_ns: int, dist_ms: float, sel_ms: float) -> list:
    """One query's spans, from t0_ns: prepare 0-5 ms, chunks 5-150,
    readback 150-190, row maps 190-195, result 195-199, the query 0-200."""
    at = lambda ms: t0_ns + int(ms * MS)  # noqa: E731
    kids = [("matcher.prepare", 0, 5, {}), ("matcher.chunks", 5, 150,
            {"chunks": 3, "pairs": 10 ** 12}), ("matcher.readback", 150, 190, {}),
            ("service.row_maps", 190, 195, {"cache_hit": True}),
            ("service.result", 195, 199, {})]
    out = [Span(n, rid + 1 + i, rid, rid, at(a), at(b), attrs)
           for i, (n, a, b, attrs) in enumerate(kids)]
    chunks = out[1]
    out += [Span("matcher.distance", rid + 8, chunks.id, rid, chunks.start_ns,
                 chunks.end_ns, {"chunks": 3}, dist_ms),
            Span("matcher.select", rid + 9, chunks.id, rid, chunks.start_ns,
                 chunks.end_ns, {"chunks": 3}, sel_ms)]
    out.append(Span("service.query", rid, None, rid, at(0), at(200), {"rows": 8}))
    return out


def _program() -> list:
    ingest = [Span("service.ingest", 1, None, 1, BASE_NS - 9000 * MS,
                   BASE_NS - 6000 * MS),
              Span("db.from_batch", 2, 1, 1, BASE_NS - 9000 * MS, BASE_NS - 7000 * MS)]
    warm = _query(10, BASE_NS - 4000 * MS, 500.0, 500.0)
    warm.append(Span("service.train_upload", 20, 10, 10, BASE_NS - 4000 * MS,
                     BASE_NS - 3500 * MS, {"bytes": 4}))
    return (ingest + warm + _query(30, BASE_NS + 10_000 * MS - 3000, 100.0, 40.0)
            + _query(50, BASE_NS + 11_000 * MS - 7000, 100.0, 40.0))


def _totals(spans: list) -> dict:
    out = {}
    for s in spans:
        n, t = out.get(s.name, (0, 0.0))
        out[s.name] = (n + 1, t + (s.end_ns - s.start_ns) * 1e-9)
    return out


def _trace() -> Trace:
    """bench.query spans at 10.000 and 11.000 s (201 ms: the program's
    query starts a few microseconds after its own); per query, the card
    busy at 1-4, 5-100 and 102-160 ms of it."""
    ev = []
    for t0 in (10.0, 11.0):
        us = lambda ms: (t0 + ms * 1e-3) * 1e6  # noqa: E731
        for name in ("bench.step", "bench.query"):
            ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                       "ts": us(0), "dur": 201e3})
        for a, b in ((1, 4), (5, 100), (102, 160)):
            ev.append({"ph": "X", "cat": "kernel", "name": "k", "ts": us(a),
                       "dur": (b - a) * 1e3})
    return Trace(ev, 2, {}, {})


def _read(name, trace):
    return harness._reader(BENCH, name)(trace)


def test_readers_on_a_synthetic_trace(monkeypatch):
    monkeypatch.setattr(program_spans, "program_spans", _program)
    # the set-up spans count from the totals, which outlive the buffer
    monkeypatch.setattr(program_spans, "span_totals", lambda: _totals(_program()))
    tr = _trace()
    reqs = program_spans.traced_requests(tr)
    assert [r.root.id for r in reqs] == [30, 50]
    (lo, hi, _), = reqs[1].named("matcher.chunks")
    assert lo == pytest.approx(11.005, abs=1e-9) and hi == pytest.approx(11.150, abs=1e-9)
    got = {n: _read(n, tr) for n in NEW}
    want = {"matcher.distance_stream_ms_per_query": 100.0,
            "matcher.select_stream_ms_per_query": 40.0,
            # 10^12 pairs over the card's busy 1-4, 5-100 and 102-160 ms
            "matcher.gpairs_per_device_s": 1e12 / 0.156 / 1e9,
            # the gap at 100-102 ms
            "matcher.idle_ms_in_chunks_per_query": 2.0,
            # 0-1, 4-5 and 160-200 ms
            "service.idle_ms_outside_chunks_per_query": 42.0,
            "service.ingest_s": 3.0, "service.train_upload_s": 0.5}
    for n in NEW:
        assert got[n] == pytest.approx(want[n], rel=1e-6, abs=1e-6), n
    # the two idle readings split the accepted host reading (the bench span's
    # idle time: 1 ms more, after the program's query ends)
    host = _read("service.host_ms_per_query", tr)
    assert host == pytest.approx(got["matcher.idle_ms_in_chunks_per_query"]
                                 + got["service.idle_ms_outside_chunks_per_query"] + 1.0)


def test_readers_without_program_spans(monkeypatch):
    """A program that keeps no spans (or whose spans do not pair with the
    trace) gives no reading and raises nothing."""
    tr = _trace()
    monkeypatch.setattr(program_spans, "program_spans", lambda: [])
    monkeypatch.setattr(program_spans, "span_totals", lambda: {})
    assert all(_read(n, tr) is None for n in NEW)
    # a placed query that ends past its bench span does not pair
    late = [dataclasses.replace(s, end_ns=s.end_ns + 50 * MS)
            if s.name == "service.query" else s for s in _program()]
    monkeypatch.setattr(program_spans, "program_spans", lambda: late)
    assert program_spans.traced_requests(tr) == []
    assert _read("matcher.distance_stream_ms_per_query", tr) is None


def test_traced_cpu_run_reports_setup_spans(tiny_root):
    """On the CPU the card's readings are absent and the set-up spans are
    read."""
    r = run_cell(tiny_root, "index_query", 2 ** 31 + 11, trace=1)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert m["service.ingest_s"]["value"] > 0 and m["service.ingest_s"]["unit"] == "s"
    assert m["service.train_upload_s"]["value"] > 0
    assert not set(m) & set(NEW[:5])
