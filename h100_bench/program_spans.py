"""The program's own spans (`sift_features_tpu_torch.utils.profiling`),
for the per-layer readers, placed on a Trace's clock.

The program keeps its spans in memory, stamped in Unix nanoseconds; a
Trace's times are seconds on the profiler's clock. The traced requests are
the last `trace.n_steps` `service.query` spans: each runs inside the
benchmark's `bench.query` span around the same call, microseconds from
its edges, so the offset between the two starts places that request's
spans on the Trace's clock.

This benchmark also runs laid over the checkout of a program older than
its spans, whose `utils.profiling` has neither `spans` nor `totals`: there
the program gives none, and the readers give None.
"""

from __future__ import annotations

# how far a placed `service.query` may end after its `bench.query`
SLACK_S = 1e-3


def program_spans() -> list:
    """The spans the program holds in this process (oldest first)."""
    from sift_features_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


def span_totals() -> dict:
    """name -> (calls, seconds) of the program's spans in this process,
    those its buffer has dropped included."""
    from sift_features_tpu_torch.utils import profiling

    read = getattr(profiling, "totals", None)
    return dict(read()) if read is not None else {}


class Request:
    """One traced request's spans, placed on the Trace's clock."""

    def __init__(self, root, members: list, t0: float):
        self.root, self.members, self._t0 = root, members, t0

    def at(self, ns: int) -> float:
        """A program stamp (Unix ns) as seconds on the Trace's clock."""
        return self._t0 + (ns - self.root.start_ns) * 1e-9

    def named(self, name: str) -> list:
        """[(start, end, span)] of the request's spans called `name`."""
        return [(self.at(s.start_ns), self.at(s.end_ns), s)
                for s in self.members if s.name == name]


def traced_requests(trace, spans: list | None = None) -> list[Request]:
    """The traced requests (module note); [] when the program's spans do
    not pair with the trace's `bench.query` spans."""
    spans = program_spans() if spans is None else spans
    n = trace.n_steps
    bench = trace.spans.get("bench.query", [])
    roots = sorted((s for s in spans
                    if s.name == "service.query" and s.parent is None),
                   key=lambda s: s.start_ns)
    if n <= 0 or len(bench) < n or len(roots) < n:
        return []
    out = []
    for root, (lo, hi) in zip(roots[-n:], bench[-n:]):
        req = Request(root, [s for s in spans if s.request == root.request], lo)
        if req.at(root.end_ns) > hi + SLACK_S:
            return []
        out.append(req)
    return out


def stream_ms_per_query(trace, name: str) -> float | None:
    """Mean over the traced requests of the stream ms of their spans
    called `name`; None unless every request has one."""
    per = []
    for r in traced_requests(trace):
        ms = [s.stream_ms for _, _, s in r.named(name) if s.stream_ms is not None]
        if not ms:
            return None
        per.append(sum(ms))
    return sum(per) / len(per) if per else None


def idle_s(trace, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] in which nothing ran on the card."""
    return (hi - lo) - trace.busy_s(lo, hi)


def chunk_idle_s(trace, req: Request) -> float:
    """Idle seconds of the card inside the request's `matcher.chunks`."""
    return sum(idle_s(trace, lo, hi) for lo, hi, _ in req.named("matcher.chunks"))


def seconds_of(name: str) -> float | None:
    """Summed seconds of every span called `name` the program ran (the
    whole run's, set-up's included); None without one."""
    calls, seconds = span_totals().get(name, (0, 0.0))
    return seconds if calls else None
