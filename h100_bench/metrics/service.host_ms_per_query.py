"""service.host_ms_per_query: milliseconds of the span around
`DescriptorIndex.query` in which the card was idle (the span less the
union of device activity inside it), per query."""


def read(trace):
    spans = trace.spans.get("bench.query", [])
    if not spans or trace.busy_s() <= 0:
        return None
    idle = sum((hi - lo) - trace.busy_s(lo, hi) for lo, hi in spans)
    return 1e3 * idle / len(spans)
