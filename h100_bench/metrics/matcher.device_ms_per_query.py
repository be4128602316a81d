"""matcher.device_ms_per_query: device milliseconds of every kernel that
ran inside the benchmark's span around `DescriptorIndex.query`, per query."""


def read(trace):
    spans = trace.spans.get("bench.query", [])
    if not spans:
        return None
    t = sum(e - s for lo, hi in spans
            for s, e, _, _ in trace.device_in(lo, hi, kernels_only=True))
    if t <= 0:
        return None
    return 1e3 * t / len(spans)
