"""extractor.host_ops_per_step: host operators (aten ops not inside
another aten op) that the profiler records inside the span around
`extract_batch`, per step: the extractor glue's dispatch count."""


def read(trace):
    spans = trace.spans.get("bench.extract", [])
    if not spans or not trace.n_steps:
        return None
    return sum(trace.top_level_ops(s, e) for s, e in spans) / trace.n_steps
