"""extractor.ms_per_step: milliseconds of the benchmark's span around
`extract_batch`, closed by a synchronise in the traced run, per step."""


def read(trace):
    spans = trace.spans.get("bench.extract", [])
    if not spans or not trace.n_steps:
        return None
    return 1e3 * sum(e - s for s, e in spans) / trace.n_steps
