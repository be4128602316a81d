"""matcher.ms_per_step: milliseconds of the benchmark's spans around the
step's `match_descriptors` calls (each returns its matches on the host),
per step."""


def read(trace):
    spans = trace.spans.get("bench.match", [])
    if not spans or not trace.n_steps:
        return None
    return 1e3 * sum(e - s for s, e in spans) / trace.n_steps
