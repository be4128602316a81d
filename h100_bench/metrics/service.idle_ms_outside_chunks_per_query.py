"""service.idle_ms_outside_chunks_per_query: milliseconds in which the card
was idle inside the program's `service.query` span but outside its
`matcher.chunks` span (the query's upload and norms, the readbacks, the
row maps and the result), per traced query."""

from h100_bench import program_spans


def read(trace):
    reqs = program_spans.traced_requests(trace)
    if not reqs or trace.busy_s() <= 0:
        return None
    idle = 0.0
    for r in reqs:
        idle += sum(program_spans.idle_s(trace, lo, hi)
                    for lo, hi, _ in r.named("service.query"))
        idle -= program_spans.chunk_idle_s(trace, r)
    return 1e3 * idle / len(reqs)
