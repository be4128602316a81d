"""matcher.idle_ms_in_chunks_per_query: milliseconds in which the card was
idle inside the program's `matcher.chunks` span (the host's chunk loop:
launch-bound gaps), per traced query."""

from h100_bench import program_spans


def read(trace):
    reqs = program_spans.traced_requests(trace)
    if not reqs or trace.busy_s() <= 0:
        return None
    return 1e3 * sum(program_spans.chunk_idle_s(trace, r) for r in reqs) / len(reqs)
