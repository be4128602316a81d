"""matcher.select_stream_ms_per_query: milliseconds of the matcher's
selection stage on the card's stream per traced query: the program's
`matcher.select` span, CUDA events around each chunk's row argmin, gather,
running best and the cross-check's column argmin, summed over the chunks.
Launch gaps included, as in matcher.distance_stream_ms_per_query."""

from h100_bench import program_spans


def read(trace):
    return program_spans.stream_ms_per_query(trace, "matcher.select")
