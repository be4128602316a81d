"""matcher.distance_stream_ms_per_query: milliseconds of the matcher's
distance stage on the card's stream per traced query: the program's
`matcher.distance` span, CUDA events around each chunk's `_chunk_d2` (the
u8 to f64 copy, the norms, the product, the doubling and subtraction, the
f32 rounding and clamp), summed over the chunks. Not kernel time alone: an
event pair also times the gaps in which the card waited for the host's
launches, so fewer launches a chunk lower it with no kernel faster."""

from h100_bench import program_spans


def read(trace):
    return program_spans.stream_ms_per_query(trace, "matcher.distance")
