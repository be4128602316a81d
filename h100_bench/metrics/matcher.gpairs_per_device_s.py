"""matcher.gpairs_per_device_s: distances computed per second in which the
card was busy inside the program's `service.query` span, in billions: the
`pairs` (query rows x train rows) of its `matcher.chunks` span over the
union of device activity in the request, summed over the traced queries.
The request's span, not the loop's: the chunks' kernels run on ~0.1 s past
the host's loop, into the readback's wait. Idle gaps do not count; the
work counted is the same whatever computes it."""

from h100_bench import program_spans


def read(trace):
    pairs, busy = 0, 0.0
    for r in program_spans.traced_requests(trace):
        pairs += sum(s.attrs.get("pairs", 0) for _, _, s in r.named("matcher.chunks"))
        busy += sum(trace.busy_s(lo, hi) for lo, hi, _ in r.named("service.query"))
    if pairs <= 0 or busy <= 0:
        return None
    return pairs / busy / 1e9
