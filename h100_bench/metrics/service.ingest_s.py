"""service.ingest_s: seconds of the program's `service.ingest` spans
(`DescriptorIndex.add_batch_result`: the valid rows to the host, the
database's concatenation) over the run, from the program's span totals:
the map's ingest in set-up."""

from h100_bench import program_spans


def read(trace):
    return program_spans.seconds_of("service.ingest")
