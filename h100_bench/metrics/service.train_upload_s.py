"""service.train_upload_s: seconds of the program's `service.train_upload`
spans (the database's descriptors to the card, once per database) over the
run, from the program's span totals: the first warm-up query's upload in
set-up."""

from h100_bench import program_spans


def read(trace):
    return program_spans.seconds_of("service.train_upload")
