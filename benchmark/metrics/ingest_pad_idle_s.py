"""ingest_pad_idle_s: the mean seconds a job in which the device was idle
inside the program's ``ingest.pad`` spans: the batch padding that no
earlier batch's sort overlaps."""

from harness import program_spans as ps


def read(run):
    return ps.per_job(run, ps.idle_s(run, "ingest.pad"))
