"""ingest_pad_s: the mean seconds a job of the program's ``ingest.pad``
spans: each genome batch's host padding into pinned memory
(``grm_tpu_torch/parallel/device_build.py`` ``_build_codes``)."""

from harness import program_spans as ps


def read(run):
    return ps.per_job(run, ps.total_s(run, "ingest.pad"))
