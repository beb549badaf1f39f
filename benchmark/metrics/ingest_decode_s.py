"""ingest_decode_s: the mean seconds a job of the program's
``pipeline.decode`` spans: the download of the union's k-mers for the
fitted rules' decoding (``grm_tpu_torch/pipeline.py``
``_DeviceKmerView.kmers``)."""

from harness import program_spans as ps


def read(run):
    return ps.per_job(run, ps.total_s(run, "pipeline.decode"))
