"""load_fill_s: the mean seconds a job of the program's ``load.fill``
spans: the host's copy of each 64 MiB chunk of the artifact's matrix into
pinned staging (``grm_tpu_torch/ops/popcount.py`` ``split_u64``, 4
threads), apart from the read, the waits on the copy events and the
upload."""

from harness import program_spans as ps


def read(run):
    return ps.per_job(run, ps.total_s(run, "load.fill"))
