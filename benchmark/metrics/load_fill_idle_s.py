"""load_fill_idle_s: the mean seconds a job in which the device was idle
inside the program's ``load.fill`` spans (the host's copy of a chunk into
pinned staging): the share of the fill that no upload or split overlaps."""

from harness import program_spans as ps


def read(run):
    return ps.per_job(run, ps.idle_s(run, "load.fill"))
