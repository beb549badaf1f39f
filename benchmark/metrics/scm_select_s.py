"""scm_select_s: the mean seconds a job of the program's ``scm.select``
spans: each greedy step's host choice of every active fit's rule, the
float64 replay over its candidate pool (``ExactScmEngine._select_for_fit``)."""

from harness import program_spans as ps


def read(run):
    return ps.per_job(run, ps.total_s(run, "scm.select"))
