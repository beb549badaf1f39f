"""scm_sweep_s: the mean seconds a job of the program's ``scm.sweep``
spans: each greedy step's pass 1 (``scm_sweep_sbmax``) and the download of
its maxima, the wait on the device included (``grm_tpu_torch/parallel/
scm_exact.py`` ``ExactScmEngine.run_fits``)."""

from harness import program_spans as ps


def read(run):
    return ps.per_job(run, ps.total_s(run, "scm.sweep"))
