"""cart_finish_s: the mean seconds a job of the program's ``cart.finish``
and ``cart.predict`` spans: the one fetch of the grown trees' columns, the
pruning and the folds' scoring (``_cv_finish``), and the chosen tree's
predictions (``grm_tpu_torch/learning/experiments/cart_experiment.py``)."""

from harness import program_spans as ps


def read(run):
    return ps.per_job(run, ps.total_s(run, ("cart.finish", "cart.predict")))
