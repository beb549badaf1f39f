"""cart_select_s: the mean seconds a job of the program's ``cart.select``
spans: ``train_tree``'s comparison of each hyperparameter combination's
CV score and master tree with the best so far, Kover's tie rules
included (``grm_tpu_torch/learning/experiments/cart_experiment.py``)."""

from harness import program_spans as ps


def read(run):
    return ps.per_job(run, ps.total_s(run, "cart.select"))
