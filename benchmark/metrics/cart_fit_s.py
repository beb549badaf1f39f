"""cart_fit_s: the mean seconds of a job's ``fit`` span in ``learn tree``:
``learn_CART`` (every fold's tree and the master grown as one forest by
the exact engine, the pruning, the CV alpha, the predictions), ended by a
synchronize."""


def read(run):
    return run.spans.mean_s("fit") if run.spans else None
