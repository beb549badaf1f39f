"""scm_fit_s: the mean seconds of a job's ``fit`` span in ``learn scm``:
``learn_SCM`` (the exact engine's cross-validation and full training, the
predictions, the bound), ended by a synchronize."""


def read(run):
    return run.spans.mean_s("fit") if run.spans else None
