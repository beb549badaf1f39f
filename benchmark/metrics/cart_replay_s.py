"""cart_replay_s: the mean seconds a job of the program's ``cart.replay``
spans: the exact engine's float64 host replay over the near-minimum
tuples (``grm_tpu_torch/parallel/cart_exact.py`` ``_run_tuple_regime``)."""

from harness import program_spans as ps


def read(run):
    return ps.per_job(run, ps.total_s(run, "cart.replay"))
