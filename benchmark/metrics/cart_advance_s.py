"""cart_advance_s: the mean seconds a job of the program's ``cart.advance``
and ``cart.fetch`` spans: the forest's host bookkeeping between rounds,
each tree's generator advanced to its next request, and the rounds' column
fetches (``grm_tpu_torch/parallel/cart_forest.py``
``grow_trees_batched``)."""

from harness import program_spans as ps


def read(run):
    return ps.per_job(run, ps.total_s(run, ("cart.advance", "cart.fetch")))
