"""cart_forest_trees: the trees grown in one forest, over the window's
``cart.grow`` spans (their ``trees`` counts summed, over their number):
every fold tree and master tree of the hyperparameter grid, grown as one
level-synchronous forest (``grm_tpu_torch/parallel/cart_forest.py``).
Where the grid's combinations grow apart, it falls by their number."""

from harness import program_spans as ps


def read(run):
    grows = [r for r in ps.named(run, "cart.grow") if "trees" in r.counts]
    if not grows:
        return None
    return sum(r.counts["trees"] for r in grows) / len(grows)
