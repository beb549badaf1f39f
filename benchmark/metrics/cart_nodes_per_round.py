"""cart_nodes_per_round: the frontier nodes the forest scores a round, over
the window's ``cart.round`` spans (their ``nodes`` counts summed, over
their number): how wide each round's batched device call is."""

from harness import program_spans as ps


def read(run):
    rounds = ps.named(run, "cart.round")
    if not rounds:
        return None
    return sum(r.counts.get("nodes", 0) for r in rounds) / len(rounds)
