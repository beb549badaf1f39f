"""Forest-batched CART growth: many trees, one device pass per level (the
port of ``grm_tpu/parallel/cart_forest.py``).

The reference trains each (criterion x class_importance x max_depth x
min_samples_split) hyperparameter combination's per-fold and master trees
in separate forked workers, each re-sweeping the bit matrix node by node
(``bin/kover/core/kover/learning/experiments/experiment_cart.py:437-487``
over ``learners/cart.py:219-250``). Here the whole CV grid grows as ONE
level-synchronous forest: every live tree's frontier joins a single kernel
launch per criterion per round (per-node altered priors make nodes of
different folds / class importances batchable —
:func:`grm_tpu_torch.ops.cart_sweep.cart_frontier_scores`), so the number
of full-matrix sweeps per round is the number of *criteria in play* (<= 2),
not the number of trees.

This is the CART analogue of the SCM iteration-major grid engine
(:mod:`grm_tpu_torch.parallel.scm_grid`).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..learning.cart import ColumnFetchRequest, service_frontier_request
from .cart_device import cart_frontier_splits_device
from .cart_exact import cart_frontier_candidates

__all__ = ["grow_trees_batched"]


def _group_key(request):
    """Requests that may share one device call: the criterion is fixed per
    launch, the matrix and mesh must match, the launch takes one exclusion
    mask (identical blacklists still batch), and one engine serves it."""
    excl_key = (
        None if request.excl is None else request.excl.tobytes()
    )
    return (request.criterion, id(request.bit_matrix), request.mesh,
            excl_key, request.exact)


def grow_trees_batched(jobs):
    """Grow many CART trees with batched frontier scoring.

    ``jobs``: list of ``(classifier, fit_kwargs)`` pairs —
    ``classifier.fit_stepwise(**fit_kwargs)`` drives each tree. Trees using
    the host engine (which never yield) simply complete during their first
    advance. Each round, the pending frontier requests of all live trees
    are grouped by (criterion, matrix, mesh, blacklist, engine) and every
    group is scored in ONE device call with per-node priors; trees of different
    depths batch freely (level-synchrony matters within a tree, not across
    trees).

    On return every classifier's ``decision_tree`` is fitted, exactly as if
    each had been ``fit`` separately.
    """
    gens = {}
    results = {}
    for t, (classifier, kwargs) in enumerate(jobs):
        gens[t] = classifier.fit_stepwise(**kwargs)

    live = set(gens)
    while live:
        requests = {}
        for t in sorted(live):
            try:
                if t in results:
                    requests[t] = gens[t].send(results.pop(t))
                else:
                    requests[t] = next(gens[t])
            except StopIteration:
                live.discard(t)
        if not requests:
            break

        # Winner-column fetches: ONE device gather per provider per round
        # serves every tree's frontier columns.
        col_ts = [t for t in sorted(requests)
                  if isinstance(requests[t], ColumnFetchRequest)]
        if col_ts:
            by_provider = defaultdict(list)
            for t in col_ts:
                rc = requests[t].rule_classifications
                # Group by the underlying matrix: every HP combo has its
                # own KmerRuleClassifications but they share the dataset's
                # cached bit matrix.
                by_provider[id(getattr(rc, "bit_matrix", rc))].append(t)
            for members in by_provider.values():
                rc = requests[members[0]].rule_classifications
                spans, cat = [], []
                for t in members:
                    lo = len(cat)
                    cat.extend(np.asarray(requests[t].cols).tolist())
                    spans.append((t, lo, len(cat)))
                block = rc.get_columns(np.asarray(cat, dtype=np.int64))
                for t, lo, hi in spans:
                    results[t] = block[:, lo:hi]
            for t in col_ts:
                del requests[t]

        groups = defaultdict(list)
        for t in sorted(requests):
            groups[_group_key(requests[t])].append(t)

        for members in groups.values():
            head = requests[members[0]]
            node_sets, priors, totals, trains, equivs, occs = (
                [], [], [], [], [], [])
            defers, spans = [], []
            for t in members:
                req = requests[t]
                lo = len(node_sets)
                node_sets.extend(req.node_sets)
                priors.extend([req.altered_priors] * len(req.node_sets))
                totals.extend(
                    [req.total_n_examples_by_class] * len(req.node_sets)
                )
                trains.extend([req.train_idx] * len(req.node_sets))
                equivs.extend([req.need_equiv] * len(req.node_sets))
                occs.extend([req.occ_tiebreak] * len(req.node_sets))
                defers.extend([req.defer_equiv] * len(req.node_sets))
                spans.append((t, lo, len(node_sets)))
            if len(members) == 1:
                scored = service_frontier_request(head)
            else:
                scored = _service_batched(head, node_sets, priors, totals,
                                          trains, equivs, occs, defers)
            for t, lo, hi in spans:
                results[t] = scored[lo:hi]


def _service_batched(head, node_sets, priors, totals, trains, equivs, occs,
                     defers):
    """One device call over the concatenated frontier with per-node priors
    (and, for the exact engine, per-node train sets and options)."""
    if head.exact:
        return [
            ("exact", d) for d in cart_frontier_candidates(
                head.bit_matrix, node_sets, priors, totals, head.criterion,
                trains, excl=head.excl, mesh=head.mesh, need_equiv=equivs,
                occ_tiebreak=occs, defer_equiv=defers,
            )
        ]
    return cart_frontier_splits_device(
        head.bit_matrix, node_sets, priors, totals, head.criterion,
        excl=head.excl, mesh=head.mesh,
    )
