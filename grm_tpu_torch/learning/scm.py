"""Set Covering Machine learner (Marchand & Shawe-Taylor 2003); the port's
copy of ``grm_tpu/learning/scm.py``.

Greedy rule selection with decision semantics bit-identical to the
reference (``learning/learners/scm.py``): utility = negative-cover −
p·positive-errors scanned blockwise in float64 with np.allclose/np.isclose
tie accumulation (scm.py:262-286), zero-coverage rules skipped
(scm.py:108-114), user tiebreaker hook, disjunction = conjunction on
inverted labels with inverted rules (scm.py:69-73, 180-184). The blockwise
scan's op order and tolerances are parity-forced; everything around it is
this framework's own structure.

The per-iteration counts come from one multi-mask masked-popcount pass over
the device-resident bit matrix (the ``popcount_colsum`` kernel) for both the
negatives and the positives.
"""

from __future__ import annotations

import logging
from math import ceil

import numpy as np

from .models import (
    ConjunctionModel,
    DisjunctionModel,
    conjunction,
    disjunction,
)

__all__ = ["SetCoveringMachine", "UTIL_BLOCK_SIZE", "rule_importances"]

# Utility scan block width — part of the parity contract: np.allclose ties
# accumulate ACROSS blocks, so a different blocking can change tie sets
# (reference scm.py:29).
UTIL_BLOCK_SIZE = 1000000


def rule_importances(rule_classifications, model_rules_idx,
                     training_example_idx):
    """Per-rule share of the model's negative predictions (reference
    scm.py:32-36): of the training examples the conjunction rejects, the
    fraction each rule is responsible for rejecting."""
    votes = rule_classifications.get_columns(model_rules_idx)[
        training_example_idx]
    rejected = np.where(np.prod(votes, axis=1) == 0)[0]
    return (float(len(rejected)) - votes[rejected].sum(axis=0)) / len(rejected)


class SetCoveringMachine:
    """Greedy set cover over k-mer presence/absence rules.

    ``model_type`` is "conjunction" or "disjunction"; a disjunction is
    learned as a conjunction over swapped labels, and each selected rule
    is inverted as it enters the model (De Morgan — reference
    scm.py:69-73, 180-184).
    """

    def __init__(self, model_type=conjunction, p=1.0, max_rules=10):
        if model_type == conjunction:
            self.model = ConjunctionModel()
        elif model_type == disjunction:
            self.model = DisjunctionModel()
        else:
            raise ValueError("Unsupported model type.")
        self.model_type = model_type
        self.p = p
        self.max_rules = max_rules
        self.rule_importances = []

    def fit(self, rules, rule_classifications, positive_example_idx,
            negative_example_idx, rule_blacklist=(), tiebreaker=None,
            iteration_callback=None, iteration_rule_importances=False):
        """Grow the model one rule per iteration until every negative is
        covered or ``max_rules`` is reached.

        ``iteration_callback`` receives, per added rule, a dict with the
        keys the experiment drivers consume: ``iteration_number``,
        ``selected_rule``, ``equivalent_rules_idx`` and (when
        ``iteration_rule_importances``) ``rule_importances``.
        """
        if len(positive_example_idx) == 0 or len(negative_example_idx) == 0:
            raise ValueError(
                "There must be positive and negative examples to train the SCM."
            )
        if rule_classifications.shape[1] != len(rules):
            raise ValueError(
                "The number of rules must match between rule_classifications and rules."
            )

        remaining_pos = positive_example_idx
        remaining_neg = negative_example_idx
        if self.model_type == disjunction:
            remaining_pos, remaining_neg = remaining_neg, remaining_pos

        rule_blacklist = np.asarray(rule_blacklist, dtype=np.int64)
        if len(rule_blacklist) > 0:
            rule_blacklist = np.unique(rule_blacklist)
            if len(rule_blacklist) == rule_classifications.shape[1]:
                raise ValueError("The blacklist cannot include all the rules.")

        train_idx = np.hstack((remaining_pos, remaining_neg))
        selected_rules_idx = []
        importances = []

        while len(remaining_neg) > 0 and len(self.model) < self.max_rules:
            utility, candidates, pos_errors, neg_cover = (
                self._get_best_utility_rules(
                    rule_classifications=rule_classifications,
                    positive_example_idx=remaining_pos,
                    negative_example_idx=remaining_neg,
                    rule_blacklist=rule_blacklist,
                ))

            # A rule that covers no negatives and errs on no positives
            # would make the greedy step vacuous (scm.py:108-114).
            candidates = candidates[(neg_cover != 0) | (pos_errors != 0)]
            if len(candidates) == 0:
                logging.debug(
                    "The max-utility rule covers no negatives and makes no "
                    "positive errors; stopping.")
                break

            if len(candidates) == 1:
                tie_set = np.array([candidates[0]])
            else:
                tie_set = tiebreaker(candidates)
            winner_idx = tie_set[0]

            rule = rules[winner_idx]
            if self.model_type == disjunction:
                rule = rule.inverse()
            self.model.add(rule)
            selected_rules_idx.append(winner_idx)

            # Drop covered negatives and misclassified positives: both are
            # the examples the winning rule votes 0 on.
            winner_votes = rule_classifications.get_columns(int(winner_idx))
            remaining_neg = remaining_neg[winner_votes[remaining_neg] != 0]
            remaining_pos = remaining_pos[winner_votes[remaining_pos] != 0]

            info = {
                "iteration_number": len(self.model),
                "selected_rule": rule,
                "equivalent_rules_idx": tie_set,
            }
            if iteration_rule_importances:
                importances = rule_importances(
                    rule_classifications, selected_rules_idx, train_idx)
                info["rule_importances"] = importances
            if iteration_callback is not None:
                iteration_callback(info)

        if selected_rules_idx:
            self.rule_importances = (
                importances if iteration_rule_importances
                else rule_importances(rule_classifications,
                                      selected_rules_idx, train_idx))
        else:
            self.rule_importances = []

    def predict(self, X):
        if len(self.model) == 0:
            raise RuntimeError("A model must be fitted prior to calling predict.")
        return self.model.predict(X)

    def _get_best_utility_rules(self, rule_classifications, positive_example_idx,
                                negative_example_idx, rule_blacklist=()):
        n_kmers = rule_classifications.shape[1] // 2
        rule_is_blacklisted = np.zeros(rule_classifications.shape[1], dtype=bool)
        rule_is_blacklisted[np.asarray(rule_blacklist, dtype=np.int64)] = True

        # ONE device pass for both row sets; absence-rule counts derived on
        # host (presence count of absence rule = n_rows - presence count).
        has_pos = positive_example_idx.shape[0] > 0
        row_sets = [negative_example_idx] + ([positive_example_idx] if has_pos else [])
        counts = rule_classifications.presence_counts(row_sets)

        n_neg = negative_example_idx.shape[0]
        negative_cover_counts = np.empty(2 * n_kmers, dtype=np.int64)
        # presence rules: covered negatives = negatives where k-mer absent
        negative_cover_counts[:n_kmers] = n_neg - counts[0]
        # absence rules: sum_rows gives n_neg - presence -> cover = presence
        negative_cover_counts[n_kmers:] = counts[0]

        positive_error_counts = np.zeros(2 * n_kmers, dtype=np.int64)
        if has_pos:
            n_pos = positive_example_idx.shape[0]
            positive_error_counts[:n_kmers] = n_pos - counts[1]
            positive_error_counts[n_kmers:] = counts[1]

        # Blockwise float64 utility max with reference tie accumulation
        # (scm.py:258-286) — op order and tolerances are the parity
        # contract here, including the allclose/isclose asymmetry.
        best_utility = -np.inf
        best_utility_idx = np.array([])
        best_utility_pos_error_count = np.array([])
        best_utility_neg_cover_count = np.array([])
        n_rules = 2 * n_kmers
        for block in range(int(ceil(1.0 * n_rules / UTIL_BLOCK_SIZE))):
            lo = block * UTIL_BLOCK_SIZE
            hi = min(n_rules, (block + 1) * UTIL_BLOCK_SIZE)
            block_utilities = negative_cover_counts[lo:hi] - float(
                self.p
            ) * positive_error_counts[lo:hi].astype(np.float64)
            block_utilities[rule_is_blacklisted[lo:hi]] = -np.inf

            block_max_utility = np.max(block_utilities)
            if block_max_utility > best_utility or np.allclose(
                best_utility, block_max_utility
            ):
                block_utility_argmax = (
                    np.where(np.isclose(block_utilities, block_max_utility))[0] + lo
                )
                if np.allclose(block_max_utility, best_utility):
                    best_utility_idx = np.hstack(
                        (best_utility_idx, block_utility_argmax)
                    )
                    best_utility_pos_error_count = np.hstack(
                        (
                            best_utility_pos_error_count,
                            positive_error_counts[block_utility_argmax],
                        )
                    )
                    best_utility_neg_cover_count = np.hstack(
                        (
                            best_utility_neg_cover_count,
                            negative_cover_counts[block_utility_argmax],
                        )
                    )
                else:
                    best_utility = block_max_utility
                    best_utility_idx = block_utility_argmax
                    best_utility_pos_error_count = positive_error_counts[
                        block_utility_argmax
                    ]
                    best_utility_neg_cover_count = negative_cover_counts[
                        block_utility_argmax
                    ]

        return (
            best_utility,
            best_utility_idx,
            best_utility_pos_error_count,
            best_utility_neg_cover_count,
        )
