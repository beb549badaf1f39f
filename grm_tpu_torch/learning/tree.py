"""Decision-tree node structures with Breiman-style node statistics (the
port's copy of ``grm_tpu/learning/tree.py``; numpy only).

Covers the role of the reference's ``learning/common/tree.py`` with this
framework's own structure: nodes carry the class-weighted probability
estimates from Breiman et al. (1984, *Classification and Regression
Trees*) that the pruning machinery consumes, preorder iteration, leaf/rule
harvesting, and probabilistic prediction. Prediction is vectorized by
partitioning example indices down the tree (one ``classify`` per node over
its examples) instead of a per-example Python walk; class ties resolve to
the lowest class index (np.argmax), matching the reference semantics.
"""

from __future__ import annotations

import numpy as np

__all__ = ["NodeStats", "BreimanInfo", "TreeNode", "ProbabilisticTreeNode"]


class NodeStats:
    """Altered-prior probability estimates for one node.

    Built from the node's per-class example counts: with resubstitution
    estimates, the probability that a class-``j`` example lands in this
    node is the class prior scaled by the fraction of the class's training
    examples the node holds. From those joint probabilities follow the
    node mass (``p_t``), the within-node class posteriors
    (``p_j_given_t``), and the node's misclassification contribution
    (``r_t``, ``R_t``) that weakest-link pruning minimizes. Notation is
    Breiman's book notation, kept because the pruning literature (and the
    reference's reports) speak it.
    """

    __slots__ = ("p_j_t", "p_t", "p_j_given_t", "r_t", "R_t")

    def __init__(self, *, node_counts, priors, class_totals):
        classes = sorted(priors)
        self.p_j_t = {
            j: priors[j] * node_counts[j] / class_totals[j] for j in classes
        }
        self.p_t = sum(self.p_j_t.values())
        self.p_j_given_t = {j: self.p_j_t[j] / self.p_t for j in classes}
        self.r_t = 1.0 - max(self.p_j_given_t.values())
        self.R_t = self.r_t * self.p_t


# The pruning-layer name this framework has always exposed.
BreimanInfo = NodeStats


class TreeNode:
    """One node of a binary k-mer decision tree.

    Splits send rule-TRUE examples left. ``class_examples_idx`` maps each
    class to the training-example indices the node holds; the node's
    statistics are derived from it at construction.
    """

    def __init__(self, class_examples_idx, class_priors,
                 total_n_examples_by_class, depth=0, criterion_value=None,
                 rule=None, parent=None, left_child=None, right_child=None):
        self.class_examples_idx = class_examples_idx
        self.depth = depth
        self.criterion_value = criterion_value
        self.rule = rule
        self.parent = parent
        self.left_child = left_child
        self.right_child = right_child
        self.breiman_info = NodeStats(
            node_counts={c: len(idx)
                         for c, idx in class_examples_idx.items()},
            priors=class_priors,
            class_totals=total_n_examples_by_class,
        )

    @property
    def is_leaf(self):
        return self.rule is None and self.left_child is None and self.right_child is None

    @property
    def is_root(self):
        return self.parent is None

    @property
    def n_examples(self):
        return sum(len(idx) for idx in self.class_examples_idx.values())

    @property
    def class_proportions(self):
        n = self.n_examples
        return {c: float(len(idx)) / n for c, idx in self.class_examples_idx.items()}

    @property
    def class_prediction(self):
        """Class with max posterior; ties -> lowest class index."""
        classes = sorted(self.breiman_info.p_j_given_t)
        values = [self.breiman_info.p_j_given_t[c] for c in classes]
        return classes[int(np.argmax(values))]

    @property
    def rules(self):
        def _get(node):
            if node.is_leaf:
                return []
            return [node.rule] + _get(node.left_child) + _get(node.right_child)

        return _get(self)

    @property
    def leaves(self):
        def _get(node):
            if node.is_leaf:
                return [node]
            return _get(node.left_child) + _get(node.right_child)

        return _get(self)

    @property
    def tree_depth(self):
        def _get(node):
            if node.is_leaf:
                return node.depth
            return max(_get(node.left_child), _get(node.right_child))

        return _get(self)

    def __iter__(self):
        def _preorder(node):
            nodes = [node]
            if not node.is_leaf:
                nodes += _preorder(node.left_child)
                nodes += _preorder(node.right_child)
            return nodes

        for node_id, node in enumerate(_preorder(self)):
            yield node_id, node

    def __len__(self):
        return len(self.rules) + len(self.leaves)

    def __str__(self, depth=0):
        # Right branch above, left below — the reference's report layout,
        # kept so report.txt trees render identically.
        if self.is_leaf:
            return "\n" + ("    " * depth) + str(self.class_prediction)
        out = self.right_child.__str__(depth=depth + 1)
        out += "\n" + ("    " * depth + "   ") + "/"
        out += "\n" + ("    " * depth) + str(self.rule)
        out += "\n" + ("    " * depth + "   ") + "\\"
        out += self.left_child.__str__(depth=depth + 1)
        return out


class ProbabilisticTreeNode(TreeNode):
    def predict(self, X):
        """argmax over class probabilities; ties -> lowest class index."""
        class_probabilities = self.predict_proba(X)
        return np.argmax(class_probabilities, axis=0)

    def predict_proba(self, X):
        """Vectorized tree walk: partition example indices down the tree."""
        X = np.ascontiguousarray(X)
        classes = sorted(self.class_examples_idx)
        proba = np.zeros((len(classes), X.shape[0]))

        def _fill(node, idx):
            if idx.shape[0] == 0:
                return
            if node.is_leaf:
                for ci, c in enumerate(classes):
                    proba[ci, idx] = node.breiman_info.p_j_given_t[c]
                return
            branch_left = node.rule.classify(X[idx]).astype(bool)
            _fill(node.left_child, idx[branch_left])
            _fill(node.right_child, idx[~branch_left])

        _fill(self, np.arange(X.shape[0]))
        return proba
