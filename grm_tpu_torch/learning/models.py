"""Rule and model types: k-mer rules, SCM conjunction/disjunction models and
the CART tree model.

The port's copy of ``grm_tpu/learning/models.py``.
Numerical semantics (float32 products in SCM predict_proba, uint8 output,
>0.5 threshold) mirror the reference ``learning/common/models.py:109-182`` and
``rules.py:27-55`` so predictions are bit-identical.
"""

from __future__ import annotations

import numpy as np

conjunction = "conjunction"
disjunction = "disjunction"
scm = "scm"
cart = "cart"

__all__ = [
    "KmerRule",
    "ConjunctionModel",
    "DisjunctionModel",
    "CARTModel",
    "conjunction",
    "disjunction",
]


class KmerRule:
    """A presence/absence rule on one k-mer (reference rules.py:27-55)."""

    __slots__ = ("kmer_index", "kmer_sequence", "type", "importance",
                 "equivalent_rules_idx")

    def __init__(self, kmer_index, kmer_sequence, type):
        self.kmer_index = kmer_index
        self.kmer_sequence = kmer_sequence
        self.type = type
        self.importance = None
        self.equivalent_rules_idx = None

    def classify(self, X):
        if self.type == "absence":
            return (X[:, self.kmer_index] == 0).astype(np.uint8)
        return (X[:, self.kmer_index] == 1).astype(np.uint8)

    def inverse(self):
        return KmerRule(
            kmer_index=self.kmer_index,
            kmer_sequence=self.kmer_sequence,
            type="absence" if self.type == "presence" else "presence",
        )

    def __str__(self):
        prefix = "Absence(" if self.type == "absence" else "Presence("
        return prefix + str(self.kmer_sequence) + ")"


class BaseModel:
    def predict(self, X):
        raise NotImplementedError()

    def predict_proba(self, X):
        raise NotImplementedError()

    @property
    def learner(self):
        raise NotImplementedError()

    def __str__(self):
        return self._to_string()


class SCMModel(BaseModel):
    def __init__(self):
        self.rules = []

    def add(self, rule):
        self.rules.append(rule)

    def predict(self, X):
        predictions = self.predict_proba(X)
        predictions[predictions > 0.5] = 1
        predictions[predictions <= 0.5] = 0
        return np.asarray(predictions, dtype=np.uint8)

    def remove(self, index):
        del self.rules[index]

    @property
    def learner(self):
        return scm

    @property
    def type(self):
        raise NotImplementedError()

    def _to_string(self, separator=" "):
        return separator.join(str(a) for a in self.rules)

    def __iter__(self):
        return iter(self.rules)

    def __len__(self):
        return len(self.rules)


class ConjunctionModel(SCMModel):
    def predict_proba(self, X):
        predictions = np.ones(X.shape[0], np.float32)
        for a in self.rules:
            predictions *= a.classify(X)
        return predictions

    @property
    def type(self):
        return conjunction

    def __str__(self):
        return self._to_string(separator=" and ")


class DisjunctionModel(SCMModel):
    def predict_proba(self, X):
        predictions = np.ones(X.shape[0], dtype=np.float32)
        for a in self.rules:
            predictions *= 1.0 - a.classify(X)
        return 1.0 - predictions

    @property
    def type(self):
        return disjunction

    def __str__(self):
        return self._to_string(separator=" or ")


class CARTModel(BaseModel):
    """Decision-tree model wrapper with class-tag rendering (models.py:46-106)."""

    def __init__(self, class_tags=None):
        self.decision_tree = None
        self.class_tags = class_tags

    def predict(self, X):
        if self.decision_tree is None:
            raise RuntimeError("A decision tree must be fitted prior to calling predict.")
        return np.asarray(self.decision_tree.predict(X), dtype=np.uint8)

    def predict_proba(self, X):
        if self.decision_tree is None:
            raise RuntimeError("A decision tree must be fitted prior to calling predict.")
        return self.decision_tree.predict_proba(X)

    @property
    def learner(self):
        return cart

    def _to_string(self, node=None, depth=0):
        if node is None:
            node = self.decision_tree
        if self.class_tags is None:
            return str(self.decision_tree)
        tree_str = ""
        if node.is_leaf:
            tree_str += "\n" + ("    " * depth) + str(self.class_tags[node.class_prediction])
        else:
            tree_str += self._to_string(node=node.right_child, depth=depth + 1)
            tree_str += "\n" + ("    " * depth + "   ") + "/"
            tree_str += "\n" + ("    " * depth) + str(node.rule)
            tree_str += "\n" + ("    " * depth + "   ") + "\\"
            tree_str += self._to_string(node=node.left_child, depth=depth + 1)
        return tree_str

    def __len__(self):
        if self.decision_tree is None:
            return 0
        return len(self.decision_tree)

    @property
    def depth(self):
        if self.decision_tree is None:
            return 0
        return self.decision_tree.tree_depth
