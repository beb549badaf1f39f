"""A plain reference of ``grm learn tree`` over a grid of class importances
with cross-validation, as GRM's GUI runs it (``src/kover.py:249``: 0.25,
0.5, 0.75 and 1.0 for each class, 16 combinations for two classes): every
combination's fold trees and master tree, each combination pruned and
scored by its folds, one combination selected, and that combination's
rules, tie sets, metrics and classifications.

The trees are :mod:`reference.cart`'s (its ``Grower``, ``prune``,
``predict`` and ``interval_value``), all combinations' trees grown in one
pass over each level. The selection over the grid follows Kover's
``train_tree`` (``experiment_cart.py:437-487``): a strictly lower score
wins; on a score that ``np.isclose`` ties with the best so far, the
smaller master tree wins, then the lower variance of the class
importances; and on such a win only the hyperparameters and the score
change hands, the master tree kept being the earlier one
(``experiment_cart.py:473-484``).

Where it departs from Kover:

- Kover forks a worker for each combination, which reopens the dataset
  and grows that combination's trees; here every tree of the grid grows in
  one process, the nodes of a level of all trees counted together. Each
  node is split from its own examples and its tree's priors alone, so no
  tree changes.
- Kover counts a node's k-mers with NumPy on the host; here the counts are
  plain ``torch`` integer products on the matrix's device, and the float64
  scores are tensors there (``reference.cart.Grower``), in Kover's order
  of operations.
- Only the Gini criterion and presence rules are modelled. The grid is
  the configuration's list of importance dicts, in its order, where GRM's
  GUI builds it from the command line's values as ``product(values,
  values)``.
- The pruning alphas and scores of the float32 control are float32
  throughout (``dtype``), where Kover has only float64.

NumPy and plain PyTorch only, nothing of the program; float64 unless
``dtype`` asks for another precision (the float32 control). TF32 is off.
"""

from __future__ import annotations

from math import sqrt

import numpy as np
import torch

from .cart import Grower, interval_value, predict, prune
from .scm import binary_metrics, metric_floats, metric_ints

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def importance_grid(settings, n_classes):
    """The configuration's class-importance dicts, in its order, keyed by
    class index."""
    return [{c: float(ci[str(c)]) for c in range(n_classes)}
            for ci in settings["class_importance"]]


def n_nodes(tree):
    """A tree's nodes, splits and leaves (Kover's ``len(tree)``)."""
    return len(tree.rules()) + len(tree.leaves())


def cv_choice(pm, labels, folds, fold_roots, master_root, dtype):
    """One combination's CV (experiment_cart.py:382-434): (score, pruned
    master tree, alpha)."""
    f_alpha = float if dtype == np.float64 else dtype
    fold_tables = []
    for f, root in zip(folds, fold_roots):
        alphas, trees = prune(root, f_alpha)
        y = labels[f["test"]]
        table = []
        for j, t in enumerate(trees):
            pred = predict(pm, t, f["test"])
            risk = dtype((pred != y).sum()) / dtype(len(y))
            hi = alphas[j + 1] if j < len(alphas) - 1 else np.inf
            table.append(((alphas[j], hi), risk))
        fold_tables.append(table)
    alphas, trees = prune(master_root, f_alpha)
    best, best_tree, best_alpha = np.inf, None, None
    for i, t in enumerate(trees):
        alpha = f_alpha(sqrt(alphas[i] * alphas[i + 1])) \
            if i < len(alphas) - 1 else np.inf
        score = np.mean([interval_value(tb, alpha) for tb in fold_tables])
        if score <= best:
            best, best_tree, best_alpha = score, t, alpha
    return best, best_tree, best_alpha


def select(results):
    """Kover's choice over the grid (experiment_cart.py:473-484).
    ``results``: [(importance dict, score, master tree)] in grid order.
    Returns (the index whose hyperparameters and score are chosen, the
    index whose master tree is kept, the decisions [(index, why)]), ``why``
    one of "lower" (a strictly lower score), "size" (a tie won by a smaller
    tree), "variance" (a tie won by a lower variance of the importances)
    and "tie" (a tie that changed nothing)."""
    best, kept, decisions = None, None, []
    best_score = np.inf
    for i, (importance, score, tree) in enumerate(results):
        if score < best_score:
            best, kept, best_score = i, i, score
            decisions.append((i, "lower"))
        elif np.isclose(score, best_score):
            size, best_size = n_nodes(tree), n_nodes(results[kept][2])
            var = np.var(list(importance.values()))
            best_var = np.var(list(results[best][0].values()))
            if size < best_size:
                why = "size"
            elif size == best_size and var < best_var:
                why = "variance"
            else:
                why = "tie"
            if why != "tie":
                # The hyperparameters and score only: the tree stays.
                best, best_score = i, score
            decisions.append((i, why))
    return best, kept, decisions


def grow_grid(pm, labels, split, settings, importances, dtype=np.float64):
    """Every combination's (score, master tree, alpha), in grid order: the
    fold trees and the master of all combinations grown as one set."""
    labels = np.asarray(labels)
    n_classes = len(importances[0])

    def by_class(idx):
        return {c: idx[labels[idx] == c] for c in range(n_classes)}

    folds = split["folds"]
    grower = Grower(pm, settings["max_depth"], settings["min_samples_split"],
                    dtype)
    specs = []
    for importance in importances:
        specs += [(by_class(f["train"]), importance, False) for f in folds]
        specs.append((by_class(split["train"]), importance, True))
    roots = grower.grow(specs)
    per = len(folds) + 1
    return [cv_choice(pm, labels, folds, roots[k * per:k * per + len(folds)],
                      roots[k * per + len(folds)], dtype)
            for k in range(len(importances))]


def learn_grid(pm, labels, genome_ids, kmer_sequences, split, settings,
               class_tags, dtype=np.float64):
    """Everything ``learn_CART(parameter_selection="cv")`` decides over the
    configuration's class-importance grid, as a fingerprint: the
    hyperparameters chosen (class importance included), the tree kept, its
    rules and tie sets, the floats and the metrics."""
    labels = np.asarray(labels)
    importances = importance_grid(settings, len(class_tags))
    choices = grow_grid(pm, labels, split, settings, importances, dtype)
    best, kept, _ = select([(imp, score, tree) for imp, (score, tree, _)
                            in zip(importances, choices)])
    score, _, alpha = choices[best]
    tree = choices[kept][1]
    fp = describe(pm, labels, genome_ids, kmer_sequences, split, tree,
                  class_tags, dtype)
    fp["hp"] = [settings["criterion"], int(settings["max_depth"]),
                float(settings["min_samples_split"]),
                [[c, v] for c, v in sorted(importances[best].items())]]
    fp["floats"] = dict([("score", float(score)),
                         ("pruning_alpha", float(alpha))]
                        + list(fp["floats"].items()))
    return fp


def describe(pm, labels, genome_ids, kmer_sequences, split, tree, class_tags,
             dtype=np.float64):
    """The fingerprint's parts that depend on the tree alone: its shape,
    rules, tie sets, importances, predictions' metrics and
    classifications."""
    train, test = split["train"], split["test"]
    train_pred = predict(pm, tree, train)
    test_pred = predict(pm, tree, test)
    train_m = binary_metrics(train_pred, labels[train], dtype)
    test_m = binary_metrics(test_pred, labels[test], dtype) \
        if len(test) else None
    ids = np.asarray(genome_ids)
    cls = {}
    ok = train_pred == labels[train]
    cls["train_correct"] = ids[train[ok]].tolist() \
        if train_m["risk"][0] < 1.0 else []
    cls["train_errors"] = ids[train[~ok]].tolist() \
        if train_m["risk"][0] > 0 else []
    if len(test):
        ok = test_pred == labels[test]
        cls["test_correct"] = ids[test[ok]].tolist() \
            if test_m["risk"][0] < 1.0 else []
        cls["test_errors"] = ids[test[~ok]].tolist() \
            if test_m["risk"][0] > 0 else []

    def seq(col):
        s = kmer_sequences[int(col)]
        return s.decode() if isinstance(s, bytes) else str(s)

    nodes = tree.rules()
    total = sum(n.importance for n in nodes) if nodes else 0.0
    imps = [n.importance / total if total > 0 else 0.0 for n in nodes]

    def shape(n):
        if n.is_leaf:
            return str(class_tags[n.prediction])
        return [seq(n.rule), shape(n.left), shape(n.right)]

    return {
        "tree": shape(tree),
        "rules": [(seq(n.rule), "presence") for n in nodes],
        "equiv": [[(seq(c), "presence") for c in
                   (n.equiv if n.equiv is not None else [n.rule])]
                  for n in nodes],
        "cls": {k: sorted(v) for k, v in cls.items()},
        "floats": dict(
            [("importance.%d" % i, float(v)) for i, v in enumerate(imps)]
            + metric_floats("train", train_m)
            + (metric_floats("test", test_m) if test_m else [])),
        "ints": dict(metric_ints("train", train_m)
                     + (metric_ints("test", test_m) if test_m else [])),
    }
