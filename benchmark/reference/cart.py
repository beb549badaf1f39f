"""A plain reference of ``grm learn tree`` with cross-validation: every
fold's tree and the master tree grown to the maximum depth, minimal
cost-complexity pruning, the pruning alpha chosen by the folds' test
risks, the master's rules with their equivalent rules and importances,
the predictions, metrics and classifications.

It follows Kover's published CART (``learning/learners/cart.py``,
``learning/experiments/experiment_cart.py``; Drouin et al. 2019): altered
priors from the class importances, the Gini index of both children
weighted by their mass in float64, the presence rules only, exact ties
broken by the k-mer present in the most training examples of the tree
(``isclose``) and then the lowest column, nodes grown level by level and
split while impure with at least ``min_samples_split`` examples, the
collapse of splits that lower no risk, the weakest links with NumPy's
``allclose``, fold risks by alpha interval and the master's prunings
scored at geometric means of its alphas (a later equal score wins).
NumPy and plain PyTorch only, nothing of the program. Binary or
multi-class; Gini only (the configuration's criterion).
"""

from __future__ import annotations

from math import sqrt

import numpy as np
import torch

from .scm import binary_metrics, metric_floats, metric_ints


class Node:
    """A tree node: its examples by class, its statistics (scalars of type
    ``f``), its split."""

    def __init__(self, idx, depth, priors, totals, f, parent=None):
        self.idx, self.depth, self.parent = idx, depth, parent
        self.rule = None  # the k-mer column that sends examples left
        self.left = self.right = None
        self.importance = None
        self.equiv = None
        counts = {c: f(len(v)) for c, v in idx.items()}
        self.crit = gini(priors, totals, counts, False, f)
        p_j_t = {j: priors[j] * counts[j] / totals[j] for j in sorted(priors)}
        self.p_t = sum(p_j_t.values())
        self.p_j_given_t = {j: p_j_t[j] / self.p_t for j in sorted(priors)}
        self.R_t = (f(1.0) - max(self.p_j_given_t.values())) * self.p_t

    @property
    def is_leaf(self):
        return self.rule is None

    @property
    def n_examples(self):
        return sum(len(v) for v in self.idx.values())

    @property
    def prediction(self):
        classes = sorted(self.p_j_given_t)
        return classes[int(np.argmax([self.p_j_given_t[c] for c in classes]))]

    def leaves(self):
        return [self] if self.is_leaf else \
            self.left.leaves() + self.right.leaves()

    def rules(self):
        """The split nodes in preorder."""
        return [] if self.is_leaf else \
            [self] + self.left.rules() + self.right.rules()

    def copy(self, parent=None):
        out = Node.__new__(Node)
        out.__dict__.update(self.__dict__)
        out.parent = parent
        if not self.is_leaf:
            out.left = self.left.copy(out)
            out.right = self.right.copy(out)
        return out

    def cut(self):
        self.rule = self.left = self.right = None


def altered_priors(idx, importance, f):
    """(class priors weighted by importance, class totals) of a tree's
    training examples (cart.py:71-77), scalars of type ``f``."""
    classes = sorted(idx)
    totals = {c: f(len(idx[c])) for c in classes}
    total = sum(totals.values())
    priors = {c: totals[c] / total for c in classes}
    denum = sum(f(importance[c]) * priors[c] for c in classes)
    return {c: f(importance[c]) * priors[c] / denum for c in classes}, totals


def gini(priors, totals, counts, weighted, f):
    """The Gini index of class ``counts`` (scalars of type ``f``, or
    tensors, which keep their own type), times the node's mass where
    ``weighted`` (cart.py:85-110), in Kover's order of operations."""
    if isinstance(next(iter(counts.values())), torch.Tensor):
        priors = {c: float(v) for c, v in priors.items()}
        totals = {c: float(v) for c, v in totals.items()}
        one = 1.0
    else:
        one = f(1.0)
    p_j_t = {c: one * priors[c] * counts[c] / totals[c] for c in counts}
    p_t = sum(p_j_t.values())
    with np.errstate(divide="ignore", invalid="ignore"):
        p = {c: p_j_t[c] / p_t for c in p_j_t}
    g = sum(p[i] * p[j] for i in p for j in p if i != j)
    return g * (p_t if weighted else one)


class Grower:
    """Trees grown level by level over the packed matrix ``pm``
    (:class:`reference.scm.PackedMatrix`), all trees' nodes of a level
    counted in one pass."""

    def __init__(self, pm, max_depth, min_samples_split, dtype=np.float64,
                 group=64):
        self.pm, self.max_depth = pm, max_depth
        self.min_split = max(int(min_samples_split), 2)
        self.f = dtype
        self.tdt = torch.float64 if dtype == np.float64 else torch.float32
        self.group = group

    def grow(self, specs):
        """``specs``: [(examples by class, class importance, keep ties)].
        Returns the roots."""
        roots, trees = [], []
        occ_rows = np.zeros((len(specs), self.pm.n), np.int8)
        for t, (idx, importance, keep_ties) in enumerate(specs):
            priors, totals = altered_priors(idx, importance, self.f)
            roots.append(Node(idx, 0, priors, totals, self.f))
            trees.append((priors, totals, keep_ties))
            occ_rows[t, np.hstack([idx[c] for c in sorted(idx)])] = 1
        occ = self.pm.counts(occ_rows)
        level = [(t, r) for t, r in enumerate(roots)]
        while level and level[0][1].depth < self.max_depth:
            split = [(t, n) for t, n in level
                     if 1.0 not in [len(v) / n.n_examples
                                    for v in n.idx.values()]
                     and n.n_examples >= self.min_split]
            level = []
            for g0 in range(0, len(split), self.group):
                part = split[g0:g0 + self.group]
                rows = []
                for _, n in part:
                    for c in sorted(n.idx):
                        row = np.zeros(self.pm.n, np.int8)
                        row[n.idx[c]] = 1
                        rows.append(row)
                counts = self.pm.counts(np.stack(rows))
                r = 0
                for t, n in part:
                    classes = sorted(n.idx)
                    left = {c: counts[r + i] for i, c in enumerate(classes)}
                    r += len(classes)
                    ties = self.best(n, left, trees[t][:2], occ[t])
                    if ties is None:
                        continue
                    self.split(n, int(ties[0]), trees[t][:2])
                    if trees[t][2]:
                        n.equiv = ties
                    level += [(t, n.left), (t, n.right)]
                del counts
        return roots

    def best(self, node, left_counts, prior_totals, occ):
        """The tie set of the node's best split (cart.py:112-250), or None."""
        priors, totals = prior_totals
        left = {c: v.to(self.tdt) for c, v in left_counts.items()}
        right = {c: float(len(node.idx[c])) - left[c] for c in left}
        vals = gini(priors, totals, left, True, self.f) + \
            gini(priors, totals, right, True, self.f)
        vals[sum(left.values()) == 0] = torch.inf
        vals[sum(right.values()) == 0] = torch.inf
        vmin = float(vals.min())
        if vmin == float("inf"):
            return None
        cands = torch.nonzero(vals == vmin).flatten()
        if cands.numel() == 1:
            return cands.cpu().numpy()
        o = occ[cands].cpu().numpy()
        return cands.cpu().numpy()[np.isclose(o, o.max())]

    def split(self, node, col, prior_totals):
        priors, totals = prior_totals
        bits = self.pm.column(col)
        li = {c: v[bits[v] == 1] for c, v in node.idx.items()}
        ri = {c: v[bits[v] == 0] for c, v in node.idx.items()}
        node.rule = col
        node.left = Node(li, node.depth + 1, priors, totals, self.f, node)
        node.right = Node(ri, node.depth + 1, priors, totals, self.f, node)
        node.importance = (node.p_t * node.crit
                           - node.left.p_t * node.left.crit
                           - node.right.p_t * node.right.crit)


def prune(tree, f=float):
    """Minimal cost-complexity pruning (cart.py:362-470): (alphas, trees);
    ``f`` the type of the alphas."""
    def leaf_parents(root):
        out, stack = [], [root]
        while stack:
            n = stack.pop()
            if not n.is_leaf:
                if n.left.is_leaf and n.right.is_leaf:
                    out.append(n)
                else:
                    stack += [n.left, n.right]
        return out

    def weakest(n):
        if n.is_leaf:
            return np.inf, [n]
        leaves = n.leaves()
        rt = sum(l.R_t for l in leaves)
        gt = f(n.R_t - rt) / (len(leaves) - 1)
        lg, ll = weakest(n.left)
        rg, rl = weakest(n.right)
        if np.allclose(gt, min(lg, rg)):
            if np.allclose(lg, rg):
                return gt, [n] + ll + rl
            return gt, [n] + (ll if lg < rg else rl)
        if gt < min(lg, rg):
            return gt, [n]
        if np.allclose(lg, rg):
            return lg, ll + rl
        return (rg, rl) if lg > rg else (lg, ll)

    t1 = tree.copy()
    parents = leaf_parents(t1)
    while parents:
        n = parents.pop()
        if np.allclose(n.R_t, n.left.R_t + n.right.R_t):
            n.cut()
            if n.parent is not None and n.parent.left.is_leaf \
                    and n.parent.right.is_leaf:
                parents.append(n.parent)
    seq, cur = [(0, t1)], t1
    while not cur.is_leaf:
        cur = cur.copy()
        gt, links = weakest(cur)
        for n in links:
            n.cut()
        seq.append((gt, cur))
    alphas, trees = zip(*seq)
    return alphas, trees


def predict(pm, tree, examples):
    """Each example's class: down the tree, present k-mers to the left."""
    out = np.empty(len(examples), np.int64)

    def walk(n, sel):
        if len(sel) == 0:
            return
        if n.is_leaf:
            out[sel] = n.prediction
            return
        go = pm.column(n.rule)[examples[sel]] == 1
        walk(n.left, sel[go])
        walk(n.right, sel[~go])

    walk(tree, np.arange(len(examples)))
    return out


def interval_value(table, key):
    """The value of the [lo, hi) interval that holds ``key``
    (experiment_cart.py:43-79)."""
    for (lo, hi), v in table:
        if (lo <= key < hi) or (lo <= key and hi == np.inf) or \
                (lo == -np.inf and key < hi):
            return v
    raise KeyError(key)


def learn_tree(pm, labels, genome_ids, kmer_sequences, split, settings,
               class_tags, dtype=np.float64):
    """Everything ``learn_CART(parameter_selection="cv")`` decides for one
    hyperparameter combination, as a fingerprint."""
    labels = np.asarray(labels)
    n_classes = len(class_tags)
    importance = {c: float(settings["class_importance"][str(c)])
                  for c in range(n_classes)}

    def by_class(idx):
        return {c: idx[labels[idx] == c] for c in range(n_classes)}

    folds = split["folds"]
    grower = Grower(pm, settings["max_depth"], settings["min_samples_split"],
                    dtype)
    roots = grower.grow([(by_class(f["train"]), importance, False)
                         for f in folds]
                        + [(by_class(split["train"]), importance, True)])
    fold_tables = []
    f_alpha = float if dtype == np.float64 else dtype
    for f, root in zip(folds, roots[:-1]):
        alphas, trees = prune(root, f_alpha)
        y = labels[f["test"]]
        table = []
        for j, t in enumerate(trees):
            pred = predict(pm, t, f["test"])
            risk = dtype((pred != y).sum()) / dtype(len(y))
            hi = alphas[j + 1] if j < len(alphas) - 1 else np.inf
            table.append(((alphas[j], hi), risk))
        fold_tables.append(table)
    alphas, trees = prune(roots[-1], f_alpha)
    best, best_tree, best_alpha = np.inf, None, None
    for i, t in enumerate(trees):
        alpha = f_alpha(sqrt(alphas[i] * alphas[i + 1])) \
            if i < len(alphas) - 1 else np.inf
        score = np.mean([interval_value(tb, alpha) for tb in fold_tables])
        if score <= best:
            best, best_tree, best_alpha = score, t, alpha

    train, test = split["train"], split["test"]
    train_pred = predict(pm, best_tree, train)
    test_pred = predict(pm, best_tree, test)
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

    nodes = best_tree.rules()
    total = sum(n.importance for n in nodes) if nodes else 0.0
    imps = [n.importance / total if total > 0 else 0.0 for n in nodes]

    def shape(n):
        if n.is_leaf:
            return str(class_tags[n.prediction])
        return [seq(n.rule), shape(n.left), shape(n.right)]

    return {
        "hp": [settings["criterion"], int(settings["max_depth"]),
               float(settings["min_samples_split"])],
        "tree": shape(best_tree),
        "rules": [(seq(n.rule), "presence") for n in nodes],
        "equiv": [[(seq(c), "presence") for c in
                   (n.equiv if n.equiv is not None else [n.rule])]
                  for n in nodes],
        "cls": {k: sorted(v) for k, v in cls.items()},
        "floats": dict(
            [("score", float(best)), ("pruning_alpha", float(best_alpha))]
            + [("importance.%d" % i, float(v)) for i, v in enumerate(imps)]
            + metric_floats("train", train_m)
            + (metric_floats("test", test_m) if test_m else [])),
        "ints": dict(metric_ints("train", train_m)
                     + (metric_ints("test", test_m) if test_m else [])),
    }
