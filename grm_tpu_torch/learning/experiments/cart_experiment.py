"""CART experiment: HP grid + CV/bound pruning + metrics (the port of
``grm_tpu/learning/experiments/cart_experiment.py``).

Mirrors the reference flow (``experiment_cart.py``): per-HP overgrown trees
on folds + master, minimal cost-complexity pruning, fold-risk-by-alpha via a
range dictionary, master tree scored at geometric-mean alphas (CV) or by the
tree sample-compression bound, and the reference's tie-handling in
``train_tree`` (including its quirk of keeping the previous master tree when
a tie prefers a smaller one, experiment_cart.py:473-484 — reproduced for
output parity).

The HP grid runs against the device-resident bit matrix (the reference
forks a worker per combination, re-opening the dataset each time): one tree
after the other with ``engine="host"``, all trees as one level-synchronous
forest with ``engine="device"`` and ``engine="device-argmax"``. Grid order
is deterministic ``product(criterion, class_importance, max_depth,
min_samples_split)``. With a ``mesh`` the device engines load the matrix
sharded over it and score every frontier shard by shard.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from copy import deepcopy
from functools import partial
from itertools import product
from math import sqrt

import numpy as np

from ...dataset.artifact import as_dataset
from ...utils import parse_kmer_blacklist
from ..bounds import cart_bound
from ...parallel.mesh import check_mesh, mesh_sharding
from ..cart import (
    DecisionTreeClassifier,
    DeferredEquiv,
    device_excl_from_blacklist,
    prune_tree,
)
from ..metrics import get_binary_metrics, get_multiclass_metrics
from ..models import CARTModel
from ..rules import KmerRuleClassifications, LazyKmerRuleList

__all__ = ["learn_CART"]


class BetweenDict(dict):
    """Dict keyed by half-open [lo, hi) ranges (experiment_cart.py:43-79)."""

    def __init__(self, d=None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = v

    def __getitem__(self, key):
        for k, v in self.items():
            if (
                (k[0] <= key < k[1])
                or (k[0] <= key and k[1] == np.inf)
                or (k[0] == -np.inf and key < k[1])
            ):
                return v
        raise KeyError("Key '%s' is not between any values in the BetweenDict" % key)

    def __setitem__(self, key, value):
        if len(key) != 2:
            raise ValueError("Key of a BetweenDict must be an iterable with length two")
        if not key[0] < key[1]:
            raise RuntimeError(
                "First element of a BetweenDict key must be strictly less than "
                "the second element. Got [%.6f, %.6f]" % (key[0], key[1])
            )
        dict.__setitem__(self, (key[0], key[1]), value)

    def __contains__(self, key):
        try:
            self[key]
            return True
        except KeyError:
            return False


def _tiebreaker(best_score_idx, rule_kmer_occurrences):
    """Prefer k-mers with the most occurrences in the training set
    (experiment_cart.py:82-94)."""
    tie = rule_kmer_occurrences[best_score_idx]
    return best_score_idx[np.isclose(tie, tie.max())]


def _split_callback(node, equivalent_rules_idx):
    node.rule.equivalent_rules_idx = equivalent_rules_idx


def _readdress_tree(tree, rule_new_idx_by_kmer_seq):
    """(experiment_cart.py:109-117)"""

    def _readdress(node, kmer_idx):
        if node.rule is not None:
            node.rule.kmer_index = kmer_idx[node.rule.kmer_sequence]
            _readdress(node.left_child, kmer_idx)
            _readdress(node.right_child, kmer_idx)

    new_tree = deepcopy(tree)
    _readdress(new_tree, rule_new_idx_by_kmer_seq)
    return new_tree


def _predictions(decision_tree, dataset, train_example_idx, test_example_idx,
                 progress_callback=None):
    """Predict by loading only the model's k-mer columns
    (experiment_cart.py:120-152)."""
    if progress_callback is None:
        progress_callback = lambda t, p: None
    progress_callback("Testing", 0.0)

    if len(decision_tree.rules) > 0:
        model_rules = decision_tree.rules
        kmer_idx_by_rule = np.array([r.kmer_index for r in model_rules])
        kmer_sequence_by_rule = np.array([r.kmer_sequence for r in model_rules])
        sort_by_idx = np.argsort(kmer_idx_by_rule)
        kmer_idx_by_rule = kmer_idx_by_rule[sort_by_idx]
        kmer_sequence_by_rule = kmer_sequence_by_rule[sort_by_idx]
        readdressed_kmer_idx = {s: i for i, s in enumerate(kmer_sequence_by_rule)}
        readdressed_tree = _readdress_tree(decision_tree, readdressed_kmer_idx)
        X = dataset.get_matrix_columns(kmer_idx_by_rule)
        train_predictions = readdressed_tree.predict(X[train_example_idx])
        test_predictions = readdressed_tree.predict(X[test_example_idx])
    else:
        train_predictions = decision_tree.predict(np.empty((len(train_example_idx), 1)))
        test_predictions = decision_tree.predict(np.empty((len(test_example_idx), 1)))
    progress_callback("Testing", 1.0)
    return train_predictions, test_predictions


class _ColumnCache:
    """One prefetched column block serving many tree families.

    Each ``dataset.get_matrix_columns`` call is a full device (or HDF5)
    round trip, so the batched HP search prefetches EVERY grown tree's rule
    columns in ONE call before the per-combo pruning/scoring phase.
    """

    def __init__(self, dataset, kmer_idx):
        self.idx = np.unique(np.asarray(kmer_idx, dtype=np.int64))
        self.pos = {int(k): i for i, k in enumerate(self.idx)}
        self.X = (dataset.get_matrix_columns(self.idx)
                  if len(self.idx) else None)

    def get(self, kmer_idx):
        return self.X[:, [self.pos[int(k)] for k in kmer_idx]]


def _family_predictor(trees, dataset, column_cache=None):
    """One column fetch serving a whole pruning family of trees.

    The (alpha, tree) sequences of :func:`prune_tree` are nested subtrees,
    so every tree's rules draw from the union of the family's k-mer
    columns. Fetching that union ONCE and predicting each tree against it
    replaces one ``get_matrix_columns`` round trip per pruned tree per
    fold (the reference pays the same per-tree HDF5 fetch,
    experiment_cart.py:120-152; predictions are identical — the per-tree
    column subset is the same bits). With ``column_cache`` (the batched
    search's whole-grid prefetch) there is no fetch at all.

    Returns ``predict(tree, example_idx) -> labels``.
    """
    seqs = {}
    for t in trees:
        for r in t.rules:
            seqs[r.kmer_sequence] = r.kmer_index
    if not seqs:
        return lambda tree, example_idx: tree.predict(
            np.empty((len(example_idx), 1)))
    kmer_idx = np.array(sorted(seqs.values()))
    idx_by_seq = {s: i for i, s in enumerate(
        sorted(seqs, key=lambda s: seqs[s]))}
    if column_cache is not None:
        X = column_cache.get(kmer_idx)
    else:
        X = dataset.get_matrix_columns(kmer_idx)

    def predict(tree, example_idx):
        if len(tree.rules) == 0:
            return tree.predict(np.empty((len(example_idx), 1)))
        readdressed = _readdress_tree(tree, idx_by_seq)
        return readdressed.predict(X[example_idx])

    return predict


def _class_example_idx(example_idx, labels, n_classes):
    return {c: example_idx[labels[example_idx] == c] for c in range(n_classes)}


def _lazy_tiebreaker(rule_classifications, example_idx):
    """Occurrence tiebreaker whose counts are fetched only when a tie
    actually needs breaking — and only for the tied columns when the tie
    set is small (a full 2K ``sum_rows`` fetch per tree would dominate)."""
    cache = {}

    def tiebreaker(best_score_idx, occurrences=None):
        best_score_idx = np.asarray(best_score_idx)
        if occurrences is not None:
            # The exact device engine ships each candidate's train-set
            # occurrence count with the candidate: no fetch at all.
            occ = np.asarray(occurrences)
        elif "occ" in cache:
            occ = cache["occ"][best_score_idx]
        elif len(best_score_idx) <= 1024:
            # Candidate-only occurrences: identical integers to
            # sum_rows(example_idx)[idx] (presence counts among the train
            # set), read via the few-column path.
            cols = rule_classifications.get_columns(best_score_idx)
            occ = cols[np.asarray(example_idx)].sum(axis=0)
        else:
            cache["occ"] = rule_classifications.sum_rows(example_idx)
            occ = cache["occ"][best_score_idx]
        return best_score_idx[np.isclose(occ, occ.max())]

    tiebreaker.accepts_occurrences = True
    return tiebreaker


def _bound_grow(hps, dataset, split_name, rule_blacklist, engine="host",
                mesh=None):
    """Build the master tree + its growth job for one HP combo (bound
    selection trains once on the full train set, experiment_cart.py:208-294)."""
    split = dataset.get_split(split_name)
    train_idx = split.train_genome_idx
    example_labels = dataset.phenotype.metadata
    n_classes = len(dataset.phenotype.tags)
    rules = LazyKmerRuleList(dataset)
    rule_classifications = KmerRuleClassifications(
        dataset, sharding=mesh_sharding(mesh))

    master = DecisionTreeClassifier(
        criterion=hps["criterion"],
        max_depth=hps["max_depth"],
        min_samples_split=hps["min_samples_split"],
        class_importance=hps["class_importance"],
        engine=engine,
        mesh=mesh,
        defer_equiv=True,
    )
    jobs = [(master, dict(
        rules=rules,
        rule_classifications=rule_classifications,
        example_idx=_class_example_idx(train_idx, example_labels, n_classes),
        rule_blacklist=rule_blacklist,
        tiebreaker=_lazy_tiebreaker(rule_classifications, train_idx),
        split_callback=_split_callback,
    ))]
    return master, jobs


def _bound_finish(hps, master, dataset, split_name, delta, max_genome_size,
                  column_cache=None, mesh=None):
    """Prune the grown master by bound value (experiment_cart.py:208-294)."""
    split = dataset.get_split(split_name)
    train_idx = split.train_genome_idx
    example_labels = dataset.phenotype.metadata
    n_classes = len(dataset.phenotype.tags)
    rule_classifications = KmerRuleClassifications(
        dataset, sharding=mesh_sharding(mesh))

    min_score = np.inf
    min_score_tree = None
    train_answers = example_labels[train_idx]
    alphas, pruned_trees = prune_tree(master.decision_tree)
    family_predict = _family_predictor(pruned_trees, dataset, column_cache)
    for alpha, tree in zip(alphas, pruned_trees):
        train_predictions = family_predict(tree, train_idx)
        bound_value = cart_bound(
            train_predictions=train_predictions,
            train_answers=train_answers,
            train_example_idx=train_idx,
            model=tree,
            delta=delta,
            max_genome_size=max_genome_size,
            rule_classifications=rule_classifications,
            n_classes=n_classes,
        )
        # alphas ascend: <= prefers the most-pruned tie (experiment_cart.py:287).
        if bound_value <= min_score:
            min_score = bound_value
            min_score_tree = tree
            hps["pruning_alpha"] = alpha
    return hps, min_score, min_score_tree


def _learn_pruned_tree_bound(hps, dataset, split_name, delta, max_genome_size,
                             rule_blacklist, engine="host", mesh=None):
    """Grow a master tree and prune by bound value (experiment_cart.py:208-294)."""
    master, jobs = _bound_grow(hps, dataset, split_name, rule_blacklist,
                               engine, mesh)
    for classifier, kwargs in jobs:
        classifier.fit(**kwargs)
    return _bound_finish(hps, master, dataset, split_name, delta,
                         max_genome_size, mesh=mesh)


def _cv_grow(hps, dataset, split_name, rule_blacklist, engine="host",
             mesh=None):
    """Build the per-fold + master trees and their growth jobs for one HP
    combo of the CV search (experiment_cart.py:297-380)."""
    split = dataset.get_split(split_name)
    train_idx = split.train_genome_idx
    example_labels = dataset.phenotype.metadata
    n_classes = len(dataset.phenotype.tags)
    rules = LazyKmerRuleList(dataset)
    rule_classifications = KmerRuleClassifications(
        dataset, sharding=mesh_sharding(mesh))

    def _make_predictor(defer_equiv=False):
        return DecisionTreeClassifier(
            criterion=hps["criterion"],
            max_depth=hps["max_depth"],
            min_samples_split=hps["min_samples_split"],
            class_importance=hps["class_importance"],
            engine=engine,
            mesh=mesh,
            defer_equiv=defer_equiv,
        )

    fold_predictors = [_make_predictor() for _ in split.folds]
    master_predictor = _make_predictor(defer_equiv=True)

    jobs = []
    for i, fold in enumerate(split.folds):
        jobs.append((fold_predictors[i], dict(
            rules=rules,
            rule_classifications=rule_classifications,
            example_idx=_class_example_idx(
                fold.train_genome_idx, example_labels, n_classes
            ),
            rule_blacklist=rule_blacklist,
            tiebreaker=_lazy_tiebreaker(
                rule_classifications, fold.train_genome_idx
            ),
        )))
    jobs.append((master_predictor, dict(
        rules=rules,
        rule_classifications=rule_classifications,
        example_idx=_class_example_idx(train_idx, example_labels, n_classes),
        rule_blacklist=rule_blacklist,
        tiebreaker=_lazy_tiebreaker(rule_classifications, train_idx),
        split_callback=_split_callback,
    )))
    return fold_predictors, master_predictor, jobs


def _cv_finish(hps, dataset, split_name, fold_predictors, master_predictor,
               column_cache=None):
    """CV cost-complexity pruning of grown trees (experiment_cart.py:382-434)."""
    split = dataset.get_split(split_name)
    example_labels = dataset.phenotype.metadata

    master_alphas, master_pruned_trees = prune_tree(master_predictor.decision_tree)
    fold_alphas, fold_pruned_trees = [], []
    for predictor in fold_predictors:
        alphas, trees = prune_tree(predictor.decision_tree)
        fold_alphas.append(alphas)
        fold_pruned_trees.append(trees)

    # Per-fold test risk per alpha interval (experiment_cart.py:392-412).
    # One column fetch per fold family instead of one per pruned tree.
    fold_scores_by_alpha = []
    for i, fold in enumerate(split.folds):
        fold_test_idx = fold.test_genome_idx
        fold_labels = example_labels[fold_test_idx]
        fold_predict = _family_predictor(fold_pruned_trees[i], dataset,
                                         column_cache)
        bro = BetweenDict()
        for j, t in enumerate(fold_pruned_trees[i]):
            fold_test_risk = get_binary_metrics(
                predictions=fold_predict(t, fold_test_idx),
                answers=fold_labels,
            )["risk"][0]
            if j < len(fold_alphas[i]) - 1:
                key = (fold_alphas[i][j], fold_alphas[i][j + 1])
            else:
                key = (fold_alphas[i][j], np.inf)
            bro[key] = fold_test_risk
        fold_scores_by_alpha.append(bro)

    # Score master prunings at geometric mean alphas (experiment_cart.py:414-431).
    min_score = np.inf
    min_score_tree = None
    for i, t in enumerate(master_pruned_trees):
        if i < len(master_alphas) - 1:
            geo_mean_alpha_k = sqrt(master_alphas[i] * master_alphas[i + 1])
        else:
            geo_mean_alpha_k = np.inf
        cv_score = np.mean(
            [fold_scores_by_alpha[j][geo_mean_alpha_k] for j in range(len(split.folds))]
        )
        if cv_score <= min_score:
            min_score = cv_score
            min_score_tree = t
            hps["pruning_alpha"] = geo_mean_alpha_k
    return hps, min_score, min_score_tree


def _learn_pruned_tree_cv(hps, dataset, split_name, rule_blacklist,
                          engine="host", mesh=None):
    """Breiman-style CV cost-complexity pruning (experiment_cart.py:297-434)."""
    fold_predictors, master_predictor, jobs = _cv_grow(
        hps, dataset, split_name, rule_blacklist, engine, mesh
    )
    for classifier, kwargs in jobs:
        classifier.fit(**kwargs)
    return _cv_finish(hps, dataset, split_name, fold_predictors,
                      master_predictor)


def _search_batched(hps_list, dataset, split_name, rule_blacklist, grow, finish):
    """Device-engine HP search: grow EVERY tree of EVERY HP combo as one
    level-synchronous forest (one kernel launch per criterion per
    round — the CART analogue of the SCM grid engine, replacing the
    reference's fork-per-HP pool, experiment_cart.py:437-487), then prune
    and score each combo. Yields (hps, score, tree) in grid order.

    Before the pruning/scoring phase, EVERY grown tree's rule columns
    prefetch in ONE device call (pruned trees are subtrees, so the grown
    trees' rules cover every family) — per-family fetches each cost a
    full round trip."""
    from ...parallel.cart_forest import grow_trees_batched

    states, all_jobs = [], []
    for hps in hps_list:
        *grown, jobs = grow(hps, dataset, split_name, rule_blacklist)
        states.append((hps, grown))
        all_jobs.extend(jobs)
    grow_trees_batched(all_jobs)
    all_rules = []
    for classifier, _ in all_jobs:
        if classifier.decision_tree is not None:
            all_rules.extend(
                r.kmer_index for r in classifier.decision_tree.rules)
    cache = _ColumnCache(dataset, all_rules)
    for hps, grown in states:
        yield finish(hps, grown, cache)


def _cv_search_batched(hps_list, dataset, split_name, rule_blacklist,
                       engine="device-argmax", mesh=None):
    return _search_batched(
        hps_list, dataset, split_name, rule_blacklist,
        grow=partial(_cv_grow, engine=engine, mesh=mesh),
        finish=lambda hps, grown, cache=None: _cv_finish(
            hps, dataset, split_name, grown[0], grown[1],
            column_cache=cache,
        ),
    )


def _bound_search_batched(hps_list, dataset, split_name, rule_blacklist,
                          delta, max_genome_size, engine="device-argmax",
                          mesh=None):
    return _search_batched(
        hps_list, dataset, split_name, rule_blacklist,
        grow=partial(_bound_grow, engine=engine, mesh=mesh),
        finish=lambda hps, grown, cache=None: _bound_finish(
            hps, grown[0], dataset, split_name, delta, max_genome_size,
            column_cache=cache, mesh=mesh,
        ),
    )


def train_tree(dataset, split_name, criterion, class_importance, max_depth,
               min_samples_split, rule_blacklist, progress_callback,
               hp_search_func, hp_search_type, batched_search_func=None):
    """HP grid search (experiment_cart.py:437-487).

    With ``batched_search_func`` (device engine), all combos' trees grow as
    one batched forest; selection and tie rules are unchanged."""
    n_hp = (
        len(criterion) * len(class_importance) * len(max_depth) * len(min_samples_split)
    )
    best_hps = None
    best_score = np.inf
    best_master_tree = None
    n_completed = 0.0
    progress_callback(hp_search_type.title(), 0.0)
    combos = [
        {
            "criterion": hps_tuple[0],
            "class_importance": hps_tuple[1],
            "max_depth": hps_tuple[2],
            "min_samples_split": hps_tuple[3],
        }
        for hps_tuple in product(
            criterion, class_importance, max_depth, min_samples_split
        )
    ]
    if batched_search_func is not None:
        results = batched_search_func(
            combos, dataset=dataset, split_name=split_name,
            rule_blacklist=rule_blacklist,
        )
    else:
        results = (
            hp_search_func(
                hps, dataset=dataset, split_name=split_name,
                rule_blacklist=rule_blacklist,
            )
            for hps in combos
        )
    for hps, score, master_tree in results:
        n_completed += 1
        progress_callback(hp_search_type.title(), n_completed / n_hp)
        if score < best_score:
            best_hps = hps
            best_score = score
            best_master_tree = master_tree
        elif np.isclose(score, best_score):
            master_tree_length = len(master_tree)
            best_master_tree_length = len(best_master_tree)
            # Tie rules: smaller tree, then lower class-importance variance.
            # NOTE (faithful quirk): like the reference
            # (experiment_cart.py:480-484), the winning *tree* is not actually
            # swapped in on tie — only the hps and score are updated.
            if (master_tree_length < best_master_tree_length) or (
                master_tree_length == best_master_tree_length
                and np.var(list(hps["class_importance"].values()))
                < np.var(list(best_hps["class_importance"].values()))
            ):
                best_hps = hps
                best_master_tree = best_master_tree
                best_score = score
    return best_score, best_hps, best_master_tree


def _resolve_deferred_equiv(dataset, split_name, tree, rule_blacklist,
                            mesh=None):
    """Replace DeferredEquiv specs on the chosen master's rules with the
    real equivalence column sets (one batched device pass)."""
    nodes = []
    stack = [tree]
    while stack:
        node = stack.pop()
        if node is None or node.rule is None:
            continue
        if isinstance(node.rule.equivalent_rules_idx, DeferredEquiv):
            nodes.append(node)
        stack.extend((node.right_child, node.left_child))
    if not nodes:
        return
    from ...parallel.cart_exact import resolve_equiv_specs

    excl, _ = device_excl_from_blacklist(rule_blacklist, dataset.kmer_count)
    train_idx = dataset.get_split(split_name).train_genome_idx
    specs = [(nd.rule.equivalent_rules_idx.keys,
              nd.rule.equivalent_rules_idx.occmax) for nd in nodes]
    sets = resolve_equiv_specs(
        dataset.bit_matrix(sharding=mesh_sharding(mesh)),
        [nd.class_examples_idx for nd in nodes],
        [train_idx] * len(nodes), specs, excl=excl, mesh=mesh)
    for nd, eq in zip(nodes, sets):
        nd.rule.equivalent_rules_idx = eq


def _find_rule_blacklist(dataset, kmer_blacklist_file, warning_callback):
    """(experiment_cart.py:490-518) — presence rules only."""
    rule_blacklist = []
    if kmer_blacklist_file is not None:
        kmers_to_blacklist = parse_kmer_blacklist(kmer_blacklist_file,
                                                  dataset.kmer_length)
        if kmers_to_blacklist:
            kmer_sequences = [
                s.decode() if isinstance(s, bytes) else str(s)
                for s in dataset.kmer_sequences
            ]
            kmer_by_matrix_column = dataset.kmer_by_matrix_column.tolist()
            kmers_not_found = []
            for k in kmers_to_blacklist:
                k = k.upper()
                try:
                    rule_blacklist.append(
                        kmer_by_matrix_column.index(kmer_sequences.index(k))
                    )
                except ValueError:
                    kmers_not_found.append(k)
            if kmers_not_found:
                warning_callback(
                    "The following kmers could not be found in the dataset: "
                    + ", ".join(kmers_not_found)
                )
    return rule_blacklist


def learn_CART(dataset_file, split_name, criterion, max_depth, min_samples_split,
               class_importance, bound_delta=None, bound_max_genome_size=None,
               kmer_blacklist_file=None, parameter_selection="cv", n_cpu=None,
               authorized_rules="", engine="host", mesh=None, progress_callback=None,
               warning_callback=None, error_callback=None, device=None):
    """Learn a CART model (reference entry point experiment_cart.py:521-646).

    ``dataset_file`` is an artifact path, an in-memory artifact
    (:func:`grm_tpu_torch.dataset.from_numpy_artifact`) or a
    :class:`~grm_tpu_torch.dataset.GrmDataset`, whose loaded matrix serves
    again. ``device``
    (default ``"cuda"``, which raises without CUDA; ``"cpu"`` runs the
    kernels' plain versions) holds the bit matrix and runs every sweep.
    ``n_cpu`` is accepted for API compatibility.

    ``engine``:

    - "host" — the reference's float64 impurity scan over class counts
      fetched from the device (one masked-popcount pass per node).
    - "device" — the exact device engine
      (:mod:`grm_tpu_torch.parallel.cart_exact`): float32 minima, tuple
      tables and candidate gathers on the device, the float64 selection and
      the tiebreak replayed on the host, every tree of the HP grid grown as
      one forest: the host engine's model, tie sets, CV score and pruning
      alpha bit for bit.
    - "device-argmax" — impurity and argmin on the device in float32
      (:mod:`grm_tpu_torch.ops.cart_sweep`), every tree of the HP grid
      grown as one forest; ties go to the lowest column and no tie sets
      are kept.
    """
    if engine not in ("host", "device", "device-argmax"):
        raise ValueError("unknown engine %r" % (engine,))
    if warning_callback is None:
        warning_callback = lambda w: logging.warning(w)
    if error_callback is None:

        def error_callback(exception):
            raise exception

    if progress_callback is None:
        progress_callback = lambda t, p: None

    dataset = as_dataset(dataset_file, device=device)
    if mesh is not None:
        check_mesh(mesh, dataset.device)
        if engine == "host":
            mesh = None  # the host engine does not shard
    rule_blacklist = _find_rule_blacklist(dataset, kmer_blacklist_file,
                                          warning_callback)

    if engine == "device-argmax" and mesh is None:
        # Matrices past the device memory budget come back as a
        # host-resident StreamingBitMatrix. The EXACT engine (engine
        # "device") streams column chunks through its sweeps; only the
        # argmax scorer needs a resident matrix.
        if not hasattr(dataset.bit_matrix(), "data"):
            warning_callback(
                "The k-mer matrix exceeds the device memory budget; "
                "falling back to --engine host (streaming sweeps). Use "
                "--engine device (streamed exact) or shard over a mesh."
            )
            engine = "host"

    criterion = list(np.unique(np.atleast_1d(criterion)))
    max_depth = list(np.unique(np.atleast_1d(max_depth)))
    min_samples_split = list(np.unique(np.atleast_1d(min_samples_split)))
    if isinstance(class_importance, dict):
        class_importance = [class_importance]
    # Deduplicate importance dicts while preserving order.
    seen = set()
    unique_ci = []
    for ci in class_importance:
        key = tuple(sorted(ci.items()))
        if key not in seen:
            seen.add(key)
            unique_ci.append(ci)
    class_importance = unique_ci

    if parameter_selection == "bound":
        if bound_delta is None or bound_max_genome_size is None:
            error_callback(
                Exception(
                    "Bound selection cannot be performed without delta and the "
                    "maximum genome length."
                )
            )
        func = partial(_learn_pruned_tree_bound, delta=bound_delta,
                       max_genome_size=bound_max_genome_size, engine=engine,
                       mesh=mesh)
        batched = (
            partial(_bound_search_batched, delta=bound_delta,
                    max_genome_size=bound_max_genome_size, engine=engine,
                    mesh=mesh)
            if engine in ("device", "device-argmax") else None
        )
        best_hp_score, best_hps, best_master_tree = train_tree(
            dataset, split_name, criterion, class_importance, max_depth,
            min_samples_split, rule_blacklist, progress_callback, func,
            "bound selection", batched_search_func=batched,
        )
    elif parameter_selection == "cv":
        n_folds = len(dataset.get_split(split_name).folds)
        if n_folds < 1:
            error_callback(
                Exception("Cross-validation cannot be performed on a split with no folds.")
            )
        best_hp_score, best_hps, best_master_tree = train_tree(
            dataset, split_name, criterion, class_importance, max_depth,
            min_samples_split, rule_blacklist, progress_callback,
            partial(_learn_pruned_tree_cv, engine=engine, mesh=mesh),
            "cross-validation",
            batched_search_func=(
                partial(_cv_search_batched, engine=engine, mesh=mesh)
                if engine in ("device", "device-argmax") else None
            ),
        )
    else:
        error_callback(ValueError("Unknown hyperparameter selection strategy specified."))

    split = dataset.get_split(split_name)
    train_idx = split.train_genome_idx
    test_idx = split.test_genome_idx
    example_labels = dataset.phenotype.metadata
    phenotype_tags = dataset.phenotype.tags

    train_predictions, test_predictions = _predictions(
        best_master_tree, dataset, train_idx, test_idx, progress_callback
    )
    train_answers = example_labels[train_idx]
    test_answers = example_labels[test_idx]

    if dataset.classification_type == "binary":
        train_metrics = get_binary_metrics(train_predictions, train_answers)
    else:
        train_metrics = get_multiclass_metrics(
            train_predictions, train_answers, len(phenotype_tags)
        )
    if len(test_idx) > 0:
        if dataset.classification_type == "binary":
            test_metrics = get_binary_metrics(test_predictions, test_answers)
        else:
            test_metrics = get_multiclass_metrics(
                test_predictions, test_answers, len(phenotype_tags)
            )
    else:
        test_metrics = None

    genome_ids = dataset.genome_identifiers
    classifications = defaultdict(list)
    classifications["train_correct"] = (
        genome_ids[train_idx[train_predictions == train_answers]].tolist()
        if train_metrics["risk"][0] < 1.0
        else []
    )
    classifications["train_errors"] = (
        genome_ids[train_idx[train_predictions != train_answers]].tolist()
        if train_metrics["risk"][0] > 0
        else []
    )
    if len(test_idx) > 0:
        classifications["test_correct"] = (
            genome_ids[test_idx[test_predictions == test_answers]].tolist()
            if test_metrics["risk"][0] < 1.0
            else []
        )
        classifications["test_errors"] = (
            genome_ids[test_idx[test_predictions != test_answers]].tolist()
            if test_metrics["risk"][0] > 0
            else []
        )

    best_model = CARTModel(class_tags=list(phenotype_tags))
    best_model.decision_tree = best_master_tree

    # Resolve the chosen master's DEFERRED equivalence sets in one batched
    # pass (the HP search skipped per-level compaction for every master;
    # only this tree's sets are consumed — experiment_cart.py:636-638).
    _resolve_deferred_equiv(dataset, split_name, best_master_tree,
                            rule_blacklist, mesh)

    model_rules = best_master_tree.rules
    model_equivalent_rules = {}
    rules = LazyKmerRuleList(dataset)
    for r in model_rules:
        if r.equivalent_rules_idx is not None:
            model_equivalent_rules[r] = [rules[int(i)] for i in r.equivalent_rules_idx]
        else:
            model_equivalent_rules[r] = [r]

    rule_importance_sum = float(sum(r.importance for r in model_rules)) if model_rules else 0.0
    if rule_importance_sum > 0:
        rule_importances = {r: r.importance / rule_importance_sum for r in model_rules}
    else:
        rule_importances = {r: 0.0 for r in model_rules}

    return (
        best_hps,
        best_hp_score,
        train_metrics,
        test_metrics,
        best_model,
        rule_importances,
        model_equivalent_rules,
        classifications,
    )
