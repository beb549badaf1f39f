"""SCM experiment driver: hyperparameter selection + final training + metrics.

The port of ``grm_tpu/learning/experiments/scm_experiment.py``. Mirrors the reference flow (``experiment_scm.py:674-889``) with
these differences:

- the multiprocessing HP-grid pool (``experiment_scm.py:196-248``) becomes a
  sequential loop over the grid: the bit matrix lives once in device memory
  and every fit reuses it. HP combinations are visited in deterministic
  ``product(model_types, p_values)`` order (the reference's
  ``imap_unordered`` completion order was nondeterministic).
- risk-table tiebreakers operate on the stored unique-risk *indices* exactly
  like the reference (indices into the sorted unique_risks array order the
  same as the risks themselves, experiment_scm.py:122-130).

With a ``mesh`` (:func:`grm_tpu_torch.parallel.mesh.make_mesh`) the matrix
is loaded sharded (:class:`~grm_tpu_torch.parallel.mesh.MeshSharding`) and
the device engines walk its shards, as ``grm_tpu``'s run SPMD: the exact
engine and the grid engine on a mesh of one row of devices, the scan
engine (pure argmax) where the word rows are sharded too.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from copy import deepcopy
from functools import partial
from itertools import product

import numpy as np
import torch

from ...dataset.artifact import as_dataset
from ...ops.popcount import masks_to_tensor
from ...parallel.mesh import check_mesh, mesh_sharding, scm_fit_batch_device
from ...parallel.scm_device import build_packed_mask, scm_cv_batch_device
from ...parallel.scm_exact import ExactScmEngine, _make_risk_lookup
from ...parallel.scm_grid import scm_cv_grid_device
from ...utils import parse_kmer_blacklist
from ..bounds import scm_bound
from ..metrics import get_binary_metrics
from ..models import ConjunctionModel, DisjunctionModel
from ..rules import KmerRuleClassifications, LazyKmerRuleList
from ..scm import SetCoveringMachine, rule_importances as _rule_importances

__all__ = ["learn_SCM"]


def _duplicate_last_element(l, length):
    l += [l[-1]] * (length - len(l))
    return l


def _predictions(model, dataset, train_example_idx, test_example_idx,
                 progress_callback=None):
    """Predict by loading only the model's k-mer columns (experiment_scm.py:43-99)."""
    if progress_callback is None:
        progress_callback = lambda t, p: None
    progress_callback("Testing", 0.0)

    if len(model) == 0:
        train_predictions = model.predict(np.zeros((len(train_example_idx), 1)))
        test_predictions = model.predict(np.zeros((len(test_example_idx), 1)))
    else:
        columns_to_load = []
        readdressed_model = deepcopy(model)
        for i, rule_idx in enumerate(np.argsort([r.kmer_index for r in model.rules])):
            rule = readdressed_model.rules[rule_idx]
            columns_to_load.append(rule.kmer_index)
            rule.kmer_index = i
        X = dataset.get_matrix_columns(np.array(columns_to_load))
        train_predictions = readdressed_model.predict(X[train_example_idx])
        progress_callback(
            "Testing",
            1.0 * len(train_example_idx)
            / max(len(train_example_idx) + len(test_example_idx), 1),
        )
        test_predictions = readdressed_model.predict(X[test_example_idx])
    progress_callback("Testing", 1.0)
    return train_predictions, test_predictions


def _tiebreaker(best_utility_idx, rule_risks, model_type):
    """Pick rules with the best precomputed risk (experiment_scm.py:122-130)."""
    tie_rule_risks = rule_risks[best_utility_idx]
    if model_type == "conjunction":
        return best_utility_idx[np.isclose(tie_rule_risks, tie_rule_risks.min())]
    # Disjunction trains on inverted labels: risks are 1 - conjunction risks.
    return best_utility_idx[np.isclose(tie_rule_risks, tie_rule_risks.max())]


def _cv_score_hp(hp_values, max_rules, dataset, split_name, rule_blacklist):
    """Cross-validation risk of one (model_type, p) combination
    (experiment_scm.py:102-193)."""
    model_type, p = hp_values
    split = dataset.get_split(split_name)
    folds = split.folds
    rules = LazyKmerRuleList(dataset)
    rule_classifications = KmerRuleClassifications(dataset)
    labels = dataset.phenotype.metadata

    fold_score_by_model_length = np.ones((len(folds), max_rules + 1)) * np.inf
    for i, fold in enumerate(folds):
        rule_risks = np.hstack(
            (fold.unique_risk_by_kmer, fold.unique_risk_by_anti_kmer)
        )
        train_example_idx = fold.train_genome_idx
        test_example_idx = fold.test_genome_idx
        positive_example_idx = train_example_idx[
            labels[train_example_idx] == 1
        ].reshape(-1)
        negative_example_idx = train_example_idx[
            labels[train_example_idx] == 0
        ].reshape(-1)

        test_predictions_by_model_length = []
        tmp_model = ConjunctionModel() if model_type == "conjunction" else DisjunctionModel()

        def _iteration_callback(iteration_infos):
            tmp_model.add(iteration_infos["selected_rule"])
            _, test_predictions = _predictions(tmp_model, dataset, [], test_example_idx)
            test_predictions_by_model_length.append(test_predictions)

        predictor = SetCoveringMachine(model_type=model_type, p=p, max_rules=max_rules)
        # Length-0 (empty model) predictions first (experiment_scm.py:161-165).
        test_predictions_by_model_length.append(
            _predictions(tmp_model, dataset, [], test_example_idx)[1]
        )
        predictor.fit(
            rules=rules,
            rule_classifications=rule_classifications,
            positive_example_idx=positive_example_idx,
            negative_example_idx=negative_example_idx,
            rule_blacklist=rule_blacklist,
            tiebreaker=partial(_tiebreaker, rule_risks=rule_risks, model_type=model_type),
            iteration_callback=_iteration_callback,
        )

        test_predictions_by_model_length = np.array(
            _duplicate_last_element(test_predictions_by_model_length, max_rules + 1)
        )
        fold_score_by_model_length[i] = get_binary_metrics(
            predictions=test_predictions_by_model_length,
            answers=labels[test_example_idx],
        )["risk"]

    score_by_model_length = np.mean(fold_score_by_model_length, axis=0)
    best_score_idx = int(np.argmin(score_by_model_length))
    return (model_type, p, best_score_idx), score_by_model_length[best_score_idx]


def _cross_validation(dataset, split_name, model_types, p_values, max_rules,
                      rule_blacklist, progress_callback):
    """Best (model_type, p, length) by CV (experiment_scm.py:196-248)."""
    n_hp = len(model_types) * len(p_values)
    n_completed = 0.0
    progress_callback("Cross-validation", 0.0)
    hp_list, scores_by_hp = [], []
    for hp_values in product(model_types, p_values):
        hp, score = _cv_score_hp(hp_values, max_rules, dataset, split_name,
                                 rule_blacklist)
        n_completed += 1
        progress_callback("Cross-validation", n_completed / n_hp)
        hp_list.append((hp[0], hp[1]))
        scores_by_hp.append((hp[2], score))
    # Reference tie rules (experiment_scm.py:233-246) live in ONE place:
    # _hp_selection_loop, shared by the host, exact-device, and argmax
    # CV drivers.
    return _hp_selection_loop(hp_list, scores_by_hp)


def _full_train(dataset, split_name, model_type, p, max_rules, max_equiv_rules,
                rule_blacklist, random_generator, progress_callback):
    """Final training on the full training set (experiment_scm.py:251-346)."""
    rules = LazyKmerRuleList(dataset)
    rule_classifications = KmerRuleClassifications(dataset)
    split = dataset.get_split(split_name)
    labels = dataset.phenotype.metadata

    train_example_idx = split.train_genome_idx
    positive_example_idx = train_example_idx[labels[train_example_idx] == 1].reshape(-1)
    negative_example_idx = train_example_idx[labels[train_example_idx] == 0].reshape(-1)

    model_equivalent_rules = []
    predictor = SetCoveringMachine(model_type=model_type, p=p, max_rules=max_rules)
    if max_rules == 0:
        return predictor.model, np.array([]), np.array([])

    progress = {"n_rules": 0.0}

    def _iteration_callback(iteration_infos):
        progress["n_rules"] += 1
        progress_callback("Training", progress["n_rules"] / max_rules)
        equiv = iteration_infos["equivalent_rules_idx"]
        if len(equiv) > max_equiv_rules:
            random_idx = random_generator.choice(len(equiv), max_equiv_rules,
                                                 replace=False)
            random_idx.sort()
            equiv = equiv[random_idx]
        if model_type == "disjunction":
            n_kmers = rule_classifications.shape[1] // 2
            equiv = (equiv + n_kmers) % (2 * n_kmers)
        model_equivalent_rules.append(equiv)

    progress_callback("Training", 0)
    predictor.fit(
        rules=rules,
        rule_classifications=rule_classifications,
        positive_example_idx=positive_example_idx,
        negative_example_idx=negative_example_idx,
        rule_blacklist=rule_blacklist,
        tiebreaker=partial(
            _tiebreaker,
            rule_risks=np.hstack(
                (split.unique_risk_by_kmer, split.unique_risk_by_anti_kmer)
            ),
            model_type=model_type,
        ),
        iteration_callback=_iteration_callback,
    )
    return predictor.model, predictor.rule_importances, model_equivalent_rules


def _bound_score_hp(hp_values, max_rules, dataset, split_name, max_equiv_rules,
                    rule_blacklist, bound_delta, bound_max_genome_size,
                    random_generator):
    """Train once, score every prefix length with the bound
    (experiment_scm.py:401-565)."""
    model_type, p = hp_values
    rules = LazyKmerRuleList(dataset)
    rule_classifications = KmerRuleClassifications(dataset)
    split = dataset.get_split(split_name)
    labels = dataset.phenotype.metadata
    rule_risks = np.hstack((split.unique_risk_by_kmer, split.unique_risk_by_anti_kmer))

    train_example_idx = split.train_genome_idx
    positive_example_idx = train_example_idx[labels[train_example_idx] == 1].reshape(-1)
    negative_example_idx = train_example_idx[labels[train_example_idx] == 0].reshape(-1)
    train_answers = labels[train_example_idx]

    tmp_model = ConjunctionModel() if model_type == "conjunction" else DisjunctionModel()
    score_by_length = np.ones(max_rules)
    model_by_length = []
    equivalent_rules = []
    rule_importances = []

    def _iteration_callback(iteration_infos):
        tmp_model.add(iteration_infos["selected_rule"])
        model_by_length.append(deepcopy(tmp_model))
        rule_importances.append(iteration_infos["rule_importances"])
        equiv = iteration_infos["equivalent_rules_idx"]
        if len(equiv) > max_equiv_rules:
            random_idx = random_generator.choice(len(equiv), max_equiv_rules,
                                                 replace=False)
            random_idx.sort()
            equiv = equiv[random_idx]
        if model_type == "disjunction":
            n_kmers = rule_classifications.shape[1] // 2
            equiv = (equiv + n_kmers) % (2 * n_kmers)
        equivalent_rules.append(equiv)

        _, train_predictions = _predictions(tmp_model, dataset, [], train_example_idx)
        score_by_length[iteration_infos["iteration_number"] - 1] = scm_bound(
            train_predictions=train_predictions,
            train_answers=train_answers,
            train_example_idx=train_example_idx,
            model=tmp_model,
            delta=bound_delta,
            max_genome_size=bound_max_genome_size,
            rule_classifications=rule_classifications,
        )

    predictor = SetCoveringMachine(model_type=model_type, p=p, max_rules=max_rules)
    predictor.fit(
        rules=rules,
        rule_classifications=rule_classifications,
        positive_example_idx=positive_example_idx,
        negative_example_idx=negative_example_idx,
        rule_blacklist=rule_blacklist,
        tiebreaker=partial(_tiebreaker, rule_risks=rule_risks, model_type=model_type),
        iteration_callback=_iteration_callback,
        iteration_rule_importances=True,
    )

    if len(tmp_model) == 0:
        _, train_predictions = _predictions(tmp_model, dataset, [], train_example_idx)
        bound_value = scm_bound(
            train_predictions=train_predictions,
            train_answers=train_answers,
            train_example_idx=train_example_idx,
            model=tmp_model,
            delta=bound_delta,
            max_genome_size=bound_max_genome_size,
            rule_classifications=rule_classifications,
        )
        return ((model_type, p, 0), bound_value, tmp_model, np.array([]), np.array([]))

    best_score_idx = int(np.argmin(score_by_length))
    return (
        (model_type, p, best_score_idx + 1),
        score_by_length[best_score_idx],
        model_by_length[best_score_idx],
        rule_importances[best_score_idx],
        equivalent_rules[: best_score_idx + 1],
    )


def _bound_selection(dataset, split_name, model_types, p_values, max_rules,
                     max_equiv_rules, rule_blacklist, bound_delta,
                     bound_max_genome_size, random_generator, progress_callback):
    """Best HP by bound value (experiment_scm.py:568-629)."""
    n_hp = len(model_types) * len(p_values)
    best_hp_score = 1.0
    best_hp = {"model_type": None, "p": None, "max_rules": None}
    best_model = best_equiv_rules = best_rule_importances = None
    n_completed = 0.0
    progress_callback("Bound selection", 0.0)
    for hp_values in product(model_types, p_values):
        hp, score, model, rule_importances, equiv_rules = _bound_score_hp(
            hp_values, max_rules, dataset, split_name, max_equiv_rules,
            rule_blacklist, bound_delta, bound_max_genome_size, random_generator
        )
        n_completed += 1
        progress_callback("Bound selection", n_completed / n_hp)
        if (
            (score < best_hp_score)
            or (
                score == best_hp_score
                and best_hp["max_rules"] is not None
                and hp[2] < best_hp["max_rules"]
            )
            or (
                score == best_hp_score
                and best_hp["max_rules"] is not None
                and hp[2] == best_hp["max_rules"]
                and abs(1.0 - hp[1]) < abs(1.0 - best_hp["p"])
            )
        ):
            best_hp["model_type"] = hp[0]
            best_hp["p"] = hp[1]
            best_hp["max_rules"] = hp[2]
            best_hp_score = score
            best_model = model
            best_equiv_rules = equiv_rules
            best_rule_importances = rule_importances
    return best_hp_score, best_hp, best_model, best_rule_importances, best_equiv_rules


def _hp_selection_loop(hp_list, scores_by_hp):
    """Reference HP tie rules over precomputed (hp, best_len, score) rows
    (experiment_scm.py:233-246): better score; equal (allclose) score ->
    shorter model; equal length -> p closest to 1.0. The None initial
    state never wins ties, like Py2's int<None == False."""
    best_hp_score = 1.0
    best_hp = {"model_type": None, "p": None, "max_rules": None}
    for (model_type, p), (best_len, score) in zip(hp_list, scores_by_hp):
        hp = (model_type, p, best_len)
        if (
            (not np.allclose(score, best_hp_score) and score < best_hp_score)
            or (
                np.allclose(score, best_hp_score)
                and best_hp["max_rules"] is not None
                and hp[2] < best_hp["max_rules"]
            )
            or (
                np.allclose(score, best_hp_score)
                and best_hp["max_rules"] is not None
                and hp[2] == best_hp["max_rules"]
                and not np.allclose(hp[1], best_hp["p"])
                and abs(1.0 - hp[1]) < abs(1.0 - best_hp["p"])
            )
        ):
            best_hp = {"model_type": hp[0], "p": hp[1], "max_rules": hp[2]}
            best_hp_score = score
    return best_hp_score, best_hp


def _rows_sharded(mesh):
    return mesh is not None and mesh.shape.get("rows", 1) != 1


_ROW_BLACKLIST = ("k-mer blacklists are not supported by the row-sharded "
                  "scan engine; use a columns-only mesh, the unsharded "
                  "device engine, or the host engine")


def _make_exact_engine(bm, n_kmers, rule_blacklist):
    """Resident exact engine, or the streamed (out-of-core) variant when
    the matrix exceeded the device memory budget and came back
    host-resident (StreamingBitMatrix) — either way, selection is
    bit-identical."""
    return ExactScmEngine(getattr(bm, "data", bm), n_kmers,
                          excl_rules=rule_blacklist)


def _cross_validation_device_exact(dataset, split_name, model_types, p_values,
                                   max_rules, progress_callback,
                                   rule_blacklist=(), mesh=None,
                                   collect_full_train=False):
    """Device-engine CV with EXACT reference selection semantics.

    The :class:`~grm_tpu_torch.parallel.scm_exact.ExactScmEngine` keeps
    every count sweep on the device but replays the reference's float64
    blockwise isclose tie accumulation, zero-coverage filter, and
    fold-risk-table tiebreaker on the host over a tiny candidate set — so
    the selected rules, fold risks (exact integer error counts divided in
    float64), and therefore the chosen hyperparameters are bit-identical to
    :func:`_cross_validation` (reference experiment_scm.py:100-248).

    With a columns-only ``mesh`` the matrix is placed column-sharded and the
    engine walks the shards; selection stays exact because every decision
    is made on the host from exact integer candidate counts.
    """
    split = dataset.get_split(split_name)
    folds = split.folds
    labels = dataset.phenotype.metadata
    bm = dataset.bit_matrix(sharding=mesh_sharding(mesh))
    n_words = bm.n_words
    n_genomes = dataset.genome_count
    n_kmers = bm.n_columns

    fold_lookups = [
        _make_risk_lookup(f.unique_risk_by_kmer, f.unique_risk_by_anti_kmer,
                          n_kmers)
        for f in folds
    ]

    hp_list = list(product(model_types, p_values))
    fits = []
    for model_type, p in hp_list:
        for fold, lookup in zip(folds, fold_lookups):
            tr = fold.train_genome_idx
            te = fold.test_genome_idx
            pos = tr[labels[tr] == 1]
            neg = tr[labels[tr] == 0]
            if model_type == "disjunction":
                pos, neg = neg, pos
            fits.append({
                "pos_mask": build_packed_mask(pos, n_genomes, n_words),
                "neg_mask": build_packed_mask(neg, n_genomes, n_words),
                "test_pos_mask": build_packed_mask(
                    te[labels[te] == 1], n_genomes, n_words),
                "test_neg_mask": build_packed_mask(
                    te[labels[te] == 0], n_genomes, n_words),
                "p": p,
                "model_type": model_type,
                "risk_lookup": lookup,
            })

    # The full-train fits, one per HP, ride the same batch: every greedy
    # iteration then scores them in the same matrix pass, instead of a
    # second run_fits for the chosen HP afterwards. A greedy run to length
    # L is a prefix of the run to max_rules, so the winner's full-train
    # model is the first best_hp["max_rules"] rules of its fit.
    n_cv = len(fits)
    if collect_full_train:
        tr = split.train_genome_idx
        full_lookup = _make_risk_lookup(
            split.unique_risk_by_kmer, split.unique_risk_by_anti_kmer,
            n_kmers)
        zero = np.zeros(n_words, np.uint32)
        for model_type, p in hp_list:
            pos = tr[labels[tr] == 1]
            neg = tr[labels[tr] == 0]
            if model_type == "disjunction":
                pos, neg = neg, pos
            fits.append({
                "pos_mask": build_packed_mask(pos, n_genomes, n_words),
                "neg_mask": build_packed_mask(neg, n_genomes, n_words),
                "test_pos_mask": zero, "test_neg_mask": zero,
                "p": p, "model_type": model_type,
                "risk_lookup": full_lookup,
            })

    progress_callback("Cross-validation", 0.0)
    engine = _make_exact_engine(bm, n_kmers, rule_blacklist)
    if collect_full_train:
        rules_arr, _, errors, n_test, ties = engine.run_fits(
            fits, max_rules, collect_ties=True)
    else:
        _, _, errors, n_test = engine.run_fits(fits, max_rules)
    progress_callback("Cross-validation", 1.0)

    n_folds = len(folds)
    scores_by_hp = []
    for i in range(len(hp_list)):
        sl = slice(i * n_folds, (i + 1) * n_folds)
        fold_risks = errors[sl].astype(np.float64) / np.maximum(
            n_test[sl, None], 1).astype(np.float64)
        score_by_len = np.mean(fold_risks, axis=0)
        best_len = int(np.argmin(score_by_len))
        scores_by_hp.append((best_len, score_by_len[best_len]))
    best_hp_score, best_hp = _hp_selection_loop(hp_list, scores_by_hp)
    if not collect_full_train:
        return best_hp_score, best_hp
    full_train = {}
    for i, (model_type, p) in enumerate(hp_list):
        fi = n_cv + i
        full_train[(model_type, float(p))] = (
            [int(r) for r in rules_arr[fi] if r >= 0], ties[fi])
    return best_hp_score, best_hp, full_train


def _full_train_device_exact(dataset, split_name, model_type, p, max_rules,
                             max_equiv_rules, rule_blacklist,
                             random_generator, progress_callback, mesh=None,
                             precomputed=None):
    """Final training on device with exact tie sets — bit-identical to
    :func:`_full_train` (reference experiment_scm.py:251-346) including the
    equivalent-rule subsampling RNG contract.

    ``precomputed``: optional (rule_idx, ties) from the CV batch's
    full-train fit for this HP — a greedy run to max_rules whose first
    ``max_rules`` selections equal this call's (greedy prefixes are
    stable), so the device pass is skipped entirely."""
    split = dataset.get_split(split_name)
    labels = dataset.phenotype.metadata
    bm = dataset.bit_matrix(sharding=mesh_sharding(mesh))
    n_genomes = dataset.genome_count
    n_kmers = bm.n_columns

    model = ConjunctionModel() if model_type == "conjunction" else DisjunctionModel()
    if max_rules == 0:
        return model, np.array([]), np.array([])

    tr = split.train_genome_idx
    pos = tr[labels[tr] == 1]
    neg = tr[labels[tr] == 0]
    if model_type == "disjunction":
        pos, neg = neg, pos
    training_example_idx = np.hstack((pos, neg))

    progress_callback("Training", 0)
    if precomputed is not None:
        full_rules, full_ties = precomputed
        rule_idx = full_rules[:max_rules]
        ties_list = full_ties[:max_rules]
    else:
        n_words = bm.n_words
        zero = np.zeros(n_words, np.uint32)
        fit = {
            "pos_mask": build_packed_mask(pos, n_genomes, n_words),
            "neg_mask": build_packed_mask(neg, n_genomes, n_words),
            "test_pos_mask": zero, "test_neg_mask": zero,
            "p": p, "model_type": model_type,
            "risk_lookup": _make_risk_lookup(
                split.unique_risk_by_kmer, split.unique_risk_by_anti_kmer,
                n_kmers),
        }
        engine = _make_exact_engine(bm, n_kmers, rule_blacklist)
        rules_arr, _, _, _, ties = engine.run_fits([fit], max_rules,
                                                   collect_ties=True)
        rule_idx = [int(r) for r in rules_arr[0] if r >= 0]
        ties_list = ties[0]
    progress_callback("Training", 1.0)

    # Equivalent-rule capture with the reference RNG contract
    # (experiment_scm.py:269-282 via the _full_train iteration callback).
    model_equivalent_rules = []
    for equiv in ties_list:
        equiv = np.asarray(equiv)
        if len(equiv) > max_equiv_rules:
            random_idx = random_generator.choice(len(equiv), max_equiv_rules,
                                                 replace=False)
            random_idx.sort()
            equiv = equiv[random_idx]
        if model_type == "disjunction":
            equiv = (equiv + n_kmers) % (2 * n_kmers)
        model_equivalent_rules.append(equiv)

    rules = LazyKmerRuleList(dataset)
    for idx in rule_idx:
        rule = rules[idx]
        if model_type == "disjunction":
            rule = rule.inverse()
        model.add(rule)

    rc = KmerRuleClassifications(dataset, sharding=mesh_sharding(mesh))
    if rule_idx:
        importances = _rule_importances(rc, rule_idx, training_example_idx)
    else:
        importances = np.array([])
    return model, importances, model_equivalent_rules


def _cross_validation_device(dataset, split_name, model_types, p_values,
                             max_rules, progress_callback, mesh=None,
                             rule_blacklist=()):
    """Device-engine CV with pure-argmax selection (the "device-argmax"
    engine, and the row-sharded path of "device").

    Same HP selection rules as :func:`_cross_validation`, but fold scores
    come from the iteration-major grid engine
    (:func:`grm_tpu_torch.parallel.scm_grid.scm_cv_grid_device`, over the
    column shards on a mesh of one row): pure-argmax rule selection (no exact-tie tiebreaker),
    blacklisted rules excluded by the sweep kernel, one matrix pass per
    greedy iteration scoring every fit at once; or, where the word rows are
    sharded, from the scan-over-fits engine
    (:func:`grm_tpu_torch.parallel.scm_device.scm_cv_batch_device`).
    """
    split = dataset.get_split(split_name)
    folds = split.folds
    labels = dataset.phenotype.metadata
    bm = dataset.bit_matrix(sharding=mesh_sharding(mesh))
    n_words = bm.n_words
    n_genomes = dataset.genome_count

    hp_list = list(product(model_types, p_values))
    fits = []
    for model_type, p in hp_list:
        for fold in folds:
            tr = fold.train_genome_idx
            te = fold.test_genome_idx
            pos = tr[labels[tr] == 1]
            neg = tr[labels[tr] == 0]
            if model_type == "disjunction":
                pos, neg = neg, pos
            fits.append({
                "pos_mask": build_packed_mask(pos, n_genomes, n_words),
                "neg_mask": build_packed_mask(neg, n_genomes, n_words),
                "test_pos_mask": build_packed_mask(
                    te[labels[te] == 1], n_genomes, n_words),
                "test_neg_mask": build_packed_mask(
                    te[labels[te] == 0], n_genomes, n_words),
                "p": p,
                "model_type": model_type,
            })

    if len(rule_blacklist) and _rows_sharded(mesh):
        raise ValueError(_ROW_BLACKLIST)
    progress_callback("Cross-validation", 0.0)
    if _rows_sharded(mesh):
        _, _, risks = scm_cv_batch_device(bm.data, fits, bm.n_columns,
                                          max_rules)
    else:
        _, _, risks = scm_cv_grid_device(bm.data, fits, bm.n_columns,
                                         max_rules,
                                         excl_rules=rule_blacklist)
    progress_callback("Cross-validation", 1.0)

    n_folds = len(folds)
    scores_by_hp = []
    for i in range(len(hp_list)):
        fold_risks = risks[i * n_folds : (i + 1) * n_folds]  # (folds, L+1)
        score_by_len = fold_risks.mean(axis=0).astype(np.float64)
        best_len = int(np.argmin(score_by_len))
        scores_by_hp.append((best_len, score_by_len[best_len]))
    return _hp_selection_loop(hp_list, scores_by_hp)


def _full_train_device(dataset, split_name, model_type, p, max_rules,
                       progress_callback, mesh=None, rule_blacklist=()):
    """Device-engine final training: one fit, model rebuilt on host."""
    split = dataset.get_split(split_name)
    labels = dataset.phenotype.metadata
    bm = dataset.bit_matrix(sharding=mesh_sharding(mesh))

    model = ConjunctionModel() if model_type == "conjunction" else DisjunctionModel()
    if max_rules == 0:
        return model, np.array([]), []

    tr = split.train_genome_idx
    pos = tr[labels[tr] == 1]
    neg = tr[labels[tr] == 0]
    if model_type == "disjunction":
        pos, neg = neg, pos
    pos_mask = build_packed_mask(pos, dataset.genome_count, bm.n_words)
    neg_mask = build_packed_mask(neg, dataset.genome_count, bm.n_words)

    progress_callback("Training", 0)
    if len(rule_blacklist):
        if _rows_sharded(mesh):
            raise ValueError(_ROW_BLACKLIST)
        # The grid engine's sweep excludes blacklisted rules: run the final
        # fit as a one-fit grid (test masks unused -> zeros).
        zero = np.zeros(bm.n_words, np.uint32)
        fit = {"pos_mask": pos_mask, "neg_mask": neg_mask,
               "test_pos_mask": zero, "test_neg_mask": zero,
               "p": p, "model_type": model_type}
        rules_arr, _, _ = scm_cv_grid_device(
            bm.data, [fit], bm.n_columns, max_rules,
            excl_rules=rule_blacklist)
    else:
        rules_arr, _, _ = scm_fit_batch_device(
            bm.data, masks_to_tensor(pos_mask[None], bm.device),
            masks_to_tensor(neg_mask[None], bm.device),
            torch.tensor([p], dtype=torch.float32, device=bm.device),
            bm.n_columns, max_rules)
    rule_idx = [int(r) for r in rules_arr[0] if r >= 0]
    progress_callback("Training", 1.0)

    rules = LazyKmerRuleList(dataset)
    for idx in rule_idx:
        rule = rules[idx]
        if model_type == "disjunction":
            rule = rule.inverse()
        model.add(rule)

    rc = KmerRuleClassifications(dataset, sharding=mesh_sharding(mesh))
    if rule_idx:
        importances = _rule_importances(rc, rule_idx, tr)
    else:
        importances = np.array([])
    # The argmax engine does not track exact-tie sets; report the chosen
    # rule only.
    equiv_idx = rule_idx
    if model_type == "disjunction":
        n_kmers = rc.shape[1] // 2
        equiv_idx = [(i + n_kmers) % (2 * n_kmers) for i in rule_idx]
    equivalent_rules = [np.array([i]) for i in equiv_idx]
    return model, importances, equivalent_rules


def _find_rule_blacklist(dataset, kmer_blacklist_file, warning_callback):
    """Rule indices to blacklist from a k-mer blacklist file
    (experiment_scm.py:632-671)."""
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
            n_kmers = len(kmer_sequences)
            kmers_not_found = []
            for k in kmers_to_blacklist:
                k = k.upper()
                try:
                    presence_rule_idx = kmer_by_matrix_column.index(
                        kmer_sequences.index(k)
                    )
                    rule_blacklist += [presence_rule_idx, presence_rule_idx + n_kmers]
                except ValueError:
                    kmers_not_found.append(k)
            if kmers_not_found:
                warning_callback(
                    "The following kmers could not be found in the dataset: "
                    + ", ".join(kmers_not_found)
                )
    return rule_blacklist


def learn_SCM(dataset_file, split_name, model_type, p, kmer_blacklist_file=None,
              max_rules=10, max_equiv_rules=10000, parameter_selection="cv",
              n_cpu=None, random_seed=None, authorized_rules="",
              bound_delta=None, bound_max_genome_size=None, engine="host",
              mesh=None, progress_callback=None, warning_callback=None,
              error_callback=None, device=None):
    """Learn an SCM model (reference entry point experiment_scm.py:674-889).

    ``dataset_file`` is an artifact path, an in-memory artifact
    (:func:`grm_tpu_torch.dataset.from_numpy_artifact`) or a
    :class:`~grm_tpu_torch.dataset.GrmDataset`, whose loaded matrix serves
    again. ``device``
    (default ``"cuda"``, which raises without CUDA; ``"cpu"`` runs the
    kernels' plain versions) holds the bit matrix and runs every sweep.
    ``n_cpu`` is accepted for API compatibility; the HP grid runs
    sequentially against the device-resident bit matrix.

    ``engine``:

    - "host" — the reference's selection semantics computed on the host
      (np.isclose ties + risk-table tiebreakers over full count vectors).
    - "device" — the exact device engine
      (:class:`~grm_tpu_torch.parallel.scm_exact.ExactScmEngine`): all
      count sweeps stay on the device, selection is bit-identical to
      "host" (same rules, tie sets, fold risks, hyperparameters).
      Blacklists supported. Columns-only meshes run the same exact engine
      over the column shards; row-sharded meshes take the pure-argmax scan
      engine (documented divergence: exact-tied rules resolve to the
      lowest index).
    - "device-argmax" — the pure-argmax grid engine (one matrix pass per
      greedy iteration for the whole CV); selected rules may differ from
      the reference among exactly tied candidates.

    ``mesh``: a :class:`~grm_tpu_torch.parallel.mesh.Mesh` over which the
    device engines shard the matrix; its devices must be of ``device``'s
    type.
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

    random_generator = np.random.RandomState(random_seed)
    model_type = np.unique(np.atleast_1d(model_type))
    p = np.unique(np.atleast_1d(p))

    dataset = as_dataset(dataset_file, device=device)
    if mesh is not None:
        check_mesh(mesh, dataset.device)
        if engine == "host":
            mesh = None  # the host engine does not shard
    if (engine in ("device", "device-argmax") and _rows_sharded(mesh)
            and kmer_blacklist_file is not None):
        error_callback(
            Exception("The row-sharded scan engine does not support k-mer "
                      "blacklists; use a columns-only mesh, --engine host, "
                      "or run unsharded.")
        )
    rule_blacklist = _find_rule_blacklist(dataset, kmer_blacklist_file,
                                          warning_callback)

    if engine == "device-argmax" and mesh is None:
        # Matrices beyond the device memory budget come back as a
        # StreamingBitMatrix (host-resident); the argmax grid engine needs
        # a resident matrix. The EXACT engine (engine "device") streams
        # column chunks through the device instead.
        if not hasattr(dataset.bit_matrix(), "data"):
            warning_callback(
                "The k-mer matrix exceeds the device memory budget; "
                "falling back to --engine host (streaming sweeps). Use "
                "--engine device (streamed exact) or shard over a mesh."
            )
            engine = "host"

    if parameter_selection == "bound":
        if bound_delta is None or bound_max_genome_size is None:
            error_callback(
                Exception(
                    "Bound selection cannot be performed without delta and the "
                    "maximum genome length."
                )
            )
        (best_hp_score, best_hp, best_model, best_rule_importances,
         best_predictor_equiv_rules) = _bound_selection(
            dataset, split_name, model_type, p, max_rules, max_equiv_rules,
            rule_blacklist, bound_delta, bound_max_genome_size,
            random_generator, progress_callback,
        )
    elif parameter_selection == "cv":
        n_folds = len(dataset.get_split(split_name).folds)
        if n_folds < 1:
            error_callback(
                Exception("Cross-validation cannot be performed on a split with no folds.")
            )
        if engine == "device" and not _rows_sharded(mesh):
            best_hp_score, best_hp, full_train_by_hp = (
                _cross_validation_device_exact(
                    dataset, split_name, model_type, p, max_rules,
                    progress_callback, rule_blacklist=rule_blacklist,
                    mesh=mesh, collect_full_train=True,
                ))
        elif engine in ("device", "device-argmax"):
            best_hp_score, best_hp = _cross_validation_device(
                dataset, split_name, model_type, p, max_rules, progress_callback,
                mesh=mesh, rule_blacklist=rule_blacklist,
            )
        else:
            best_hp_score, best_hp = _cross_validation(
                dataset, split_name, model_type, p, max_rules, rule_blacklist,
                progress_callback,
            )
        if best_hp["model_type"] is None:
            error_callback(
                Exception(
                    "Cross-validation could not select hyperparameters (all "
                    "scores were 1.0)."
                )
            )
    else:
        best_hp = {"model_type": model_type[0], "p": p[0], "max_rules": max_rules}
        best_hp_score = None

    if parameter_selection == "bound":
        model = best_model
        equivalent_rules = best_predictor_equiv_rules
        rule_importances = best_rule_importances
    elif engine == "device" and not _rows_sharded(mesh):
        precomputed = None
        if parameter_selection == "cv":
            precomputed = full_train_by_hp.get(
                (best_hp["model_type"], float(best_hp["p"])))
        model, rule_importances, equivalent_rules = _full_train_device_exact(
            dataset, split_name, best_hp["model_type"], best_hp["p"],
            best_hp["max_rules"], max_equiv_rules, rule_blacklist,
            random_generator, progress_callback, mesh=mesh,
            precomputed=precomputed,
        )
    elif engine in ("device", "device-argmax"):
        model, rule_importances, equivalent_rules = _full_train_device(
            dataset, split_name, best_hp["model_type"], best_hp["p"],
            best_hp["max_rules"], progress_callback, mesh=mesh,
            rule_blacklist=rule_blacklist,
        )
    else:
        model, rule_importances, equivalent_rules = _full_train(
            dataset, split_name, best_hp["model_type"], best_hp["p"],
            best_hp["max_rules"], max_equiv_rules, rule_blacklist,
            random_generator, progress_callback,
        )

    split = dataset.get_split(split_name)
    train_example_idx = split.train_genome_idx
    test_example_idx = split.test_genome_idx
    labels = dataset.phenotype.metadata

    train_predictions, test_predictions = _predictions(
        model, dataset, train_example_idx, test_example_idx, progress_callback
    )

    train_answers = labels[train_example_idx]
    train_metrics = get_binary_metrics(train_predictions, train_answers)

    if parameter_selection == "bound":
        train_metrics["bound"] = best_hp_score
    elif bound_delta is not None and bound_max_genome_size is not None:
        train_metrics["bound"] = scm_bound(
            train_predictions=train_predictions,
            train_answers=train_answers,
            train_example_idx=train_example_idx,
            model=model,
            delta=bound_delta,
            max_genome_size=bound_max_genome_size,
            rule_classifications=KmerRuleClassifications(
                dataset, sharding=mesh_sharding(mesh)),
        )

    if len(test_example_idx) > 0:
        test_answers = labels[test_example_idx]
        test_metrics = get_binary_metrics(test_predictions, test_answers)
    else:
        test_metrics = None

    genome_ids = dataset.genome_identifiers
    classifications = defaultdict(list)
    classifications["train_correct"] = (
        genome_ids[train_example_idx[train_predictions == train_answers]].tolist()
        if train_metrics["risk"][0] < 1.0
        else []
    )
    classifications["train_errors"] = (
        genome_ids[train_example_idx[train_predictions != train_answers]].tolist()
        if train_metrics["risk"][0] > 0
        else []
    )
    if len(test_example_idx) > 0:
        classifications["test_correct"] = (
            genome_ids[test_example_idx[test_predictions == test_answers]].tolist()
            if test_metrics["risk"][0] < 1.0
            else []
        )
        classifications["test_errors"] = (
            genome_ids[test_example_idx[test_predictions != test_answers]].tolist()
            if test_metrics["risk"][0] > 0
            else []
        )

    rules = LazyKmerRuleList(dataset)
    model_equivalent_rules = [
        [rules[int(i)] for i in equiv_idx] for equiv_idx in equivalent_rules
    ]

    return (
        best_hp,
        best_hp_score,
        train_metrics,
        test_metrics,
        model,
        np.asarray(rule_importances),
        model_equivalent_rules,
        classifications,
    )
