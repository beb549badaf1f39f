"""Sample-compression generalization bounds for SCM and CART models (the
port's copy of ``grm_tpu/learning/bounds.py``).

Host-side exact math (Python big-int ``math.comb`` + float64), mirroring the
reference formulas *as implemented*, including a precedence quirk in the SCM
bound (see below). Compression sets are built with Chvátal's greedy
minimum-set-cover approximation over the model k-mers' presence in training
genomes (``experiment_scm.py:358-372``, ``experiment_cart.py:169-182``).
"""

from __future__ import annotations

import logging
from math import comb, exp, log as ln, pi

import numpy as np

__all__ = ["build_compression_set", "scm_bound", "cart_bound"]


def build_compression_set(presence_by_example):
    """Chvátal greedy min-set-cover over (n_train, n_model_rules) presence.

    Returns relative indices of the selected training examples. Mirrors the
    reference loops (experiment_scm.py:361-371) with one safety addition: if
    the remaining columns are covered by no example (all-zero), they cannot
    be covered and the loop stops (the reference would loop forever).
    """
    compression_set = []
    presence_by_example = np.asarray(presence_by_example)
    while presence_by_example.shape[1] != 0:
        score = presence_by_example.sum(axis=1)
        if score.max() == 0:
            logging.debug("Uncoverable rule columns remain; stopping set cover.")
            break
        best_example_relative_idx = int(np.argmax(score))
        compression_set.append(best_example_relative_idx)
        presence_by_example = presence_by_example[
            :, presence_by_example[best_example_relative_idx] == 0
        ]
    return compression_set


def scm_bound(train_predictions, train_answers, train_example_idx, model, delta,
              max_genome_size, rule_classifications):
    """SCM sample-compression bound (experiment_scm.py:349-398).

    NOTE (faithful quirk): the reference expression

        ``A + B + 0 if h == 0 else C + D``

    parses as ``(A + B + 0) if h == 0 else (C + D)`` — i.e. for non-empty
    models the ln-combinations terms are NOT included, only
    ``h*ln(2*Z_card) + ln(pi^6 (h+1)^2 (r+1)^2 (mz+1)^2 / (216 delta))``.
    We reproduce that behaviour exactly for model-selection parity.
    """
    compression_set = []
    if len(model) > 0:
        presence_by_example = rule_classifications.get_columns(
            [r.kmer_index for r in model]
        )[train_example_idx]
        compression_set = build_compression_set(presence_by_example)

    h_card = float(len(model))
    Z_card = float(len(compression_set) * max_genome_size)
    m = float(len(train_answers))
    mz = float(len(compression_set))
    train_predictions = np.asarray(train_predictions)
    train_answers = np.asarray(train_answers)
    r = float(
        (train_predictions != train_answers).sum()
        - (train_predictions[compression_set] != train_answers[compression_set]).sum()
    )
    if h_card == 0:
        inner = ln(comb(int(m), int(mz))) + ln(comb(int(m - mz), int(r))) + 0
    else:
        inner = (h_card * ln(2 * Z_card)) + ln(
            pi ** 6 * (h_card + 1) ** 2 * (r + 1) ** 2 * (mz + 1) ** 2 / (216 * delta)
        )
    return 1.0 - exp((-1.0 / (m - mz - r)) * inner)


def cart_bound(train_predictions, train_answers, train_example_idx, model, delta,
               max_genome_size, rule_classifications, n_classes):
    """Decision-tree sample-compression bound (experiment_cart.py:155-205).

    Drouin et al. (2017)-style bound with the tree-structure terms
    ``(n+1)·ln(n_classes) + ln C(2n+1, n)``.
    """
    compression_set = []
    if len(model.rules) > 0:
        presence_by_example = rule_classifications.get_columns(
            [r.kmer_index for r in model.rules]
        )[train_example_idx]
        compression_set = build_compression_set(presence_by_example)

    m = float(len(train_answers))
    Z_card = float(len(compression_set))
    N_Z = Z_card * max_genome_size
    train_predictions = np.asarray(train_predictions)
    train_answers = np.asarray(train_answers)
    r = float(
        (train_predictions != train_answers).sum()
        - (train_predictions[compression_set] != train_answers[compression_set]).sum()
    )
    n = float(len(model.rules))

    return 1.0 - exp(
        (-1.0 / (m - Z_card - r))
        * (
            ln(comb(int(m), int(Z_card)))
            + ln(comb(int(m - Z_card), int(r)))
            + (n * ln(N_Z) if n > 0 else 0.0)
            + (n + 1) * ln(n_classes)
            + ln(comb(int(2 * n + 1), int(n)))
            + ln(
                pi ** 6
                * (n + 1) ** 2
                * (r + 1) ** 2
                * (Z_card + 1) ** 2
                / (216 * delta)
            )
        )
    )
