"""Binary and multiclass prediction metrics, vectorized over model lengths (the port's copy
of ``grm_tpu/learning/metrics.py``).

The experiment drivers score every model prefix length at once (one
prediction row per length), so the whole confusion table is computed in a
single broadcast pass over the (L, n) prediction matrix instead of a
Python loop per row.

The *value contract* matches the reference
(``learning/experiments/metrics.py:24-92``): each metric maps to a list
with one entry per prediction row, counts are ints, an empty denominator
yields ``-inf`` (including F1 when precision+recall is not positive), and
risk is the plain error fraction.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

__all__ = ["get_binary_metrics", "get_multiclass_metrics"]


def _as_rows(predictions):
    p = np.asarray(predictions)
    return p.reshape(1, -1) if p.ndim == 1 else p


def _ratio(num, den):
    """Elementwise num/den with the reference's empty-denominator -inf."""
    num = num.astype(np.float64)
    den = den.astype(np.float64)
    return np.where(den != 0, num / np.where(den != 0, den, 1.0), -np.inf)


def get_binary_metrics(predictions, answers):
    """Binary metrics dict of per-row lists (reference value conventions)."""
    p = _as_rows(predictions)
    y = np.asarray(answers)

    pos = y == 1
    neg = y == 0
    pred_pos = p == 1
    pred_neg = p == 0

    # The whole confusion table for every prediction row in one pass.
    tp = (pred_pos & pos).sum(axis=1)
    fp = (pred_pos & neg).sum(axis=1)
    tn = (pred_neg & neg).sum(axis=1)
    fn = (pred_neg & pos).sum(axis=1)
    risk = (p != y).sum(axis=1) / float(y.shape[0])

    precision = _ratio(tp, tp + fp)
    recall = _ratio(tp, tp + fn)  # == sensitivity
    specificity = _ratio(tn, fp + tn)
    with np.errstate(invalid="ignore"):
        pr = precision + recall
        f1 = np.where(pr > 0.0, 2.0 * precision * recall / np.where(pr > 0.0, pr, 1.0), -np.inf)

    metrics = defaultdict(list)
    metrics["risk"] = [float(v) for v in risk]
    metrics["tp"] = [int(v) for v in tp]
    metrics["fp"] = [int(v) for v in fp]
    metrics["tn"] = [int(v) for v in tn]
    metrics["fn"] = [int(v) for v in fn]
    metrics["precision"] = [float(v) for v in precision]
    metrics["sensitivity"] = [float(v) for v in recall]
    metrics["recall"] = [float(v) for v in recall]
    metrics["specificity"] = [float(v) for v in specificity]
    metrics["f1_score"] = [float(v) for v in f1]
    return metrics


def get_multiclass_metrics(predictions, answers, nb_class):
    """Multiclass risk + confusion matrices (rows = actual class, columns =
    predicted class; labels outside [0, nb_class) are never counted)."""
    p = _as_rows(predictions)
    y = np.asarray(answers)

    risk = (p != y).sum(axis=1) / float(y.shape[0])

    # One flattened bincount per row: cell (a, pr) <- a * nb_class + pr.
    # int64 up front: small label dtypes (uint8 answers) would overflow the
    # flattening product under NEP-50 dtype preservation.
    y = y.astype(np.int64)
    p = p.astype(np.int64)
    in_range = (
        (y >= 0) & (y < nb_class) & (p >= 0) & (p < nb_class)
    )
    flat = y[None, :] * nb_class + p
    confusions = [
        np.bincount(flat[i][in_range[i]], minlength=nb_class * nb_class)
        .reshape(nb_class, nb_class)
        for i in range(p.shape[0])
    ]

    metrics = defaultdict(list)
    metrics["risk"] = [float(v) for v in risk]
    metrics["confusion_matrix"] = [
        [[int(c) for c in row] for row in cm] for cm in confusions
    ]
    return metrics
