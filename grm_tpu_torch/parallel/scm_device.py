"""The scan-over-fits SCM engine and packed example masks (the port of
``grm_tpu/parallel/scm_device.py``).

:func:`scm_cv_batch_device` fits every (model_type, p, fold) of a CV grid
one after the other, each a greedy loop of the argmax engine's iterations
(:func:`grm_tpu_torch.parallel.mesh._scm_iteration`), and scores each
model length on the fold's test examples from packed prediction masks (a
conjunction's predictions are an AND-chain of its rule columns). It is the
engine ``learn_SCM`` takes on a mesh whose word rows are sharded: the
iterations count through the sharded column sums
(:meth:`~grm_tpu_torch.parallel.mesh.ShardedMatrix.colsum`), one
``popcount_colsum`` launch a shard, summed over the row shards.

Ties resolve to the lowest rule index; utilities compare exactly in
float32; the risks are float32, as in ``grm_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.popcount import masks_to_tensor, popcount_rows
from ..utils import build_row_mask
from .mesh import _columns, _scm_iteration

__all__ = ["build_packed_mask", "scm_cv_batch_device"]


def build_packed_mask(rows, n_genomes, n_words):
    """uint32 MSB-first packed row mask padded to n_words."""
    out = np.zeros(n_words, np.uint32)
    m = build_row_mask(np.asarray(rows, dtype=np.int64), n_genomes, 32)
    out[: len(m)] = m
    return out


def _cv_batch(matrix, pos_masks, neg_masks, test_pos_masks, test_neg_masks,
              ps, is_disjunction, n_kmers, max_rules):
    """Per-fit greedy SCM + per-length test risks.

    All mask tensors: (F, W) int32 on the matrix's (first) device. In fit
    space, disjunction fits have train pos/neg pre-swapped; test masks are
    NOT swapped (they carry the true labels): the disjunction flag turns
    conjunction predictions in fit space back into label space. Returns
    numpy (rules (F, max_rules) int32 [-1 pad], n_rules (F,) int32, risks
    (F, max_rules+1) float32).
    """
    f = pos_masks.shape[0]
    rules = np.full((f, max_rules), -1, np.int32)
    n_rules = np.zeros(f, np.int32)
    risks = np.zeros((f, max_rules + 1), np.float32)
    for fi in range(f):
        pos, neg = pos_masks[fi], neg_masks[fi]
        tpos, tneg = test_pos_masks[fi], test_neg_masks[fi]
        p, is_disj = ps[fi], bool(is_disjunction[fi])
        n_tpos = popcount_rows(tpos).float()
        n_tneg = popcount_rows(tneg).float()
        n_test = torch.clamp(n_tpos + n_tneg, min=1.0)

        def risk_of(conj):
            # conjunction-in-fit-space predictions: 1 where conj's bit is set
            pos_pred1 = popcount_rows(tpos & conj).float()
            neg_pred1 = popcount_rows(tneg & conj).float()
            if is_disj:  # disjunction prediction = NOT conjunction
                errors = pos_pred1 + (n_tneg - neg_pred1)
            else:
                errors = (n_tpos - pos_pred1) + neg_pred1
            return float(errors / n_test)

        conj = torch.full_like(pos, -1)
        fit_risks = [risk_of(conj)]  # the empty model predicts all 1
        n_neg = int(popcount_rows(neg))
        i = 0
        while i < max_rules and n_neg > 0:
            best_rule, pos, neg, n_neg_t = _scm_iteration(
                matrix, pos, neg, p, n_kmers)
            # Track the conjunction prediction mask over ALL genomes.
            col = _columns(matrix, (best_rule % n_kmers).view(1),
                           conj.shape[-1])[0]
            conj = conj & torch.where(best_rule >= n_kmers, ~col, col)
            rules[fi, i] = int(best_rule)
            fit_risks.append(risk_of(conj))
            n_neg = int(n_neg_t)
            i += 1
        n_rules[fi] = i
        # Unreached lengths repeat the last risk (the reference duplicates
        # the last element, experiment_scm.py:180-181).
        risks[fi, :i + 1] = fit_risks
        risks[fi, i + 1:] = fit_risks[-1]
    return rules, n_rules, risks


def scm_cv_batch_device(matrix, fits, n_kmers, max_rules):
    """Run the batched CV fits.

    ``matrix``: a (W, K) int32 tensor or a
    :class:`~grm_tpu_torch.parallel.mesh.ShardedMatrix`. ``fits``: list of
    dicts with keys pos_mask, neg_mask, test_pos_mask, test_neg_mask (numpy
    uint32 (W,)), p (float), model_type (str). Returns (rules, n_rules,
    risk_by_length) as numpy arrays.
    """
    dev = matrix.device
    stack = lambda key: masks_to_tensor(np.stack([f[key] for f in fits]),
                                        dev)
    ps = torch.tensor([f["p"] for f in fits], dtype=torch.float32,
                      device=dev)
    is_disj = [f["model_type"] == "disjunction" for f in fits]
    return _cv_batch(matrix, stack("pos_mask"), stack("neg_mask"),
                     stack("test_pos_mask"), stack("test_neg_mask"), ps,
                     is_disj, n_kmers, max_rules)
