"""The argmax engine's full-train fit on one device (the port of
``_scm_iteration`` and ``scm_fit_batch_device`` from
``grm_tpu/parallel/mesh.py``; the mesh and sharding parts wait).

Each greedy iteration counts the remaining negatives and positives per
k-mer with one ``popcount_colsum`` launch over two masks, scores both rule
halves in float32 and takes the argmax: presence wins ties against absence,
the lowest column wins within a half, rules that cover nothing and err on
nothing are excluded.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.popcount import popcount_colsum, popcount_rows

__all__ = ["scm_fit_batch_device"]


def _scm_iteration(matrix, pos_mask, neg_mask, p, n_kmers):
    """One greedy step: (best_rule, new_pos, new_neg, n_neg_left), tensors."""
    counts = popcount_colsum(matrix, torch.stack([neg_mask, pos_mask]))
    cn, cp = counts[0], counts[1]
    n_neg = popcount_rows(neg_mask)
    n_pos = popcount_rows(pos_mask)

    col_is_pad = torch.arange(matrix.shape[1], device=matrix.device) >= n_kmers
    # presence half: cover = n_neg - cn, err = n_pos - cp
    u_pres = (n_neg - cn).float() - p * (n_pos - cp).float()
    u_pres = torch.where(col_is_pad | ((cn == n_neg) & (cp == n_pos)),
                         -torch.inf, u_pres)
    # absence half: cover = cn, err = cp
    u_abs = cn.float() - p * cp.float()
    u_abs = torch.where(col_is_pad | ((cn == 0) & (cp == 0)), -torch.inf,
                        u_abs)

    best_pres = u_pres.argmax()
    best_abs = u_abs.argmax()
    # argmax-over-concat semantics: presence wins ties.
    use_abs = u_abs[best_abs] > u_pres[best_pres]
    best_col = torch.where(use_abs, best_abs, best_pres)

    col = matrix[:, best_col]
    rule_bits = torch.where(use_abs, ~col, col)
    new_pos = pos_mask & rule_bits
    new_neg = neg_mask & rule_bits
    best_rule = torch.where(use_abs, best_col + n_kmers, best_col)
    return best_rule, new_pos, new_neg, popcount_rows(new_neg)


def scm_fit_batch_device(matrix, pos_masks, neg_masks, ps, n_kmers,
                         max_rules):
    """Fit a batch of SCMs greedily, one fit after another.

    matrix: (W, K) int32 packed presence; pos_masks/neg_masks: (F, W) int32
    per-fit example masks (disjunction fits pre-swapped); ps: (F,) float32.
    Returns numpy (rules (F, max_rules) int32 with -1 for unused slots,
    n_rules (F,) int32, n_neg_left (F,) int32).
    """
    f = pos_masks.shape[0]
    rules = np.full((f, max_rules), -1, np.int32)
    n_rules = np.zeros(f, np.int32)
    n_neg_left = np.zeros(f, np.int32)
    for i in range(f):
        pos, neg, p = pos_masks[i], neg_masks[i], ps[i]
        n_neg = int(popcount_rows(neg))
        step = 0
        while step < max_rules and n_neg > 0:
            best_rule, pos, neg, n_neg_t = _scm_iteration(
                matrix, pos, neg, p, n_kmers)
            rules[i, step] = int(best_rule)
            n_neg = int(n_neg_t)
            step += 1
        n_rules[i] = step
        n_neg_left[i] = n_neg
    return rules, n_rules, n_neg_left
