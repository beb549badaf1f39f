"""Device-resident CART split scoring (the port of
``grm_tpu/parallel/cart_device.py`` for one device).

Computes the class-weighted Gini / cross-entropy impurity for ALL candidate
k-mer rules of a whole BFS frontier and its argmin entirely on the device
(:mod:`grm_tpu_torch.ops.cart_sweep`), fetching only each node's winning
rule index and score.

Math mirrors ``learning/learners/cart.py:85-207`` (altered-prior Breiman
impurities, empty children forbidden) in float32; the host engine remains
the float64 exact-parity path. Where ``grm_tpu`` keeps a per-node XLA
scorer for blacklists and cuts the frontier into chunks of at most 256
nodes for the TPU's VMEM, the CUDA kernel takes the exclusion mask and a
frontier of any size, so there is one path. The column-sharded scorer
(``cart_frontier_splits_sharded``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cart_sweep import cart_frontier_scores
from ..ops.popcount import masks_to_tensor
from .scm_device import build_packed_mask

__all__ = ["cart_best_split_device", "cart_frontier_splits_device"]


def cart_best_split_device(bit_matrix, class_example_idx, altered_priors,
                           total_n_examples_by_class, criterion, excl=None):
    """Find the best presence-rule split for a node on device.

    Returns (kmer_idx, score) or (None, inf) when no valid split exists.
    """
    return cart_frontier_splits_device(
        bit_matrix, [class_example_idx], altered_priors,
        total_n_examples_by_class, criterion, excl=excl)[0]


def cart_frontier_splits_device(bit_matrix, node_example_sets, altered_priors,
                                total_n_examples_by_class, criterion,
                                block=None, excl=None):
    """Best presence-rule split for a whole BFS frontier in one matrix pass.

    ``node_example_sets`` is a list of per-node ``{class: example_idx}``
    dicts (all nodes share the class key set). ``altered_priors`` /
    ``total_n_examples_by_class`` are one dict shared by every node or a
    per-node list of dicts (forest batching across trees). Returns a list
    of (kmer_idx or None, score) pairs, one per node. ``excl`` (optional
    (K,) bool): excluded k-mer columns (blacklist). The matrix's device
    decides what runs: the CUDA kernel on the card, its plain PyTorch
    version on the CPU.
    """
    if not node_example_sets:
        return []
    masks, n_node, priors, totals = _frontier_masks(
        bit_matrix, node_example_sets, altered_priors,
        total_n_examples_by_class,
    )
    dev = bit_matrix.device
    crit = "gini" if criterion == "gini" else "cross-entropy"
    excl_t = None
    if excl is not None:
        excl_t = torch.from_numpy(
            np.ascontiguousarray(excl, dtype=bool).view(np.uint8)).to(dev)
    cols, scores = cart_frontier_scores(
        bit_matrix.data, masks_to_tensor(masks, dev),
        torch.from_numpy(n_node).to(dev), torch.from_numpy(priors).to(dev),
        torch.from_numpy(totals).to(dev), crit, bit_matrix.n_columns,
        block=block, excl=excl_t)
    cols = cols.cpu().numpy()
    scores = scores.cpu().numpy().astype(np.float64)
    return [
        (None, np.inf) if not np.isfinite(scores[i]) else
        (int(cols[i]), float(scores[i]))
        for i in range(len(node_example_sets))
    ]


def _per_node_dicts(value, n):
    """Normalize a shared dict or per-node list of dicts to a list of n."""
    if isinstance(value, dict):
        return [value] * n
    if len(value) != n:
        raise ValueError("per-node parameter list length mismatch")
    return list(value)


def _frontier_masks(bit_matrix, node_example_sets, altered_priors,
                    total_n_examples_by_class):
    """Shared mask/param assembly.

    ``altered_priors`` / ``total_n_examples_by_class`` are either one dict
    shared by every node or a per-node list of dicts (forest batching:
    nodes of different trees carry different priors).
    Returns (masks (N,C,W) uint32, n_node (N,C) int32, priors (N,C) f32,
    totals (N,C) f32) over the sorted class key set.
    """
    n = len(node_example_sets)
    priors_l = _per_node_dicts(altered_priors, n)
    totals_l = _per_node_dicts(total_n_examples_by_class, n)
    classes = sorted(totals_l[0]) if n else []
    c, w = len(classes), bit_matrix.n_words
    masks = np.zeros((n, c, w), np.uint32)
    n_node = np.zeros((n, c), np.int32)
    priors = np.zeros((n, c), np.float32)
    totals = np.ones((n, c), np.float32)
    for i, example_idx in enumerate(node_example_sets):
        for ci, cl in enumerate(classes):
            idx = example_idx.get(cl, ())
            if len(idx):
                masks[i, ci] = build_packed_mask(idx, bit_matrix.n_rows, w)
                n_node[i, ci] = len(idx)
            priors[i, ci] = priors_l[i][cl]
            totals[i, ci] = totals_l[i][cl]
    return masks, n_node, priors, totals
