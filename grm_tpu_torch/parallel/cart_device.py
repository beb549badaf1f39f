"""Device-resident CART split scoring (the port of
``grm_tpu/parallel/cart_device.py``).

Computes the class-weighted Gini / cross-entropy impurity for ALL candidate
k-mer rules of a whole BFS frontier and its argmin entirely on the device
(:mod:`grm_tpu_torch.ops.cart_sweep`), fetching only each node's winning
rule index and score.

Math mirrors ``learning/learners/cart.py:85-207`` (altered-prior Breiman
impurities, empty children forbidden) in float32; the host engine remains
the float64 exact-parity path. Where ``grm_tpu`` keeps a per-node XLA
scorer for blacklists and cuts the frontier into chunks of at most 256
nodes for the TPU's VMEM, the CUDA kernel takes the exclusion mask and a
frontier of any size, so there is one path.

A matrix whose columns are sharded over a mesh takes the same path: each
column shard runs ``cart_sweep`` on its own device, a resident matrix being
one shard, and the per-shard winners come to the first device, where per
node the first shard at the minimum wins
(:func:`cart_frontier_splits_sharded` is ``grm_tpu``'s name for it). On a
mesh that spans processes each process sweeps its own shards and one
gather a call folds every process's winners by the same rule.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cart_sweep import cart_frontier_scores
from ..ops.popcount import masks_to_tensor
from .distributed import check_agreement
from .mesh import (MeshSharding, ShardedMatrix, column_shards,
                   combine_winners, shard_limit, spans_processes)
from .scm_device import build_packed_mask

__all__ = ["cart_best_split_device", "cart_frontier_splits_device",
           "cart_frontier_splits_sharded", "sharded_data"]


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
                                block=None, excl=None, mesh=None):
    """Best presence-rule split for a whole BFS frontier in one matrix pass.

    ``node_example_sets`` is a list of per-node ``{class: example_idx}``
    dicts (all nodes share the class key set). ``altered_priors`` /
    ``total_n_examples_by_class`` are one dict shared by every node or a
    per-node list of dicts (forest batching across trees). Returns a list
    of (kmer_idx or None, score) pairs, one per node. ``excl`` (optional
    (K,) bool): excluded k-mer columns (blacklist). The matrix's device
    decides what runs: the CUDA kernel on the card, its plain PyTorch
    version on the CPU.

    The kernel runs once per column shard (:func:`~grm_tpu_torch.parallel.
    mesh.column_shards`: a resident matrix is one), on the shard's device
    with its count of real columns as the limit; ``mesh`` places the matrix
    on that mesh first (:func:`sharded_data`). Per node the first shard at
    the minimum wins, so the lowest global column wins ties. A later shard
    of padding only is skipped: an all-zero column leaves the left child
    empty and scores +inf anyway.
    """
    if not node_example_sets:
        return []
    if mesh is not None and mesh.shape.get("rows", 1) != 1:
        raise ValueError("cart_frontier_splits_sharded shards columns only")
    data = bit_matrix.data if mesh is None else sharded_data(bit_matrix, mesh)
    args = _frontier_tensors(bit_matrix, node_example_sets, altered_priors,
                             total_n_examples_by_class)
    crit = "gini" if criterion == "gini" else "cross-entropy"
    excl_np = None
    if excl is not None:
        excl_np = np.zeros(data.shape[1], np.uint8)
        excl_np[:len(excl)] = np.asarray(excl, bool)
    if spans_processes(data):
        check_agreement("the frontier, its criterion and the blacklist",
                        *args, crit, excl_np, bit_matrix.n_columns)
    best_col = best = first = None
    for lo, shard in column_shards(data):
        limit = shard_limit(bit_matrix.n_columns, lo, shard)
        if lo and limit == 0:
            continue
        dev = shard.device
        shard_excl = None if excl_np is None else torch.from_numpy(
            excl_np[lo:lo + shard.shape[1]]).to(dev)
        cols, scores = cart_frontier_scores(
            shard, *[a.to(dev) for a in args], crit, limit, block=block,
            excl=shard_excl)
        cols = cols.to(bit_matrix.device, torch.int64) + lo
        scores = scores.to(bit_matrix.device)
        if best is None:
            best_col, best, first = cols, scores, lo
            continue
        take = scores < best
        best_col = torch.where(take, cols, best_col)
        best = torch.where(take, scores, best)
    if best is None:  # every local shard is padding: nothing to offer
        n = len(node_example_sets)
        best = torch.full((n,), torch.inf, device=bit_matrix.device)
        best_col = torch.zeros(n, dtype=torch.int64, device=bit_matrix.device)
    best, best_col = combine_winners(data, first, best, best_col, np.less)
    return _split_list(best_col, best)


def sharded_data(bit_matrix, mesh):
    """``bit_matrix``'s ShardedMatrix on ``mesh``: its own data where it was
    loaded there, else a copy placed once and cached on the matrix (every
    BFS level of every tree comes back here)."""
    data = bit_matrix.data
    if isinstance(data, ShardedMatrix) and data.mesh == mesh:
        return data
    cache = getattr(bit_matrix, "_shard_cache", None)
    if cache is None:
        cache = bit_matrix._shard_cache = {}
    if mesh not in cache:
        cache[mesh] = MeshSharding(mesh).place(data)
    return cache[mesh]


def cart_frontier_splits_sharded(bit_matrix, node_example_sets, altered_priors,
                                 total_n_examples_by_class, criterion, mesh,
                                 excl=None):
    """Column-sharded frontier split scoring over a ("rows", "cols") mesh
    (``grm_tpu``'s name): :func:`cart_frontier_splits_device` on ``mesh``.
    ``excl`` (optional (K,) bool) shards with the columns."""
    return cart_frontier_splits_device(
        bit_matrix, node_example_sets, altered_priors,
        total_n_examples_by_class, criterion, excl=excl, mesh=mesh)


def _frontier_tensors(bit_matrix, node_example_sets, altered_priors,
                      total_n_examples_by_class):
    """(class masks, n_node, priors, totals) of a frontier on the matrix's
    (first) device: the scorer's inputs."""
    masks, n_node, priors, totals = _frontier_masks(
        bit_matrix, node_example_sets, altered_priors,
        total_n_examples_by_class,
    )
    dev = bit_matrix.device
    return (masks_to_tensor(masks, dev), torch.from_numpy(n_node).to(dev),
            torch.from_numpy(priors).to(dev),
            torch.from_numpy(totals).to(dev))


def _split_list(cols, scores):
    """[(column or None, score)] per node from the scorer's tensors."""
    cols = cols.cpu().numpy()
    scores = scores.cpu().numpy().astype(np.float64)
    return [
        (None, np.inf) if not np.isfinite(scores[i]) else
        (int(cols[i]), float(scores[i]))
        for i in range(len(scores))
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
