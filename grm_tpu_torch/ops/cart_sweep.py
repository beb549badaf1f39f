"""The CART frontier sweep: for a whole BFS frontier of tree nodes, the
presence-rule split with the least sum of both children's altered-prior
impurity, in one pass over the packed bit matrix.

Port of ``grm_tpu/ops/pallas_cart_sweep.py``. One CUDA kernel,
``csrc/cart_sweep.cu``, counts ``left = masks AND-POPC matrix`` as a 1-bit
matrix product on the tensor cores (``csrc/bmma_tile.cuh``), scores every
(node, column) pair from the accumulators and reduces each block of columns
to one (least score, lowest column) pair per node;
:func:`cart_frontier_scores` adds the reduction over blocks in torch. Unlike
the Pallas kernel it takes the column-exclusion mask (the k-mer blacklist)
itself, so the argmax engine has one scorer with and without a blacklist.

The kernel reads the class masks as the product's B operand, in the order
its fragments want them: :func:`pack_mask_tiles` (``ops/tiles.py``, shared
with ``scm_sweep``) lays them out as tiles of 4 nodes x 1 class pair x 128
bits of depth, with zeros for the nodes, classes and words that pad a tile. For two classes the kernel does not
compute a score per (node, column): a node with (n0, n1) examples has only
(n0 + 1)(n1 + 1) distinct splits, so the kernel first fills a score table
per node with the same device function and then looks each score up
(:func:`table_plan` says when; more classes, and tables past the budget,
are scored directly).

Numerics follow ``grm_tpu.parallel.cart_device._best_split``: float32,
``scale = priors / totals`` divided once, ``p = scale * count``, classes
summed in class order, Gini child ``(p_t * p_t - sum p * p) / p_t`` and
cross-entropy child ``(-sum [f > 0] f log f) * p_t`` with ``f = p / p_t``,
both 0 where ``p_t`` is not positive; a split with an empty child, a column
at or past ``n_kmers`` and an excluded column score +inf. Ties go to the
lowest column.

Every wrapper launches the kernel for a CUDA tensor and runs the plain
PyTorch version (the same float32 operations in the same order) for a CPU
one. ``class_masks`` are (N, C, W) int32 packed words, ``n_node`` (N, C)
int32 counts, ``excl`` an optional (K,) uint8 mask.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .popcount import _check_matrix, _stream, popcount_colsum_plain
# The tile layout is shared with scm_sweep; its names stay importable here.
from .tiles import (TILE_LANES, TILE_NODES, TILE_WORDS,  # noqa: F401
                    pack_mask_tiles, tile_plan)

__all__ = [
    "BLOCK_K",
    "CRITERIA",
    "MAX_CLASSES",
    "NO_COLUMN",
    "cart_sweep_blocks",
    "cart_sweep_blocks_plain",
    "cart_frontier_scores",
    "cart_frontier_scores_plain",
    "frontier_plan",
    "pack_mask_tiles",
    "table_plan",
    "tile_plan",
]

BLOCK_K = 4096
CRITERIA = ("gini", "cross-entropy")
_CLASS_COUNTS = (2, 3, 4, 6, 8)  # the kernel's instantiations
MAX_CLASSES = _CLASS_COUNTS[-1]
NO_COLUMN = 2**31 - 1  # the column of a (block, node) with no valid split
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "grm_cart_sweep": (
        [_I, _P, _I, _L, _L, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _I, _P,
         _P, _P], _I),
    "grm_cart_sweep_smem_bytes": ([_I, _I, _I], _L),
}
_SMEM_BUDGET = 64 << 10  # three blocks per SM; nodes past it go to grid rows
_SMEM_MAX = 227 << 10
_TABLE_BUDGET = 64 << 20  # bytes of score tables a launch may allocate


def _smem_bytes(w, groups, c):
    """Shared memory of one block of ``csrc/cart_sweep.cu`` that holds
    ``groups`` groups of 4 nodes: their mask tiles, their counts and scales,
    and the reduction scratch of 8 warps x 32 node slots."""
    _, pairs, steps = tile_plan(TILE_NODES * groups, c, w)
    return (4 * groups * pairs * steps * TILE_LANES
            + 2 * 4 * groups * TILE_NODES * c + 2 * 4 * 8 * 32)


def frontier_plan(n, c, w):
    """How a frontier of n nodes x c classes x w words goes to the kernel:
    (the class count of the kernel's instantiation, groups of 4 nodes per
    grid row, shared-memory bytes of a block). Raises ValueError for a shape
    the kernel does not take."""
    if c < 2 or c > MAX_CLASSES:
        raise ValueError("the CART sweep kernel takes at least 2 and at most "
                         "%d classes, got %d" % (MAX_CLASSES, c))
    c_inst = min(x for x in _CLASS_COUNTS if x >= c)
    groups = gpb = tile_plan(n, c, w)[0]
    while gpb > 1 and _smem_bytes(w, gpb, c_inst) > _SMEM_BUDGET:
        gpb = -(-gpb // 2)
    if _smem_bytes(w, gpb, c_inst) > _SMEM_MAX:
        raise ValueError("%d words x %d classes of masks do not fit one "
                         "block's shared memory" % (w, c))
    if -(-groups // gpb) > 65535:
        raise ValueError("too many nodes for one launch")
    return c_inst, gpb, _smem_bytes(w, gpb, c_inst)


def table_plan(n, c, w):
    """Entries per node of the kernel's score tables for a frontier of n
    nodes x c classes x w words, or 0 where the kernel scores directly. A
    two-class node with (n0, n1) examples has (n0 + 1)(n1 + 1) distinct
    child scores, at most (16 w + 1)^2 since n0 + n1 <= 32 w; the tables are
    kept where the whole frontier's fit the budget."""
    cap = (16 * w + 1) ** 2
    if c != 2 or n > 65535 or 4 * n * cap > _TABLE_BUDGET:
        return 0
    return cap


def _check_frontier(matrix, class_masks, n_node, scale, criterion, excl):
    _check_matrix(matrix)
    if criterion not in CRITERIA:
        raise ValueError("criterion must be one of %s" % (CRITERIA,))
    w, k = matrix.shape
    if class_masks.dim() != 3 or class_masks.shape[2] != w \
            or class_masks.dtype != torch.int32:
        raise ValueError("class_masks must be (N, C, W) int32 with W = "
                         "matrix rows")
    n, c = class_masks.shape[:2]
    if c < 1:
        raise ValueError("class_masks needs at least one class")
    for name, t, dtype in (("n_node", n_node, torch.int32),
                           ("scale", scale, torch.float32)):
        if t.dtype != dtype or tuple(t.shape) != (n, c):
            raise ValueError("%s must be %s of shape %s" % (name, dtype, (n, c)))
    for name, t in (("class_masks", class_masks), ("n_node", n_node),
                    ("scale", scale)):
        if t.device != matrix.device:
            raise ValueError("%s is not on the matrix's device" % name)
    if excl is not None and (excl.dtype != torch.uint8
                             or tuple(excl.shape) != (k,)
                             or excl.device != matrix.device):
        raise ValueError("excl must be (K,) uint8 on the matrix's device")


def _child(p, criterion):
    """Impurity of one child times its probability; p is a list of C
    (N, B) float32 tensors, summed in class order."""
    p_t = p[0]
    for pc in p[1:]:
        p_t = p_t + pc
    if criterion == "gini":
        sq = p[0] * p[0]
        for pc in p[1:]:
            sq = sq + pc * pc
        return torch.where(p_t > 0, (p_t * p_t - sq) / p_t, 0.0)
    ent = torch.zeros_like(p_t)
    for pc in p:
        frac = torch.where(p_t > 0, pc / p_t, 0.0)
        ent = ent - torch.where(frac > 0, frac * torch.log(frac), 0.0)
    return ent * p_t


def _split_scores(left, n_node, scale, criterion):
    """float32 scores of the splits with (N, C, B) left-child counts, from
    the nodes' (N, C) counts and scales, and whether neither child is empty:
    the kernels' operations in their order (``csrc/cart_score.cuh``)."""
    c = left.shape[1]
    right = n_node[:, :, None] - left
    sc = scale[:, :, None]
    score = (_child([sc[:, i] * left[:, i].float() for i in range(c)],
                    criterion)
             + _child([sc[:, i] * right[:, i].float() for i in range(c)],
                      criterion))
    return score, (left.sum(1) > 0) & (right.sum(1) > 0)


def cart_sweep_blocks_plain(matrix, class_masks, n_node, scale, criterion,
                            limit, block, excl=None):
    """Plain PyTorch version of :func:`cart_sweep_blocks` (any device)."""
    w, k = matrix.shape
    n, c = class_masks.shape[:2]
    nb = -(-k // block)
    dev = matrix.device
    out_s = torch.empty((nb, n), dtype=torch.float32, device=dev)
    out_c = torch.empty((nb, n), dtype=torch.int32, device=dev)
    flat_masks = class_masks.reshape(n * c, w)
    # Whole blocks per step, with the temporaries bounded.
    step = block * max(1, (1 << 24) // (max(n * c * (w + 8), 1) * block))
    offs = torch.arange(block, device=dev)
    for lo in range(0, k, step):
        hi = min(k, lo + step)
        left = popcount_colsum_plain(matrix[:, lo:hi].contiguous(),
                                     flat_masks).view(n, c, hi - lo)
        score, nonempty = _split_scores(left, n_node, scale, criterion)
        bad = ~nonempty | (torch.arange(lo, hi, device=dev)
                           >= limit)[None, :]
        if excl is not None:
            bad = bad | excl[lo:hi].bool()[None, :]
        score = torch.where(bad, torch.inf, score)
        nblk = -(-(hi - lo) // block)
        score = torch.nn.functional.pad(
            score, (0, nblk * block - (hi - lo)), value=torch.inf
        ).view(n, nblk, block)
        best = score.amin(2)  # (N, nblk)
        first = torch.where(score == best[:, :, None], offs,
                            NO_COLUMN).amin(2)
        starts = lo + block * torch.arange(nblk, device=dev)
        col = torch.where(torch.isinf(best), NO_COLUMN,
                          starts[None, :] + first)
        b0 = lo // block
        out_s[b0:b0 + nblk] = best.T
        out_c[b0:b0 + nblk] = col.T.to(torch.int32)
    return out_s, out_c


def cart_sweep_blocks(matrix, class_masks, n_node, scale, criterion, limit,
                      block, excl=None):
    """Per block of ``block`` columns and node, the least split score and
    the lowest column reaching it: (score (NB, N) float32, col (NB, N)
    int32), NB = ceil(K / block); (+inf, NO_COLUMN) where the block holds no
    valid split of the node. ``scale`` is (N, C) float32 priors / totals;
    columns at or past ``limit`` are padding."""
    _check_frontier(matrix, class_masks, n_node, scale, criterion, excl)
    if matrix.device.type != "cuda":
        return cart_sweep_blocks_plain(matrix, class_masks, n_node, scale,
                                       criterion, limit, block, excl)
    w, k = matrix.shape
    n, c = class_masks.shape[:2]
    if k >= NO_COLUMN:
        raise ValueError("the CART sweep kernel indexes columns in int32")
    c_inst, gpb, smem = frontier_plan(max(n, 1), c, w)
    nb = -(-k // block)
    out_s = torch.empty((nb, n), dtype=torch.float32, device=matrix.device)
    out_c = torch.empty((nb, n), dtype=torch.int32, device=matrix.device)
    if nb == 0 or n == 0:
        return out_s, out_c
    lib = _build.library("cart_sweep", _SIGNATURES)
    if lib.grm_cart_sweep_smem_bytes(w, gpb, c_inst) != smem:
        raise RuntimeError("cart_sweep: the kernel's shared-memory layout is "
                           "not the wrapper's")
    # A class count between two instantiations is filled up with empty
    # classes (mask, count and scale 0): they add +0 to every sum, so the
    # scores stay bit for bit what the plain version gives for c classes.
    if c_inst > c:
        class_masks = torch.nn.functional.pad(class_masks,
                                              (0, 0, 0, c_inst - c))
        n_node = torch.nn.functional.pad(n_node, (0, c_inst - c))
        scale = torch.nn.functional.pad(scale, (0, c_inst - c))
    tiles = pack_mask_tiles(class_masks)
    # Held in locals until after the launch, so that no copy is freed early.
    args = [tiles, n_node.contiguous(), scale.contiguous()]
    excl_c = None if excl is None else excl.contiguous()
    # The score tables: node i takes min((n0 + 1)(n1 + 1), cap) entries from
    # table_off[i] on; the kernel fills them before it sweeps. The buffer
    # holds the entries in use (read back from the device: one small
    # synchronising copy a call), not the n * cap the plan allows.
    cap = table_plan(n, c, w)
    table = table_off = None
    if cap:
        sizes = ((args[1][:, 0].long() + 1) * (args[1][:, 1].long() + 1)
                 ).clamp(max=cap)
        ends = sizes.cumsum(0)
        table_off = (ends - sizes).to(torch.int32)
        table = torch.empty(int(ends[-1]), dtype=torch.float32,
                            device=matrix.device)
    with torch.cuda.device(matrix.device):
        _build.check(lib.grm_cart_sweep(
            CRITERIA.index(criterion), matrix.data_ptr(), w, k,
            min(int(limit), k), *[t.data_ptr() for t in args], n, c_inst, gpb,
            None if excl_c is None else excl_c.data_ptr(), int(block),
            None if table is None else table.data_ptr(),
            None if table is None else table_off.data_ptr(), cap,
            out_s.data_ptr(), out_c.data_ptr(), _stream(matrix)),
            "cart_sweep")
        # One call of the C entry point: with tables that is two CUDA
        # launches, the table fill and then the sweep.
        _build.launches["cart_sweep"] += 1
        _build.cart_frontiers.append((n, criterion))
    return out_s, out_c


def _frontier_scores(blocks, matrix, class_masks, n_node, priors, totals,
                     criterion, n_kmers, block, excl):
    k = matrix.shape[1]
    n, c = class_masks.shape[:2]
    scale = priors.to(torch.float32) / totals.to(torch.float32)
    if scale.dim() == 1:  # (C,) shared -> (N, C) per node
        scale = scale[None, :].expand(n, c)
    bk = max(1, min(BLOCK_K if block is None else int(block), k))
    score, col = blocks(matrix, class_masks, n_node, scale.contiguous(),
                        criterion, n_kmers, bk, excl)
    if score.shape[0] == 0:
        return (torch.full((n,), NO_COLUMN, dtype=torch.int64,
                           device=matrix.device),
                torch.full((n,), torch.inf, device=matrix.device))
    best = score.amin(0)
    best_col = torch.where(score == best[None, :], col.to(torch.int64),
                           NO_COLUMN).amin(0)
    return best_col, best


def cart_frontier_scores(matrix, class_masks, n_node, priors, totals,
                         criterion, n_kmers, block=None, excl=None):
    """Best presence-rule split per frontier node, one matrix pass.

    matrix: (W, K) int32 packed presence. class_masks: (N, C, W) int32
    packed example masks per node per class. n_node: (N, C) int32 example
    counts. priors/totals: (C,) altered priors and total class sizes shared
    by all nodes, or (N, C) per-node values (the forest-batched engine
    scores frontiers of many trees in one pass). Returns (best_col (N,)
    int64, best_score (N,) float32); a +inf score means no valid split for
    that node (its column is then NO_COLUMN).
    """
    return _frontier_scores(cart_sweep_blocks, matrix, class_masks, n_node,
                            priors, totals, criterion, n_kmers, block, excl)


def cart_frontier_scores_plain(matrix, class_masks, n_node, priors, totals,
                               criterion, n_kmers, block=None, excl=None):
    """Plain PyTorch version of :func:`cart_frontier_scores` (any device)."""
    return _frontier_scores(cart_sweep_blocks_plain, matrix, class_masks,
                            n_node, priors, totals, criterion, n_kmers,
                            block, excl)
