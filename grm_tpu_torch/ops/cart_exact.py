"""The exact CART engine's sweeps: the tuple tables and the compaction of
candidate and equivalent columns, per BFS frontier node, each one pass over
the packed bit matrix.

Port of the XLA programs of ``grm_tpu/parallel/cart_exact.py``; the CUDA
kernels are ``csrc/cart_exact.cu``:

- :func:`cart_exact_tuples` replaces ``_distinct_chunk`` (:165),
  ``_tuple_scatter_chunk`` (:124) and ``_winner_chunk`` (:293). For every
  valid column whose float32 split score is at most its node's threshold it
  folds the column into two tables indexed by the mixed-radix key of its
  left-child class counts (``_mixed_radix_key``, :104): the largest train
  occurrence and the lowest column at it (one int64 ``((occ + 1) << 32) |
  (0xFFFFFFFF - col)``, a max; 0 = absent), and the lowest column (a min;
  ``NO_COLUMN`` = absent). The TPU rig extracted at most 16 distinct keys a
  block by iterated reductions and escalated to a scatter pass past that
  (scatters ran at ~90M updates/s there); on the card the tables are
  filled with native atomics, with no budget and no escalation.
- :func:`cart_exact_select` replaces ``_gather_pass``'s second sweep
  (:321) and ``_gather2_chunk`` (:437) (``mode="gather"``: every valid
  column scoring at most the threshold, with its class counts and
  occurrence) and ``_equiv_chunk`` (:469) (``mode="equiv"``: every valid
  column whose key is in the node's winning-key set at the node's occurrence
  maximum). Output is node-major and ascending by column, with no budget:
  the kernel counts the hits per (column block, node), an exclusive scan in
  torch gives each its offset, and a second launch writes.

Both count with the 1-bit tensor-core product of ``csrc/bmma_tile.cuh``;
a node's mask rows are its class masks, then its tree's train mask (the
occurrence tiebreak's population), packed by :func:`pack_exact_tiles`. The
scores are ``csrc/cart_score.cuh``'s, the functions the frontier sweep
(:mod:`grm_tpu_torch.ops.cart_sweep`, the engine's pass 1) uses, so a
column's score is the bits whose minimum set its node's threshold. What
bounds them on the H100, and what the design does about it, is in the
source's note: one read of the matrix, then the direct scores on the
special-function pipe, and in the hot-key case same-address atomics
(aggregated within the warp first).

Each wrapper launches the kernel for a CUDA tensor and runs its plain
PyTorch version (unpacked counts, ``scatter_reduce_``, a boolean mask and a
sort) for a CPU one. Inputs: ``matrix`` (W, K) int32 words, ``class_masks``
(N, C, W) int32, ``train_masks`` (N, W) int32, ``n_node`` (N, C) int32,
``scale`` (N, C) float32 = priors / totals (the same tensor pass 1 scores
with), ``thresh`` (N,) float32, ``excl`` an optional (K,) uint8 mask;
columns at or past ``limit`` are padding.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .cart_sweep import (_CLASS_COUNTS, CRITERIA, MAX_CLASSES, NO_COLUMN,
                         _split_scores)
from .popcount import _check_matrix, _stream, popcount_colsum_plain
from .tiles import TILE_LANES, TILE_NODES, pack_mask_tiles, tile_plan

__all__ = [
    "BITMAP_WORDS",
    "BLOCK_K",
    "MODES",
    "S_MAX",
    "cart_exact_select",
    "cart_exact_select_plain",
    "cart_exact_tuples",
    "cart_exact_tuples_plain",
    "decode_keys",
    "exact_plan",
    "key_bitmap",
    "lattice_sizes",
    "mixed_radix_keys",
    "pack_exact_tiles",
    "table_rows",
]

S_MAX = 1 << 16  # the largest count lattice of a tuple-regime node
BITMAP_WORDS = S_MAX // 32
BLOCK_K = 4096
MODES = ("gather", "equiv")
_MODE_CODE = {"tuples": 0, "gather": 1, "equiv": 2}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "grm_cart_exact_tuples": (
        [_I, _P, _I, _L, _L, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P,
         _P], _I),
    "grm_cart_exact_select": (
        [_I, _I, _I, _P, _I, _L, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
         _I, _P, _P, _P, _P, _P, _L, _P], _I),
    "grm_cart_exact_smem_bytes": ([_I, _I, _I, _I], _L),
}
_SMEM_BUDGET = 64 << 10  # of a block's nodes (tiles, counts, scales)
_SMEM_MAX = 227 << 10
_WARPS = 8


def _row_pairs(c):
    """Pairs of mask rows per node: c classes, then the train mask."""
    return (c + 2) // 2


def _chunk_groups(c):
    """Groups of 4 nodes a pass of the kernel keeps counts for."""
    rp = _row_pairs(c)
    return 1 if rp >= 4 else 4 // rp


def _smem_bytes(mode, w, groups, c):
    """``csrc/cart_exact.cu``'s layout(): shared memory of one block."""
    nodes = groups * TILE_NODES
    slots = _chunk_groups(c) * TILE_NODES
    steps = tile_plan(1, 2, w)[2]
    o = groups * _row_pairs(c) * steps * TILE_LANES * 4
    o += 2 * nodes * c * 4 + 2 * nodes * 4 + 2 * _WARPS * slots * 4
    o = (o + 7) & ~7
    o += slots * 8
    if mode == "equiv":
        o += slots * BITMAP_WORDS * 4
    return o


def exact_plan(mode, n, c, w):
    """How a frontier of n nodes x c classes x w words goes to the kernel in
    ``mode`` ("tuples", "gather" or "equiv"): (the class count of the
    kernel's instantiation, groups of 4 nodes per grid row, shared-memory
    bytes of a block). Raises ValueError for a shape the kernel does not
    take."""
    if c < 2 or c > MAX_CLASSES:
        raise ValueError("the exact CART kernels take at least 2 and at most "
                         "%d classes, got %d" % (MAX_CLASSES, c))
    c_inst = min(x for x in _CLASS_COUNTS if x >= c)
    bits = _smem_bytes(mode, w, 1, c_inst) - _smem_bytes("tuples", w, 1,
                                                         c_inst)
    groups = gpb = -(-n // TILE_NODES)
    while gpb > 1 and _smem_bytes(mode, w, gpb, c_inst) - bits > _SMEM_BUDGET:
        gpb = -(-gpb // 2)
    smem = _smem_bytes(mode, w, gpb, c_inst)
    if smem > _SMEM_MAX:
        raise ValueError("%d words x %d classes of masks do not fit one "
                         "block's shared memory" % (w, c))
    if -(-groups // gpb) > 65535:
        raise ValueError("too many nodes for one launch")
    return c_inst, gpb, smem


def lattice_sizes(n_node):
    """(N,) int64: each node's count lattice prod(n_c + 1), the number of
    distinct left-child count vectors (and of mixed-radix keys)."""
    return (n_node.to(torch.int64) + 1).prod(1)


def mixed_radix_keys(left, n_node):
    """(N, C, B) left counts and (N, C) node counts -> (N, B) int64 keys
    ``((l0 * r1 + l1) * r2 + l2) ...`` with ``r_c = n_c + 1``
    (``grm_tpu.parallel.cart_exact._mixed_radix_key``)."""
    key = left[:, 0].to(torch.int64)
    for ci in range(1, left.shape[1]):
        key = key * (n_node[:, ci, None].to(torch.int64) + 1) + left[:, ci]
    return key


def decode_keys(keys, n_node_row):
    """The inverse of :func:`mixed_radix_keys` for one node: (T,) int64
    numpy keys and its (C,) counts -> list of C (T,) int64 left counts."""
    radix = np.asarray(n_node_row, np.int64) + 1
    rem = np.asarray(keys, np.int64).copy()
    lefts = [None] * len(radix)
    for ci in range(len(radix) - 1, 0, -1):
        lefts[ci] = rem % radix[ci]
        rem //= radix[ci]
    lefts[0] = rem
    return lefts


def key_bitmap(key_sets):
    """Winning-key sets (one (T,) int array per node) -> (N, BITMAP_WORDS)
    int32 numpy bitmap, bit ``key % 32`` of word ``key // 32``."""
    out = np.zeros((len(key_sets), BITMAP_WORDS), np.uint32)
    for i, keys in enumerate(key_sets):
        keys = np.asarray(keys, np.int64)
        if keys.size:
            np.bitwise_or.at(out[i], keys // 32,
                             np.uint32(1) << (keys % 32).astype(np.uint32))
    return out.view(np.int32)


def pack_exact_tiles(class_masks, train_masks, c_inst):
    """The kernels' B operand: per node the class masks, filled up with
    empty classes to ``c_inst``, then the train mask, in
    :func:`grm_tpu_torch.ops.tiles.pack_mask_tiles`'s fragment order."""
    n, c, w = class_masks.shape
    rows = torch.cat([
        torch.nn.functional.pad(class_masks, (0, 0, 0, c_inst - c)),
        train_masks[:, None, :]], dim=1)
    return pack_mask_tiles(rows)


def _check(matrix, class_masks, train_masks, n_node, scale, criterion,
           excl, **per_node):
    _check_matrix(matrix)
    if criterion not in CRITERIA:
        raise ValueError("criterion must be one of %s" % (CRITERIA,))
    w, k = matrix.shape
    if class_masks.dim() != 3 or class_masks.shape[2] != w \
            or class_masks.dtype != torch.int32:
        raise ValueError("class_masks must be (N, C, W) int32 with W = "
                         "matrix rows")
    n, c = class_masks.shape[:2]
    shapes = {"train_masks": ((n, w), torch.int32),
              "n_node": ((n, c), torch.int32),
              "scale": ((n, c), torch.float32),
              "thresh": ((n,), torch.float32),
              "occmax": ((n,), torch.int32),
              "bitmap": ((n, BITMAP_WORDS), torch.int32)}
    tensors = dict(per_node, train_masks=train_masks, n_node=n_node,
                   scale=scale)
    for name, t in tensors.items():
        shape, dtype = shapes[name]
        if t is None or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError("%s must be %s of shape %s"
                             % (name, dtype, shape))
        if t.device != matrix.device:
            raise ValueError("%s is not on the matrix's device" % name)
    if excl is not None and (excl.dtype != torch.uint8
                             or tuple(excl.shape) != (k,)
                             or excl.device != matrix.device):
        raise ValueError("excl must be (K,) uint8 on the matrix's device")
    if k >= NO_COLUMN:
        raise ValueError("the exact CART kernels index columns in int32")
    sizes = lattice_sizes(n_node)
    return n, c, w, k, sizes


def _counted_chunks(matrix, class_masks, train_masks, limit, excl):
    """The plain versions' sweep: per chunk of columns (lo, cols (B,),
    left (N, C, B) int64, occ (N, B) int64, valid (1, B) bool)."""
    w, k = matrix.shape
    n, c = class_masks.shape[:2]
    rows = torch.cat([class_masks, train_masks[:, None, :]], 1).reshape(
        n * (c + 1), w)
    step = max(1024, (1 << 22) // max(n * (c + 1), 1))
    for lo in range(0, k, step):
        hi = min(k, lo + step)
        counts = popcount_colsum_plain(matrix[:, lo:hi].contiguous(), rows
                                       ).view(n, c + 1, hi - lo).long()
        cols = torch.arange(lo, hi, device=matrix.device)
        valid = cols < limit
        if excl is not None:
            valid = valid & (excl[lo:hi] == 0)
        yield cols, counts[:, :c], counts[:, c], valid[None, :]


def _passing(left, n_node, scale, thresh, criterion):
    """(N, B) bool: neither child empty and the split's float32 score (the
    frontier sweep's) at most the node's threshold."""
    score, nonempty = _split_scores(left, n_node, scale, criterion)
    return nonempty & (score <= thresh[:, None])


def _table_offsets(sizes):
    ends = sizes.cumsum(0)
    return ends - sizes, int(ends[-1]) if len(ends) else 0


def cart_exact_tuples_plain(matrix, class_masks, train_masks, n_node, scale,
                            thresh, criterion, limit, excl=None):
    """Plain PyTorch version of :func:`cart_exact_tuples` (any device)."""
    n, c, w, k, sizes = _check(matrix, class_masks, train_masks, n_node,
                               scale, criterion, excl, thresh=thresh)
    _check_lattices(sizes)
    table_off, total = _table_offsets(sizes)
    dev = matrix.device
    occ_tab = torch.zeros(total, dtype=torch.int64, device=dev)
    col_tab = torch.full((total,), NO_COLUMN, dtype=torch.int32, device=dev)
    for cols, left, occ, valid in _counted_chunks(
            matrix, class_masks, train_masks, limit, excl):
        hit = valid & _passing(left, n_node, scale, thresh, criterion)
        if not bool(hit.any()):
            continue
        entry = (table_off[:, None] + mixed_radix_keys(left, n_node))[hit]
        col = cols[None, :].expand_as(hit)[hit]
        occ_tab.scatter_reduce_(0, entry, ((occ[hit] + 1) << 32)
                                | (0xFFFFFFFF - col), "amax")
        col_tab.scatter_reduce_(0, entry, col.to(torch.int32), "amin")
    return occ_tab, col_tab, table_off


def cart_exact_tuples(matrix, class_masks, train_masks, n_node, scale, thresh,
                      criterion, limit, excl=None):
    """The tuple tables of a frontier whose every node's count lattice is at
    most ``S_MAX``: (occ_tab (T,) int64, col_tab (T,) int32, table_off (N,)
    int64), node i's entries from ``table_off[i]`` on, one per key of its
    lattice. ``occ_tab`` holds ``((occ + 1) << 32) | (0xFFFFFFFF - col)`` of
    the largest train occurrence among the key's passing columns and the
    lowest column at it (0: no column passed), ``col_tab`` the key's lowest
    passing column (``NO_COLUMN``: none)."""
    n, c, w, k, sizes = _check(matrix, class_masks, train_masks, n_node,
                               scale, criterion, excl, thresh=thresh)
    _check_lattices(sizes)
    if matrix.device.type != "cuda":
        return cart_exact_tuples_plain(matrix, class_masks, train_masks,
                                       n_node, scale, thresh, criterion,
                                       limit, excl)
    table_off, total = _table_offsets(sizes)
    if total >= NO_COLUMN:
        raise ValueError("the frontier's tables exceed int32 entries")
    dev = matrix.device
    occ_tab = torch.zeros(total, dtype=torch.int64, device=dev)
    col_tab = torch.full((total,), NO_COLUMN, dtype=torch.int32, device=dev)
    if n == 0 or k == 0:
        return occ_tab, col_tab, table_off
    c_inst, gpb, smem = exact_plan("tuples", n, c, w)
    lib = _build.library("cart_exact", _SIGNATURES)
    if lib.grm_cart_exact_smem_bytes(0, w, gpb, c_inst) != smem:
        raise RuntimeError("cart_exact: the kernel's shared-memory layout is "
                           "not the wrapper's")
    pad = (0, c_inst - c)
    # Held in locals until after the launch, so that no copy is freed early.
    args = [pack_exact_tiles(class_masks, train_masks, c_inst),
            torch.nn.functional.pad(n_node, pad).contiguous(),
            torch.nn.functional.pad(scale, pad).contiguous(),
            thresh.contiguous(), table_off.to(torch.int32)]
    excl_c = None if excl is None else excl.contiguous()
    bk = min(BLOCK_K, k)
    with torch.cuda.device(dev):
        _build.check(lib.grm_cart_exact_tuples(
            CRITERIA.index(criterion), matrix.data_ptr(), w, k,
            min(int(limit), k), *[t.data_ptr() for t in args], n, c_inst, gpb,
            None if excl_c is None else excl_c.data_ptr(), bk,
            occ_tab.data_ptr(), col_tab.data_ptr(), _stream(matrix)),
            "cart_exact_tuples")
        _build.launches["cart_exact_tuples"] += 1
        _build.exact_frontiers.append(("cart_exact_tuples", n, c))
    return occ_tab, col_tab, table_off


def table_rows(occ_tab, col_tab, table_off):
    """The present entries of the tuple tables, compacted on the tables'
    device: (node, key, occmax, col at occmax, lowest col), each (T',)
    int64, ascending by node then key."""
    entry = torch.nonzero(occ_tab).squeeze(1)
    node = torch.searchsorted(table_off, entry, right=True) - 1
    packed = occ_tab[entry]
    return (node, entry - table_off[node], (packed >> 32) - 1,
            0xFFFFFFFF - (packed & 0xFFFFFFFF), col_tab[entry].long())


def _select_check(mode, thresh, occmax, bitmap):
    if mode not in MODES:
        raise ValueError("mode must be one of %s" % (MODES,))
    return ({"thresh": thresh} if mode == "gather"
            else {"occmax": occmax, "bitmap": bitmap})


def _check_lattices(sizes):
    if bool((sizes > S_MAX).any()):
        raise ValueError("a node's count lattice exceeds S_MAX")


def cart_exact_select_plain(matrix, class_masks, train_masks, n_node, scale,
                            criterion, limit, mode, thresh=None, occmax=None,
                            bitmap=None, excl=None):
    """Plain PyTorch version of :func:`cart_exact_select` (any device)."""
    n, c, w, k, sizes = _check(
        matrix, class_masks, train_masks, n_node, scale, criterion, excl,
        **_select_check(mode, thresh, occmax, bitmap))
    if mode == "equiv":
        _check_lattices(sizes)
    nodes, cols, lefts, occs = [], [], [], []
    for col, left, occ, valid in _counted_chunks(
            matrix, class_masks, train_masks, limit, excl):
        if mode == "gather":
            hit = valid & _passing(left, n_node, scale, thresh, criterion)
        else:
            key = mixed_radix_keys(left, n_node)
            word = torch.gather(bitmap, 1, key >> 5)
            hit = (valid & ((word >> (key & 31)) & 1).bool()
                   & ((occmax[:, None] < 0) | (occ == occmax[:, None])))
        node, at = torch.nonzero(hit, as_tuple=True)
        nodes.append(node)
        cols.append(col[at])
        lefts.append(left[node, :, at])
        occs.append(occ[node, at])
    dev = matrix.device
    node = torch.cat(nodes) if nodes else torch.zeros(0, dtype=torch.int64,
                                                      device=dev)
    order = torch.argsort(node, stable=True)  # chunks are in column order
    starts = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    starts[1:] = torch.bincount(node, minlength=n).cumsum(0)
    out_col = (torch.cat(cols)[order] if cols else node).to(torch.int32)
    if mode == "equiv":
        return starts, out_col, None, None
    left = (torch.cat(lefts)[order] if lefts
            else torch.zeros((0, c), dtype=torch.int64, device=dev))
    occ = torch.cat(occs)[order] if occs else node
    return (starts, out_col, left.T.to(torch.int32).contiguous(),
            occ.to(torch.int32))


def cart_exact_select(matrix, class_masks, train_masks, n_node, scale,
                      criterion, limit, mode, thresh=None, occmax=None,
                      bitmap=None, excl=None):
    """Compact, per node, every valid column that ``mode`` selects:

    - "gather": split score (float32) at most ``thresh[i]``;
    - "equiv": mixed-radix key set in ``bitmap[i]`` (:func:`key_bitmap`;
      the node's count lattice must be at most ``S_MAX``) and train
      occurrence equal to ``occmax[i]`` (any, where it is negative).

    Returns (starts (N + 1,) int64, cols (T,) int32, left (C, T) int32, occ
    (T,) int32): node i's columns are ``cols[starts[i]:starts[i + 1]]``,
    ascending; ``left`` and ``occ`` (gather mode only, else None) are their
    class counts and occurrences. One call is two launches of the kernel:
    one counts the hits per (column block, node), the second writes."""
    n, c, w, k, sizes = _check(
        matrix, class_masks, train_masks, n_node, scale, criterion, excl,
        **_select_check(mode, thresh, occmax, bitmap))
    if mode == "equiv":
        _check_lattices(sizes)
    if matrix.device.type != "cuda":
        return cart_exact_select_plain(matrix, class_masks, train_masks,
                                       n_node, scale, criterion, limit, mode,
                                       thresh, occmax, bitmap, excl)
    dev = matrix.device
    if n == 0 or k == 0:
        return (torch.zeros(n + 1, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros((c, 0), dtype=torch.int32, device=dev)
                if mode == "gather" else None,
                torch.zeros(0, dtype=torch.int32, device=dev)
                if mode == "gather" else None)
    c_inst, gpb, smem = exact_plan(mode, n, c, w)
    lib = _build.library("cart_exact", _SIGNATURES)
    code = _MODE_CODE[mode]
    if lib.grm_cart_exact_smem_bytes(code, w, gpb, c_inst) != smem:
        raise RuntimeError("cart_exact: the kernel's shared-memory layout is "
                           "not the wrapper's")
    pad = (0, c_inst - c)
    args = [pack_exact_tiles(class_masks, train_masks, c_inst),
            torch.nn.functional.pad(n_node, pad).contiguous(),
            torch.nn.functional.pad(scale, pad).contiguous(),
            None if thresh is None else thresh.contiguous(),
            None if occmax is None else occmax.contiguous(),
            None if bitmap is None else bitmap.contiguous()]
    ptrs = [None if t is None else t.data_ptr() for t in args]
    excl_c = None if excl is None else excl.contiguous()
    bk = min(BLOCK_K, k)
    nb = -(-k // bk)
    counts = torch.zeros((nb, n), dtype=torch.int64, device=dev)

    def launch(write, offsets, out_col, out_left, out_occ, total):
        _build.check(lib.grm_cart_exact_select(
            code, write, CRITERIA.index(criterion), matrix.data_ptr(), w, k,
            min(int(limit), k), *ptrs, n, c_inst, gpb,
            None if excl_c is None else excl_c.data_ptr(), bk,
            counts.data_ptr(), offsets, out_col, out_left, out_occ, total,
            _stream(matrix)), "cart_exact_select")

    with torch.cuda.device(dev):
        launch(0, None, None, None, None, 0)
        per_node = counts.sum(0)
        starts = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        starts[1:] = per_node.cumsum(0)
        offsets = (starts[:-1][None, :] + counts.cumsum(0) - counts
                   ).contiguous()
        total = int(starts[-1])
        out_col = torch.empty(total, dtype=torch.int32, device=dev)
        out_left = out_occ = None
        if mode == "gather":
            out_left = torch.empty((c_inst, total), dtype=torch.int32,
                                   device=dev)
            out_occ = torch.empty(total, dtype=torch.int32, device=dev)
        if total:
            launch(1, offsets.data_ptr(), out_col.data_ptr(),
                   None if out_left is None else out_left.data_ptr(),
                   None if out_occ is None else out_occ.data_ptr(), total)
        # One call of the wrapper: two CUDA launches, counted as one.
        _build.launches["cart_exact_select"] += 1
        _build.exact_frontiers.append(("cart_exact_select:" + mode, n, c))
    if out_left is not None:
        out_left = out_left[:c]
    return starts, out_col, out_left, out_occ
