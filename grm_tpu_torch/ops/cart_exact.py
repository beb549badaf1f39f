"""The exact CART engine's sweeps: the tuple tables and the compaction of
candidate and equivalent columns, per BFS frontier node, each one read of
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
  block by iterated reductions and escalated to a scatter pass past that;
  on the card the tables are filled with native atomics, with no budget and
  no escalation.
- :func:`cart_exact_select` replaces ``_gather_pass``'s second sweep
  (:321) and ``_gather2_chunk`` (:437) (``mode="gather"``: every valid
  column scoring at most the threshold, with its class counts and
  occurrence) and ``_equiv_chunk`` (:469) (``mode="equiv"``: every valid
  column whose key is in the node's winning-key set at the node's occurrence
  maximum). Output is node-major and ascending by column, with no budget.

What the design does, and why (the source's note says what bounds each
kernel on the H100):

- *Pass bitmaps.* A split's score is a function of its key alone, and a
  tuple-regime node has at most ``S_MAX`` keys, so :func:`pass_bitmap`
  scores each key of every lattice once (``csrc/cart_score.cuh``, the
  frontier sweep's function, so each bit is the decision a direct score
  would take) and the tuple sweep tests one bit per (node, column) instead
  of scoring it. Equiv mode tests the winning-key bitmap the same way;
  gather mode (lattices past ``S_MAX``) still scores directly.
- *Read once.* The A fragments of a 16-column tile are read once, into
  registers (up to 512 genomes) or by ``cp.async`` into shared memory
  (deeper), and every node of a grid row is counted from them.
- *Private tables.* Nodes with small lattices (the hot-key case: millions
  of columns on a few keys) fold into a copy of their tables in the block's
  shared memory, merged into the global tables once per block with the same
  max and min: the tables stay deterministic.
- *Hit bits.* The counting launch keeps its hits as bits and writes, per
  (column block, node), the count and the hit words; an exclusive scan in
  torch gives each its offset, and the writing launch places the hits from
  the words alone (``__popc`` prefixes), recounting only the hit columns in
  gather mode.

:func:`exact_layout` plans a launch: groups of 4 nodes per grid row, the
bitmaps' word offsets (:func:`bitmap_offsets`) and whether a row's bitmaps
sit in shared memory, the private tables, and the shared-memory bytes
(:func:`_smem_bytes`, the source's ``layout()``).

Each wrapper launches the kernels for a CUDA tensor and runs its plain
PyTorch version (unpacked counts, ``scatter_reduce_``, a boolean mask and a
sort) for a CPU one; one call of a wrapper counts one launch, whatever
number of CUDA launches it makes. Inputs: ``matrix`` (W, K) int32 words,
``class_masks`` (N, C, W) int32, ``train_masks`` (N, W) int32, ``n_node``
(N, C) int32, ``scale`` (N, C) float32 = priors / totals (the same tensor
pass 1 scores with), ``thresh`` (N,) float32, ``excl`` an optional (K,)
uint8 mask; columns at or past ``limit`` are padding.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

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
    "PRIV_LATTICE",
    "S_MAX",
    "bitmap_offsets",
    "cart_exact_select",
    "cart_exact_select_plain",
    "cart_exact_tuples",
    "cart_exact_tuples_plain",
    "decode_keys",
    "exact_layout",
    "exact_plan",
    "key_bitmap",
    "lattice_sizes",
    "mixed_radix_keys",
    "pack_exact_tiles",
    "pass_bitmap",
    "pass_bitmap_plain",
    "table_rows",
]

S_MAX = 1 << 16  # the largest count lattice of a tuple-regime node
BITMAP_WORDS = S_MAX // 32
BLOCK_K = 4096  # the kernels' column block (kBlockCols)
HIT_WORDS = BLOCK_K // 32  # hit words per (column block, node)
MODES = ("gather", "equiv")
PRIV_LATTICE = 1024  # the largest lattice whose tables a block keeps itself
_PRIV_ENTRIES = 2048  # private table entries of a grid row
_MODE_CODE = {"tuples": 0, "gather": 1, "equiv": 2}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "grm_cart_exact_bitmap": ([_I, _P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "grm_cart_exact_tuples": (
        [_I, _P, _I, _L, _L, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
         _P, _P, _P, _P], _I),
    "grm_cart_exact_select": (
        [_I, _I, _P, _I, _L, _L, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
         _P, _P, _P, _P], _I),
    "grm_cart_exact_write": (
        [_I, _P, _I, _L, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _L, _P],
        _I),
    "grm_cart_exact_smem_bytes": ([_I, _I, _I, _I, _I, _I], _L),
}
_SMEM_BUDGET = 64 << 10  # of a block's nodes (tiles, counts, scales, hits)
_BITS_BUDGET = 64 << 10  # of a grid row's bitmaps held in shared memory
_SMEM_MAX = 227 << 10
_WARPS = 8
_REG_STEPS = 4  # deepest A fragments (128-bit steps) held in registers


def _row_pairs(c):
    """Pairs of mask rows per node: c classes, then the train mask."""
    return (c + 2) // 2


def _stage_bytes(w):
    """The warps' slabs of A fragments, past _REG_STEPS steps of depth."""
    steps = tile_plan(1, 2, w)[2]
    return _WARPS * steps * TILE_LANES * 8 if steps > _REG_STEPS else 0


def _smem_bytes(mode, w, groups, c, bit_words=0, priv_entries=0):
    """``csrc/cart_exact.cu``'s layout(): shared memory of one block that
    holds ``groups`` groups of 4 nodes, ``bit_words`` words of bitmaps and
    ``priv_entries`` private table entries."""
    nodes = groups * TILE_NODES
    steps = tile_plan(1, 2, w)[2]
    o = groups * _row_pairs(c) * steps * TILE_LANES * 4
    o += 2 * nodes * c * 4 + 4 * nodes * 4 + bit_words * 4
    o = (o + 7) & ~7
    o += priv_entries * 12
    if mode != "tuples":
        o += nodes * HIT_WORDS * 4
    o = (o + 15) & ~15
    return o + _stage_bytes(w)


def exact_plan(mode, n, c, w):
    """How a frontier of n nodes x c classes x w words goes to the kernel in
    ``mode`` ("tuples", "gather" or "equiv"): (the class count of the
    kernel's instantiation, groups of 4 nodes per grid row, shared-memory
    bytes of a block without bitmaps or private tables). Raises ValueError
    for a shape the kernel does not take."""
    if c < 2 or c > MAX_CLASSES:
        raise ValueError("the exact CART kernels take at least 2 and at most "
                         "%d classes, got %d" % (MAX_CLASSES, c))
    c_inst = min(x for x in _CLASS_COUNTS if x >= c)
    stage = _stage_bytes(w)
    groups = gpb = -(-n // TILE_NODES)
    while gpb > 1 and _smem_bytes(mode, w, gpb, c_inst) - stage > \
            _SMEM_BUDGET:
        gpb = -(-gpb // 2)
    smem = _smem_bytes(mode, w, gpb, c_inst)
    if smem > _SMEM_MAX:
        raise ValueError("%d words x %d classes of masks do not fit one "
                         "block's shared memory" % (w, c))
    if -(-groups // gpb) > 65535:
        raise ValueError("too many nodes for one launch")
    return c_inst, gpb, smem


def bitmap_offsets(sizes):
    """(N + 1,) int64 numpy: node i's bitmap words are ``[off[i], off[i +
    1])``, ceil(lattice / 32) of them, bit ``key % 32`` of word ``key //
    32``."""
    words = -(-np.asarray(sizes, np.int64) // 32)
    return np.concatenate([[0], np.cumsum(words)]).astype(np.int64)


def exact_layout(mode, sizes, c, w):
    """The plan of a launch over nodes whose count lattices are ``sizes``
    ((N,) ints): :func:`exact_plan`'s grid rows, then in tuples and equiv
    mode the bitmaps (in shared memory when a row's fit ``_BITS_BUDGET`` and
    the block's limit), and in tuples mode the private tables: in each grid
    row, in node order, every node whose lattice is at most
    ``PRIV_LATTICE`` while the row's entries stay within ``_PRIV_ENTRIES``.

    Returns a namespace: ``c_inst``, ``gpb`` (groups of 4 nodes per grid
    row), ``bit_off`` ((N + 1,) int64 word offsets of the bitmaps, all 0 in
    gather mode), ``bit_words`` (a grid row's bitmap words held in shared
    memory; 0 = read from global memory), ``priv_off`` ((N,) int32 offset of
    a node's private tables in its grid row; -1 = none), ``priv_entries``
    (private entries a block holds), ``smem`` (bytes of shared memory of
    a block), ``deep`` (the masks past ``_REG_STEPS`` steps: each warp
    stages a tile's A fragments in shared memory) and ``reads`` (grid rows:
    each reads the matrix once)."""
    sizes = np.asarray(sizes, np.int64)
    n = len(sizes)
    c_inst, gpb, _ = exact_plan(mode, n, c, w)
    rows = gpb * TILE_NODES
    bit_off = bitmap_offsets(sizes if mode != "gather" else np.zeros(n))
    priv_off = np.full(n, -1, np.int32)
    priv_entries = 0
    if mode == "tuples":
        for lo in range(0, n, rows):
            used = 0
            for i in range(lo, min(n, lo + rows)):
                if sizes[i] <= PRIV_LATTICE and \
                        used + sizes[i] <= _PRIV_ENTRIES:
                    priv_off[i] = used
                    used += int(sizes[i])
            priv_entries = max(priv_entries, used)
        if _smem_bytes(mode, w, gpb, c_inst, 0, priv_entries) > _SMEM_MAX:
            priv_off[:] = -1
            priv_entries = 0
    bit_words = 0
    if mode != "gather":
        row_words = max(int(bit_off[min(n, lo + rows)] - bit_off[lo])
                        for lo in range(0, n, rows))
        if row_words * 4 <= _BITS_BUDGET and _smem_bytes(
                mode, w, gpb, c_inst, row_words, priv_entries) <= _SMEM_MAX:
            bit_words = row_words
    return SimpleNamespace(
        c_inst=c_inst, gpb=gpb, bit_off=bit_off, bit_words=bit_words,
        priv_off=priv_off, priv_entries=priv_entries,
        smem=_smem_bytes(mode, w, gpb, c_inst, bit_words, priv_entries),
        deep=_stage_bytes(w) > 0, reads=-(-n // rows))


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


def _check_bitmap_inputs(n_node, scale, thresh, criterion):
    if criterion not in CRITERIA:
        raise ValueError("criterion must be one of %s" % (CRITERIA,))
    if n_node.dim() != 2 or n_node.dtype != torch.int32:
        raise ValueError("n_node must be (N, C) int32")
    n, c = n_node.shape
    if c < 2 or c > MAX_CLASSES:
        raise ValueError("the exact CART kernels take at least 2 and at most "
                         "%d classes, got %d" % (MAX_CLASSES, c))
    for name, t, shape in (("scale", scale, (n, c)), ("thresh", thresh, (n,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError("%s must be float32 of shape %s" % (name, shape))
        if t.device != n_node.device:
            raise ValueError("%s is not on n_node's device" % name)
    sizes = lattice_sizes(n_node).cpu().numpy()
    _check_lattices(torch.from_numpy(sizes))
    return sizes


def _pack_bits(ok):
    """(B,) bool -> (ceil(B / 32),) int32 words, bit ``i % 32`` of word
    ``i // 32``."""
    bits = torch.nn.functional.pad(ok.to(torch.int64),
                                   (0, -len(ok) % 32)).view(-1, 32)
    word = (bits << torch.arange(32, device=ok.device)).sum(1)
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def pass_bitmap_plain(n_node, scale, thresh, criterion):
    """Plain PyTorch version of :func:`pass_bitmap` (any device): every key
    of each node's lattice decoded to its left counts and scored with
    :func:`grm_tpu_torch.ops.cart_sweep._split_scores`."""
    sizes = _check_bitmap_inputs(n_node, scale, thresh, criterion)
    dev = n_node.device
    radix = (n_node.cpu().to(torch.int64) + 1).tolist()
    words = [torch.zeros(0, dtype=torch.int32, device=dev)]
    for i, size in enumerate(sizes):
        rem = torch.arange(int(size), device=dev)
        left = [None] * len(radix[i])
        for ci in range(len(radix[i]) - 1, 0, -1):
            left[ci] = rem % radix[i][ci]
            rem = rem // radix[i][ci]
        left[0] = rem
        score, nonempty = _split_scores(torch.stack(left)[None],
                                        n_node[i:i + 1], scale[i:i + 1],
                                        criterion)
        words.append(_pack_bits(nonempty[0] & (score[0] <= thresh[i])))
    return (torch.cat(words),
            torch.from_numpy(bitmap_offsets(sizes)).to(dev))


def _fill_pass_bitmap(lib, n_node, scale, thresh, bit_off, bit_off_t,
                      criterion, stream):
    """The CUDA fill on padded (N, c_inst) counts and scales: (T,) int32."""
    n, c_inst = n_node.shape
    words = np.diff(bit_off)
    bits = torch.empty(int(bit_off[-1]), dtype=torch.int32,
                       device=n_node.device)
    if n and len(bits):
        _build.check(lib.grm_cart_exact_bitmap(
            CRITERIA.index(criterion), n_node.data_ptr(), scale.data_ptr(),
            thresh.data_ptr(), bit_off_t.data_ptr(), n, c_inst,
            int(words.max()), bits.data_ptr(), stream), "pass_bitmap")
    return bits


def pass_bitmap(n_node, scale, thresh, criterion):
    """Per node, the bitmap of the keys of its count lattice whose split
    passes: neither child empty and float32 score (the frontier sweep's,
    ``csrc/cart_score.cuh``) at most ``thresh[i]``. ``n_node`` (N, C) int32
    with every lattice at most ``S_MAX``, ``scale`` (N, C) float32, ``thresh``
    (N,) float32. Returns (bits (T,) int32, off (N + 1,) int64): node i's
    words are ``bits[off[i]:off[i + 1]]``, ceil(lattice / 32) of them, bit
    ``key % 32`` of word ``key // 32``, 0 past the lattice. :func:`
    cart_exact_tuples` fills these with the same kernel and counts the fill
    in its own launch."""
    sizes = _check_bitmap_inputs(n_node, scale, thresh, criterion)
    if n_node.device.type != "cuda":
        return pass_bitmap_plain(n_node, scale, thresh, criterion)
    n, c = n_node.shape
    c_inst = min(x for x in _CLASS_COUNTS if x >= c)
    pad = (0, c_inst - c)
    dev = n_node.device
    bit_off = bitmap_offsets(sizes)
    bit_off_t = torch.from_numpy(bit_off.astype(np.int32)).to(dev)
    nn = torch.nn.functional.pad(n_node, pad).contiguous()
    sc = torch.nn.functional.pad(scale, pad).contiguous()
    th = thresh.contiguous()
    lib = _build.library("cart_exact", _SIGNATURES)
    with torch.cuda.device(dev):
        bits = _fill_pass_bitmap(lib, nn, sc, th, bit_off, bit_off_t,
                                 criterion, _stream(n_node))
    return bits, torch.from_numpy(bit_off).to(dev)


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


def _layout_args(lib, mode, sizes, c, w, dev):
    """:func:`exact_layout` of a launch, checked against the kernel's own
    layout, with its bitmap offsets and private-table offsets on ``dev``."""
    lay = exact_layout(mode, sizes, c, w)
    if lib.grm_cart_exact_smem_bytes(_MODE_CODE[mode], w, lay.gpb,
                                     lay.c_inst, lay.bit_words,
                                     lay.priv_entries) != lay.smem:
        raise RuntimeError("cart_exact: the kernel's shared-memory layout is "
                           "not the wrapper's")
    lay.bit_off_t = torch.from_numpy(lay.bit_off.astype(np.int32)).to(dev)
    lay.priv_off_t = (torch.from_numpy(lay.priv_off).to(dev)
                      if lay.priv_entries else None)
    return lay


def _count_launch(name, kind, lay, n, c):
    """One call of wrapper ``name`` (``kind`` as ``exact_frontiers`` names
    it) counted: its launch, its frontier, and, past ``_REG_STEPS`` steps of
    depth, ``cart_exact_deep`` and the reads of the matrix its plan makes
    (``cart_exact_matrix_reads``)."""
    _build.launches[name] += 1
    _build.exact_frontiers.append((kind, n, c))
    if lay.deep:
        _build.launches["cart_exact_deep"] += 1
        _build.launches["cart_exact_matrix_reads"] += lay.reads


def cart_exact_tuples(matrix, class_masks, train_masks, n_node, scale, thresh,
                      criterion, limit, excl=None):
    """The tuple tables of a frontier whose every node's count lattice is at
    most ``S_MAX``: (occ_tab (T,) int64, col_tab (T,) int32, table_off (N,)
    int64), node i's entries from ``table_off[i]`` on, one per key of its
    lattice. ``occ_tab`` holds ``((occ + 1) << 32) | (0xFFFFFFFF - col)`` of
    the largest train occurrence among the key's passing columns and the
    lowest column at it (0: no column passed), ``col_tab`` the key's lowest
    passing column (``NO_COLUMN``: none). One call is two CUDA launches,
    counted as one: the pass bitmaps (:func:`pass_bitmap`), then the sweep,
    which looks each column's key up in them."""
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
    lib = _build.library("cart_exact", _SIGNATURES)
    lay = _layout_args(lib, "tuples", sizes.cpu().numpy(), c, w, dev)
    pad = (0, lay.c_inst - c)
    stream = _stream(matrix)
    # Held in locals until after the launch, so that no copy is freed early.
    nn = torch.nn.functional.pad(n_node, pad).contiguous()
    sc = torch.nn.functional.pad(scale, pad).contiguous()
    th = thresh.contiguous()
    tiles = pack_exact_tiles(class_masks, train_masks, lay.c_inst)
    t_off = table_off.to(torch.int32)
    excl_c = None if excl is None else excl.contiguous()
    with torch.cuda.device(dev):
        bits = _fill_pass_bitmap(lib, nn, sc, th, lay.bit_off, lay.bit_off_t,
                                 criterion, stream)
        _build.check(lib.grm_cart_exact_tuples(
            CRITERIA.index(criterion), matrix.data_ptr(), w, k,
            min(int(limit), k), tiles.data_ptr(), nn.data_ptr(),
            sc.data_ptr(), t_off.data_ptr(), bits.data_ptr(),
            lay.bit_off_t.data_ptr(), lay.bit_words,
            None if lay.priv_off_t is None else lay.priv_off_t.data_ptr(),
            lay.priv_entries, n, lay.c_inst, lay.gpb,
            None if excl_c is None else excl_c.data_ptr(),
            occ_tab.data_ptr(), col_tab.data_ptr(), stream),
            "cart_exact_tuples")
        _count_launch("cart_exact_tuples", "cart_exact_tuples", lay, n, c)
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
    class counts and occurrences. One call is two CUDA launches, counted as
    one: the sweep counts the hits per (column block, node) and keeps them
    as bits, the second launch writes them from those bits."""
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
    lib = _build.library("cart_exact", _SIGNATURES)
    lay = _layout_args(lib, mode, sizes.cpu().numpy(), c, w, dev)
    pad = (0, lay.c_inst - c)
    stream = _stream(matrix)
    bits = None
    if mode == "equiv":
        # The winning-key bitmaps cut to their lattices, node after node.
        words = torch.from_numpy(np.diff(lay.bit_off)).to(dev)
        bits = bitmap[torch.arange(BITMAP_WORDS, device=dev)[None, :]
                      < words[:, None]].contiguous()
    args = [pack_exact_tiles(class_masks, train_masks, lay.c_inst),
            torch.nn.functional.pad(n_node, pad).contiguous(),
            torch.nn.functional.pad(scale, pad).contiguous(),
            None if thresh is None else thresh.contiguous(),
            None if occmax is None else occmax.contiguous(), bits,
            lay.bit_off_t]
    ptrs = [None if t is None else t.data_ptr() for t in args]
    excl_c = None if excl is None else excl.contiguous()
    masks = class_masks.contiguous()
    train = train_masks.contiguous()
    nb = -(-k // BLOCK_K)
    counts = torch.empty((n, nb), dtype=torch.int64, device=dev)
    hits = torch.empty(n * nb * HIT_WORDS, dtype=torch.int32, device=dev)

    with torch.cuda.device(dev):
        _build.check(lib.grm_cart_exact_select(
            _MODE_CODE[mode], CRITERIA.index(criterion), matrix.data_ptr(),
            w, k, min(int(limit), k), *ptrs, lay.bit_words, n, lay.c_inst,
            lay.gpb, None if excl_c is None else excl_c.data_ptr(),
            counts.data_ptr(), hits.data_ptr(), stream), "cart_exact_select")
        # Node-major, ascending: each (node, block)'s offset is an
        # exclusive scan along the node's row.
        ends = counts.cumsum(1)
        starts = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        starts[1:] = ends[:, -1].cumsum(0)
        offsets = (starts[:-1, None] + ends - counts).contiguous()
        total = int(starts[-1])
        out_col = torch.empty(total, dtype=torch.int32, device=dev)
        out_left = out_occ = None
        if mode == "gather":
            out_left = torch.empty((c, total), dtype=torch.int32, device=dev)
            out_occ = torch.empty(total, dtype=torch.int32, device=dev)
        if total:
            _build.check(lib.grm_cart_exact_write(
                int(mode == "gather"), matrix.data_ptr(), w, k,
                hits.data_ptr(), counts.data_ptr(), offsets.data_ptr(), n, c,
                masks.data_ptr(), train.data_ptr(), out_col.data_ptr(),
                None if out_left is None else out_left.data_ptr(),
                None if out_occ is None else out_occ.data_ptr(), total,
                stream), "cart_exact_select")
        # One call of the wrapper: two CUDA launches, counted as one.
        _count_launch("cart_exact_select", "cart_exact_select:" + mode, lay,
                      n, c)
    return starts, out_col, out_left, out_occ
