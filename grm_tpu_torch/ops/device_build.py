"""The device ingest's column steps: from sorted windows to the packed
presence matrix, the union merge of batches and the singleton filter.

The CUDA kernels are ``csrc/device_build.cu``; each wrapper launches one
for a CUDA tensor and runs its plain PyTorch version for a CPU one, and
one call counts one launch in ``_build.launches``. Each kernel's scan is a
look-back across tiles inside the kernel, so no wrapper makes a flags
tensor or a ``torch.cumsum``:

- :func:`build_columns` (``build_columns``) replaces ``_build`` after its
  sort (``grm_tpu/parallel/device_build.py:92-140``);
- :func:`merge_columns` (``merge_columns``) replaces ``_merge_ranks``
  (:158) and every batch's ``_scatter_batch_columns`` (:207): from the
  merge sort's rows straight to the final matrix, with no ``dest``. Its
  plain version is :func:`merge_ranks_plain` followed by
  :func:`scatter_batch_columns_plain` per batch;
- :func:`compact_columns` (``compact_columns``) replaces
  ``_compact_singletons`` (:222) and ``_build``'s filter (:142), each
  column's genome count included.

Inputs come from :func:`~.kmer.sort_keys`: the sorted keys (n_pairs, n)
int64, the permutation (n,) int64 (each sorted row's input position) and
the sorted validity (n,) bool, or None where the keys mark it
(``KEY_INVALID``). Columns at or past ``k_budget`` are dropped, as XLA's
out-of-range scatters drop them; the callers raise. A count of k-mers is
returned as a (1,) int32 tensor on the device, so that no call waits for
the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .kmer import run_flags, unpack_keys
from .popcount import popcount_colsum_plain

__all__ = [
    "TRASH",
    "build_columns",
    "build_columns_plain",
    "compact_columns",
    "compact_columns_plain",
    "merge_columns",
    "merge_columns_plain",
    "merge_ranks_plain",
    "scatter_batch_columns_plain",
]

TRASH = 2**31 - 1  # the merged column of an invalid row
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "grm_build_columns_tiles": ([_I, _L], _L),
    "grm_build_columns": ([_P, _I, _L, _P, _P, ctypes.c_uint, _I, _I, _L, _I,
                           _P, _P, _P, _P, _P], _I),
    "grm_merge_columns_tiles": ([_I, _L], _L),
    "grm_merge_columns": ([_P, _I, _L, _P, _P, _P, _I, _L, _I, _P, _P, _P, _P,
                           _P], _I),
    "grm_compact_columns_tiles": ([_L], _L),
    "grm_compact_columns": ([_P, _P, _I, _L, _I, _P, _P, _P, _P, _P, _P], _I),
}
MAX_MERGE_BATCHES = 1024  # csrc/device_build.cu kMaxMergeBatches


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_sorted(keys, perm, valid):
    if keys.dtype != torch.int64 or keys.dim() != 2 \
            or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous (n_pairs, n) int64 tensor")
    n = keys.shape[1]
    if perm.dtype != torch.int64 or perm.shape != (n,):
        raise ValueError("perm must be (n,) int64")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != (n,)):
        raise ValueError("valid must be (n,) bool or None")
    if n >= 2**31:
        raise ValueError("at most 2**31 - 1 rows a call")
    for t in (perm, valid):
        if t is not None and t.device != keys.device:
            raise ValueError("keys, perm and valid must be on one device")


def _divisor_magic(d):
    """(magic, shift) with ``p // d == (p * magic) >> shift`` for every
    ``0 <= p < 2**31`` and ``d >= 1``, ``magic < 2**32``: with ``l =
    ceil(log2 d)`` and ``shift = 31 + l``, ``magic = ceil(2**shift / d)``
    exceeds ``2**shift / d`` by less than ``2**l / d``, so ``p * magic /
    2**shift`` exceeds ``p / d`` by less than ``1 / d``."""
    if d >= 2**31:
        return 0, 0  # every p is below d
    shift = 31 + (d - 1).bit_length()
    return -(-(1 << shift) // d), shift


def _union_plain(keys, first, col, nw, k_budget):
    union = torch.zeros((k_budget, nw), dtype=torch.int32, device=keys.device)
    sel = first & (col < k_budget)
    union[col[sel]] = unpack_keys(keys[:, sel], nw).T
    return union


def _count(scan):
    """The last entry of an inclusive scan as a (1,) int32 tensor."""
    if scan.numel() == 0:
        return torch.zeros(1, dtype=torch.int32, device=scan.device)
    return scan[-1:].to(torch.int32).clone()


def build_columns_plain(keys, perm, valid, nw, n_cols, k_budget):
    """Plain PyTorch version of :func:`build_columns`."""
    _check_sorted(keys, perm, valid)
    n = keys.shape[1]
    n_words = -(-(n // n_cols) // 32) if n else 0
    valid, new = run_flags(keys, valid)
    first = new & valid
    scan = torch.cumsum(first.to(torch.int64), 0)
    col = scan - 1
    gid = perm // n_cols
    same = torch.zeros(n, dtype=torch.bool, device=keys.device)
    same[1:] = gid[1:] == gid[:-1]
    keep = valid & ~(~new & same) & (col < k_budget)
    flat = torch.zeros(n_words * k_budget, dtype=torch.int64,
                       device=keys.device)
    # The genomes of a column are distinct after the duplicate mask, so
    # their bits are disjoint and a sum is their OR.
    flat.index_add_(0, ((gid >> 5) * k_budget + col)[keep],
                    (torch.ones_like(gid) << (31 - (gid & 31)))[keep])
    matrix = flat.to(torch.int32).view(n_words, k_budget)
    return matrix, _union_plain(keys, first, col, nw, k_budget), _count(scan)


def build_columns(keys, perm, valid, nw, n_cols, k_budget):
    """The packed matrix of one genome batch from its sorted windows.

    Row ``i`` of the sort is window ``perm[i] % n_cols`` of genome
    ``perm[i] // n_cols``. Returns (matrix (W, k_budget) int32 with genome
    ``g`` at bit ``31 - g % 32`` of word row ``g // 32``, union words
    (k_budget, nw) int32 of each column's k-mer, zero past the last, the
    number of distinct k-mers (1,) int32).

    The rows come from :func:`~.kmer.sort_keys`: the valid rows first, the
    rows of one k-mer in input order. The kernel relies on that order (the
    rows of one matrix word are consecutive); the plain version does not.
    """
    _check_sorted(keys, perm, valid)
    if keys.device.type != "cuda":
        return build_columns_plain(keys, perm, valid, nw, n_cols, k_budget)
    lib = _build.library("device_build", _SIGNATURES)
    n_pairs, n = keys.shape
    n_words = -(-(n // n_cols) // 32) if n else 0
    dev = keys.device
    matrix = torch.zeros((n_words, k_budget), dtype=torch.int32, device=dev)
    union = torch.zeros((k_budget, nw), dtype=torch.int32, device=dev)
    if n == 0:
        return matrix, union, torch.zeros(1, dtype=torch.int32, device=dev)
    vp = None if valid is None else valid.data_ptr()
    magic, shift = _divisor_magic(n_cols)
    # The tile counter, then one look-back status a tile.
    scratch = torch.zeros(1 + lib.grm_build_columns_tiles(n_pairs, n),
                          dtype=torch.int64, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.check(lib.grm_build_columns(
            keys.data_ptr(), n_pairs, n, vp, perm.data_ptr(), magic, shift,
            n_words, k_budget, nw, matrix.data_ptr(), union.data_ptr(),
            scratch.data_ptr(), count.data_ptr(), _stream(keys)),
            "build_columns")
        _build.launches["build_columns"] += 1
    return matrix, union, count


def merge_ranks_plain(keys, perm, valid, nw, k_budget):
    """The merged columns of the batches' union rows from their merge
    sort: (dest (n,) int32 in input order, the row's column in the merged
    union or ``TRASH`` for an invalid row; merged union words (k_budget,
    nw) int32; the merged k-mer count (1,) int32)."""
    _check_sorted(keys, perm, valid)
    valid, new = run_flags(keys, valid)
    first = new & valid
    scan = torch.cumsum(first.to(torch.int64), 0)
    col = scan - 1
    dest = torch.empty(keys.shape[1], dtype=torch.int32, device=keys.device)
    dest[perm] = torch.where(valid, col, TRASH).to(torch.int32)
    return dest, _union_plain(keys, first, col, nw, k_budget), _count(scan)


def _check_scatter(final, batch, dest, w_off):
    for t in (final, batch, dest):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("final, batch and dest must be contiguous int32")
    if batch.dim() != 2 or dest.shape != (batch.shape[1],) \
            or not 0 <= w_off <= final.shape[0] - batch.shape[0]:
        raise ValueError("batch (wb, bucket), dest (bucket,) and word rows "
                         "[w_off, w_off + wb) of final expected")
    if batch.device != final.device or dest.device != final.device:
        raise ValueError("final, batch and dest must be on one device")


def scatter_batch_columns_plain(final, batch, dest, w_off):
    """Place a batch's word rows at their merged columns, in place:
    ``final[w_off + w, dest[j]] = batch[w, j]`` for every ``dest[j]`` below
    ``final``'s width. The batches own disjoint word rows, so no OR."""
    _check_scatter(final, batch, dest, w_off)
    ok = dest < min(final.shape[1], TRASH)
    final[w_off:w_off + batch.shape[0], dest[ok].long()] = batch[:, ok]
    return final


def _check_batches(keys, batches, w_total):
    if not batches or len(batches) > MAX_MERGE_BATCHES:
        raise ValueError("1 to %d batches a merge" % MAX_MERGE_BATCHES)
    for matrix, w_off in batches:
        if matrix.dtype != torch.int32 or matrix.dim() != 2 \
                or not matrix.is_contiguous():
            raise ValueError("a batch matrix must be a contiguous (wb, "
                             "bucket) int32 tensor")
        if matrix.device != keys.device:
            raise ValueError("the batches must be on the keys' device")
        if not 0 <= w_off <= w_total - matrix.shape[0]:
            raise ValueError("a batch's word rows [w_off, w_off + wb) must "
                             "lie in [0, w_total)")
    if sum(m.shape[1] for m, _ in batches) != keys.shape[1]:
        raise ValueError("the batches' buckets must add up to the merge rows")


def merge_columns_plain(keys, perm, valid, batches, nw, k_budget, w_total):
    """Plain PyTorch version of :func:`merge_columns`:
    :func:`merge_ranks_plain`, then :func:`scatter_batch_columns_plain`
    for each batch."""
    _check_sorted(keys, perm, valid)
    _check_batches(keys, batches, w_total)
    dest, union, count = merge_ranks_plain(keys, perm, valid, nw, k_budget)
    final = torch.zeros((w_total, k_budget), dtype=torch.int32,
                        device=keys.device)
    off = 0
    for matrix, w_off in batches:
        bucket = matrix.shape[1]
        scatter_batch_columns_plain(final, matrix, dest[off:off + bucket],
                                    w_off)
        off += bucket
    return final, union, count


def merge_columns(keys, perm, valid, batches, nw, k_budget, w_total):
    """The union merge of genome batches, from the merge sort's rows to the
    final packed matrix.

    ``keys``, ``perm``, ``valid``: the stable sort of every batch's union
    rows back to back (:func:`~.kmer.merge_keys`); ``batches``: each batch's
    (matrix (wb, bucket) int32, w_off) in that order, its union rows being
    ``bucket`` merge rows and its word rows ``[w_off, w_off + wb)`` of the
    final matrix. Returns (final (w_total, k_budget) int32, with every
    batch's columns at their merged columns; merged union words (k_budget,
    nw) int32, zero past the last; the merged k-mer count (1,) int32).

    The kernel relies on that order (the valid rows first, so that it
    reads no padding past one key a tile); the plain
    version does not.
    """
    _check_sorted(keys, perm, valid)
    _check_batches(keys, batches, w_total)
    if keys.device.type != "cuda":
        return merge_columns_plain(keys, perm, valid, batches, nw, k_budget,
                                   w_total)
    lib = _build.library("device_build", _SIGNATURES)
    n_pairs, n = keys.shape
    dev = keys.device
    final = torch.zeros((w_total, k_budget), dtype=torch.int32, device=dev)
    union = torch.zeros((k_budget, nw), dtype=torch.int32, device=dev)
    if n == 0:
        return final, union, torch.zeros(1, dtype=torch.int32, device=dev)
    # The batch table: address, first row, bucket, wb, w_off a batch.
    rows, row0 = [], 0
    for matrix, w_off in batches:
        rows.append([matrix.data_ptr(), row0, matrix.shape[1],
                     matrix.shape[0], w_off])
        row0 += matrix.shape[1]
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)
    vp = None if valid is None else valid.data_ptr()
    # The tile counter, then one look-back status a tile.
    scratch = torch.zeros(1 + lib.grm_merge_columns_tiles(n_pairs, n),
                          dtype=torch.int64, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.check(lib.grm_merge_columns(
            keys.data_ptr(), n_pairs, n, vp, perm.data_ptr(),
            table.data_ptr(), len(batches), k_budget, nw, final.data_ptr(),
            union.data_ptr(), scratch.data_ptr(), count.data_ptr(),
            _stream(keys)), "merge_columns")
        _build.launches["merge_columns"] += 1
    return final, union, count


def _check_compact(matrix, union, n_kmers):
    if matrix.dtype != torch.int32 or matrix.dim() != 2 \
            or not matrix.is_contiguous():
        raise ValueError("matrix must be a contiguous (W, K) int32 tensor")
    if union.dtype != torch.int32 or union.dim() != 2 \
            or union.shape[0] != matrix.shape[1] or not union.is_contiguous():
        raise ValueError("union must be a contiguous (K, nw) int32 tensor")
    if n_kmers.dtype != torch.int32 or n_kmers.shape != (1,):
        raise ValueError("n_kmers must be a (1,) int32 tensor")
    if union.device != matrix.device or n_kmers.device != matrix.device:
        raise ValueError("matrix, union and n_kmers must be on one device")


def _ones_mask(matrix):
    return torch.full((1, matrix.shape[0]), -1, dtype=torch.int32,
                      device=matrix.device)


def compact_columns_plain(matrix, union, n_kmers):
    """Plain PyTorch version of :func:`compact_columns`."""
    _check_compact(matrix, union, n_kmers)
    counts = popcount_colsum_plain(matrix, _ones_mask(matrix))[0]
    k = matrix.shape[1]
    keep = (torch.arange(k, device=matrix.device) < n_kmers) & (counts != 1)
    m = int(keep.sum())
    out = torch.zeros_like(matrix)
    out[:, :m] = matrix[:, keep]
    union_out = torch.zeros_like(union)
    union_out[:m] = union[keep]
    return out, union_out, torch.tensor([m], dtype=torch.int32,
                                        device=matrix.device)


def compact_columns(matrix, union, n_kmers):
    """Drop the columns present in exactly one genome and the columns at
    or past ``n_kmers`` (1,) int32, and move the rest left in order, matrix
    (W, K) and union (K, nw) alike, with zero tails. Returns (matrix,
    union, the number kept (1,) int32)."""
    _check_compact(matrix, union, n_kmers)
    if matrix.device.type != "cuda":
        return compact_columns_plain(matrix, union, n_kmers)
    lib = _build.library("device_build", _SIGNATURES)
    w, k = matrix.shape
    dev = matrix.device
    out = torch.zeros_like(matrix)
    union_out = torch.zeros_like(union)
    if k == 0:
        return out, union_out, torch.zeros(1, dtype=torch.int32, device=dev)
    scratch = torch.zeros(1 + lib.grm_compact_columns_tiles(k),
                          dtype=torch.int64, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.check(lib.grm_compact_columns(
            matrix.data_ptr(), union.data_ptr(), w, k, union.shape[1],
            n_kmers.data_ptr(), out.data_ptr(), union_out.data_ptr(),
            scratch.data_ptr(), count.data_ptr(), _stream(matrix)),
            "compact_columns")
        _build.launches["compact_columns"] += 1
    return out, union_out, count
