"""Presence-matrix construction on the device: codes in, a packed matrix
resident on the card out, nothing but counts fetched.

Port of ``grm_tpu/parallel/device_build.py``, under the same names:

1. canonical windows of every genome of a batch
   (:func:`~grm_tpu_torch.ops.kmer.kmer_canon`, one CUDA kernel);
2. one stable sort of the windows' keys
   (:func:`~grm_tpu_torch.ops.kmer.sort_keys`: the radix sort of
   ``csrc/sort.cu`` on the card, ``sort_keys_plain`` on the CPU); the rows
   are laid out genome by genome, so rows of one k-mer stay in genome
   order and duplicate (k-mer, genome) rows are adjacent;
3. :func:`~grm_tpu_torch.ops.device_build.build_columns` gives each
   distinct k-mer its union column and sets the genome bits of the packed
   (W, k_budget) matrix;
4. the singleton filter and its compaction
   (:func:`~grm_tpu_torch.ops.device_build.compact_columns`).

The batched builder sorts one ``genome_batch`` at a time, keeps each
batch's union and packed columns on the card, then merges every batch's
sorted union in one multiway merge (:func:`~grm_tpu_torch.ops.kmer.
merge_keys`) and places each batch's word rows at their merged columns
(:func:`_merge_columns`: ``grm_tpu``'s ``_merge_ranks`` and
``_scatter_batch_columns`` in one kernel).

The column axis is padded to ``k_budget``, the caller's bound on the union
size; a union past it raises. Packed words are int32 bit patterns, genome
``g`` at bit ``31 - g % 32`` of word row ``g // 32``: ``DeviceMatrix.matrix``
is bit for bit ``grm_tpu``'s uint32 matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.device_build import build_columns, compact_columns, merge_columns
from ..ops.kmer import (MAX_SINGLE_KEY_K, merge_keys, n_words_for_k,
                        pair_keys, sort_keys, window_keys)
from ..ops.popcount import BitMatrix
from ..profiling import span, spanned

__all__ = ["build_matrix_device", "build_matrix_device_batched",
           "DeviceMatrix"]

_LENGTH_BUCKET = 1 << 12  # genome rows are padded to a multiple of this


class DeviceMatrix:
    """Device-resident build result: padded matrix + union + true size."""

    def __init__(self, matrix, union_words, n_kmers, k, genome_ids):
        self.matrix = matrix            # (W, k_budget) int32, device
        self.union_words = union_words  # (k_budget, nw) int32, device
        self.n_kmers = int(n_kmers)
        self.k = k
        self.genome_ids = list(genome_ids)

    def bit_matrix(self):
        """The matrix as a :class:`BitMatrix`, on the card, without a copy;
        its padding columns are all zero."""
        return BitMatrix(self.matrix, len(self.genome_ids),
                         n_columns=self.n_kmers)

    def union_kmers_host(self):
        """(n_kmers, nw) uint32 numpy: the union's k-mers, sorted."""
        return self.union_words[:self.n_kmers].cpu().numpy().view(np.uint32)


def _build(codes, k, k_budget, filter_singleton):
    """codes: (G, L) int8 on the device, padded with 4s. Returns (matrix,
    union words, n_kmers (1,) int32), all on the device."""
    keys, valid = window_keys(codes, k)
    keys, perm, valid = sort_keys(keys, valid)
    matrix, union, n_kmers = build_columns(
        keys, perm, valid, n_words_for_k(k), codes.shape[1], k_budget)
    del keys, perm, valid
    if filter_singleton:
        matrix, union, n_kmers = compact_columns(matrix, union, n_kmers)
    return matrix, union, n_kmers


def _merge_columns(batches, k, k_budget, w_total):
    """One union merge over every batch's union rows back to back, and
    each batch's packed columns placed at their merged columns: the port of
    ``grm_tpu/parallel/device_build.py:158`` ``_merge_ranks`` and of every
    batch's ``_scatter_batch_columns`` (:207), in one merge and one kernel.

    ``batches``: (matrix (wb, bucket), union words (bucket, nw), n_kmers
    (1,), word row, bucket) each, the union's valid prefix sorted as
    :func:`_build` leaves it. Returns the final matrix (w_total, k_budget)
    int32, the merged union words (k_budget, nw) and the merged k-mer
    count (1,) int32. Each batch is a sorted segment of one multiway merge
    (:func:`~grm_tpu_torch.ops.kmer.merge_keys`), whatever the number of
    batches; ties keep the concatenation order, as the sort of the
    concatenation would. The batches own disjoint word rows, so no OR.
    """
    dev = batches[0][0].device
    words = torch.cat([b[1] for b in batches])
    valids = torch.cat([torch.arange(b[4], device=dev) < b[2]
                        for b in batches])
    keys = pair_keys(words.T, valids)
    del words, valids
    keys, perm, valid = merge_keys(keys, [(b[4], b[2]) for b in batches])
    return merge_columns(keys, perm, None if k <= MAX_SINGLE_KEY_K else valid,
                         [(b[0], b[3]) for b in batches], n_words_for_k(k),
                         k_budget, w_total)


def _compact_singletons(matrix, union, n_kmers):
    """Drop the columns present in exactly one genome and compact the rest
    left (the reference's ``filter_singleton``), on the merged matrix so
    that occurrences in different batches count."""
    return compact_columns(matrix, union, n_kmers)


def _build_codes(codes_list, k, k_budget, device, filter_singleton=False):
    """Pad + upload one genome batch and run its build; the count stays a
    device tensor (no wait for the card: callers fetch counts together)."""
    g = len(codes_list)
    n = max(max(len(c) for c in codes_list), k)
    n = -(-n // _LENGTH_BUCKET) * _LENGTH_BUCKET
    with span("ingest.pad", genomes=g, bytes=g * n):
        codes = torch.empty((g, n), dtype=torch.int8,
                            pin_memory=device.type == "cuda")
        host = codes.numpy()
        for i, c in enumerate(codes_list):
            host[i, :len(c)] = c
            host[i, len(c):] = 4
    with span("ingest.batch"):  # the upload and the batch's launches
        return _build(codes.to(device, non_blocking=True), k, int(k_budget),
                      bool(filter_singleton))


def _windows(codes_list, k):
    return sum(max(len(c) - k + 1, 0) for c in codes_list)


@spanned("ingest.build")
def build_matrix_device_batched(codes_list, k, genome_ids=None, k_budget=None,
                                genome_batch=32, batch_budget=None,
                                filter_singleton=False, device=None):
    """Artifact-scale device ingest: batched builds + one union merge.

    Each ``genome_batch`` (a multiple of 32, so that a batch's packed rows
    drop into the global word-row grid untouched) is sorted on its own; its
    union and packed columns stay on the card; then one sort merges every
    batch's union. ``k_budget`` bounds the union size (default: the total
    window count); ``batch_budget`` bounds one batch's distinct k-mers
    (default: the batch's window count), rounded up to a power of two from
    1024. Budgets too small raise ``ValueError``, after the one fetch of
    the counts.
    """
    dev = resolve_device(device)
    g = len(codes_list)
    if g == 0:
        raise ValueError("At least one genome is required.")
    if genome_batch % 32 != 0:
        raise ValueError("genome_batch must be a multiple of 32.")
    if genome_ids is None:
        genome_ids = ["g%d" % i for i in range(g)]
    w_total = -(-g // 32)
    if k_budget is None:
        k_budget = _windows(codes_list, k)
    k_budget = int(k_budget)

    # Phase 1: per-batch builds, no fetch: batch N + 1's padding and upload
    # overlap batch N's sort.
    batches = []  # (matrix, union words, n_kmers (1,), word row, bucket)
    for lo in range(0, g, genome_batch):
        sub = codes_list[lo:lo + genome_batch]
        bb = batch_budget if batch_budget is not None else _windows(sub, k)
        bucket = 1 << 10
        while bucket < bb:
            bucket *= 2
        b_matrix, b_union, b_n = _build_codes(sub, k, bucket, dev)
        batches.append((b_matrix, b_union, b_n, lo // 32, bucket))

    # Phase 2: one union merge over the batches' unions, each batch's valid
    # rows from its device count, and each batch's packed columns placed at
    # their merged columns.
    with span("ingest.merge"):
        final, union, n_dev = _merge_columns(batches, k, k_budget, w_total)
    with span("ingest.counts"):  # the one fetch
        counts = torch.cat([n_dev] + [b[2] for b in batches]).cpu().tolist()
    n_kmers = counts[0]
    for (_, _, _, lo32, bucket), b_n in zip(batches, counts[1:]):
        if b_n > bucket:
            raise ValueError(
                "batch at word-row %d overflowed its %d-kmer budget (%d)"
                % (lo32, bucket, b_n))
    if n_kmers > k_budget:
        raise ValueError(
            "k_budget=%d too small: union has %d k-mers" % (k_budget, n_kmers))
    del batches

    if filter_singleton:
        with span("ingest.compact"):
            final, union, n_dev = _compact_singletons(final, union, n_dev)
            n_kmers = int(n_dev.item())
    return DeviceMatrix(final, union, n_kmers, k, genome_ids)


def build_matrix_device(codes_list, k, genome_ids=None, k_budget=None,
                        filter_singleton=False, device=None):
    """Build the packed presence matrix on the device from per-genome codes
    in one sort of every window.

    ``codes_list``: per-genome int8 code arrays (0..3, 4 = invalid or a
    separator). ``k_budget``: the bound on the union size (default: the
    genome count times the longest genome rounded up to 4096, always safe).
    """
    dev = resolve_device(device)
    g = len(codes_list)
    if g == 0:
        raise ValueError("At least one genome is required.")
    if genome_ids is None:
        genome_ids = ["g%d" % i for i in range(g)]
    if k_budget is None:
        n = max(max(len(c) for c in codes_list), k)
        k_budget = g * (-(-n // _LENGTH_BUCKET) * _LENGTH_BUCKET)
    matrix, union_words, n_kmers = _build_codes(
        codes_list, k, int(k_budget), dev, filter_singleton)
    n_kmers = int(n_kmers.item())
    if n_kmers > k_budget:
        raise ValueError(
            "k_budget=%d too small: union has %d k-mers" % (k_budget, n_kmers))
    return DeviceMatrix(matrix, union_words, n_kmers, k, genome_ids)
