"""Distributed presence-matrix construction: the Ray Surveyor role at scale
(the port of ``grm_tpu/parallel/build.py``).

Data layout (SURVEY.md section 2.6): genome rows are data-parallel across
processes; each process counts its round-robin share of the genomes on its
card (:func:`grm_tpu_torch.kmer.counter.count_fasta`) and merges them with
the port's union merge (:func:`grm_tpu_torch.kmer.matrix.
build_presence_matrix`, the other processes' genomes as empty sets, so its
presence bits sit at their global rows already). The processes exchange
their sorted partial unions over gloo
(:mod:`grm_tpu_torch.parallel.distributed`) and merge them with the same
merge; each scatters its partial matrix into the union's columns, and the
partial matrices, bit-disjoint by genome, combine with one sum over the
processes of their int64 views (disjoint bits add without a carry, so the
sum is their OR), as do the genome counts of the singleton filter.

With one process this is exactly
:func:`grm_tpu_torch.kmer.matrix.build_presence_matrix`; with several it is
the same union and matrix byte for byte (the distributed-equals-local
contract ``grm_tpu``'s tests assert).
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch
import torch.distributed as dist

from ..kmer.counter import GenomeKmers, count_fasta
from ..kmer.matrix import KmerMatrix, build_presence_matrix, kmer_rows_sort_key
from ..ops.kmer import n_words_for_k
from .distributed import (all_gather_arrays, process_count, process_index,
                          shard_round_robin)

__all__ = ["build_presence_matrix_distributed"]


def _merge_sorted_unions(union_arrays, nw, k):
    """Merge per-process sorted distinct (n, nw) arrays into the global
    union with the port's union merge (each array as one genome)."""
    if len(union_arrays) == 1:
        return np.ascontiguousarray(union_arrays[0])
    parts = [GenomeKmers(str(i), k, np.ascontiguousarray(
        np.asarray(a, np.uint32).reshape(-1, nw)))
        for i, a in enumerate(union_arrays)]
    return build_presence_matrix(parts, k=k).kmers


def _spec_digest(genome_specs, k, filter_singleton):
    """Digest of the build contract that must agree across processes.

    Covers the genome-id order, count, k, and the filter flag, NOT the
    paths (per-host mounts may legitimately differ; each process only reads
    its own round-robin share)."""
    h = hashlib.sha256()
    for gid, _ in genome_specs:
        h.update(str(gid).encode())
        h.update(b"\0")
    h.update(("%d|%d|%d" % (len(genome_specs), k,
                            int(bool(filter_singleton)))).encode())
    return np.frombuffer(h.digest(), dtype=np.uint32).copy()


def _check_spec_agreement(genome_specs, k, filter_singleton):
    """Fail fast, on every process, when the build inputs disagree.

    Without this, a mismatched genome list either hangs the union exchange
    or silently produces a diverged matrix. Every rank raises an error
    naming the disagreeing processes before any heavy work runs.
    """
    if process_count() <= 1:
        return
    digest = _spec_digest(genome_specs, k, filter_singleton)
    digests = all_gather_arrays(digest)
    me = process_index()
    bad = [i for i, d in enumerate(digests)
           if not np.array_equal(d, digests[0])]
    if bad:
        raise ValueError(
            "Distributed build input mismatch: process(es) %s disagree with "
            "process 0 on the (genome ids, k, filter) contract "
            "(this is process %d). Every process must pass the identical "
            "ordered genome list and parameters." % (bad, me)
        )


def _sum_over_processes(array):
    """Element-wise sum of an int64 (or uint64, as its int64 view) numpy
    array over the processes, in place; returns it."""
    if process_count() > 1:
        dist.all_reduce(torch.from_numpy(array.view(np.int64)))
    return array


def build_presence_matrix_distributed(genome_specs, k, filter_singleton=False,
                                      progress_callback=None, device=None,
                                      timings=None):
    """Build the packed presence matrix with genome-data-parallel processes.

    ``genome_specs``: ordered list of (genome_id, fasta_path), identical on
    every process; each process counts its round-robin share on ``device``
    (default ``"cuda"``). ``timings``: a dict that, where given, receives the seconds of
    ``count``, ``local_merge``, ``exchange`` (the union's and the matrix's)
    and ``merge``. Returns a :class:`KmerMatrix` (identical on every
    process).
    """
    if progress_callback is None:
        progress_callback = lambda t, p: None
    timings = {} if timings is None else timings
    _check_spec_agreement(genome_specs, k, filter_singleton)
    nw = n_words_for_k(k)
    n_genomes = len(genome_specs)

    # 1. Local counting of this process's genome share.
    t0 = time.perf_counter()
    my_items = shard_round_robin(list(enumerate(genome_specs)))
    local = {}
    for j, (g_idx, (gid, path)) in enumerate(my_items):
        progress_callback("K-mer counting", float(j) / max(len(my_items), 1))
        local[g_idx] = count_fasta(path, k, genome_id=gid,
                                   device=device).kmers
    progress_callback("K-mer counting", 1.0)
    timings["count"] = time.perf_counter() - t0

    # 2. Local partial union and matrix: every genome of the build, the
    # other processes' empty, so the presence bits sit at global rows.
    t0 = time.perf_counter()
    empty = np.zeros((0, nw), np.uint32)
    part = build_presence_matrix(
        [GenomeKmers(str(gid), k, local.get(i, empty))
         for i, (gid, _) in enumerate(genome_specs)], k=k)
    timings["local_merge"] = time.perf_counter() - t0

    # 3. The global union.
    t0 = time.perf_counter()
    unions = all_gather_arrays(part.kmers)
    timings["exchange"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    union = _merge_sorted_unions(unions, nw, k)
    del unions
    progress_callback("Union", 1.0)

    # 4. The partial matrix in the union's columns (bit-disjoint by genome).
    cols = np.searchsorted(kmer_rows_sort_key(union),
                           kmer_rows_sort_key(part.kmers))
    matrix = np.zeros((-(-n_genomes // 64), union.shape[0]), np.uint64)
    matrix[:, cols] = part.matrix
    genome_counts = np.zeros(union.shape[0], np.int64)
    genome_counts[cols] = np.bitwise_count(part.matrix).sum(
        axis=0, dtype=np.int64)
    del part
    timings["merge"] = time.perf_counter() - t0

    # 5. Combine the partials across processes (disjoint bits: sum == OR).
    t0 = time.perf_counter()
    _sum_over_processes(matrix)
    _sum_over_processes(genome_counts)
    timings["exchange"] += time.perf_counter() - t0
    progress_callback("Matrix", 1.0)

    if filter_singleton:
        keep = genome_counts != 1
        union = union[keep]
        matrix = matrix[:, keep]

    return KmerMatrix(
        k=k,
        kmers=np.ascontiguousarray(union),
        matrix=matrix,
        genome_ids=[gid for gid, _ in genome_specs],
    )
