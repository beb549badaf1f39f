"""Union k-mer space + packed presence matrix: the dsk2kover / Ray Surveyor
role.

Port of ``grm_tpu/kmer/matrix.py``, under the same names. The reference
merges per-genome DSK count files into the genome x k-mer presence matrix
with the C++ ``dsk2kover`` binary (``tools/kmer_pack.py:23-36``) or builds
it with MPI Ray Surveyor (``src/app.py:1280-1354``). Here the merge runs on
the host: the port's native loser-tree merge, partitioned over the key
space and run on several threads (``engine="native"``, the default), or
its plain numpy version (``engine="numpy"``). The matrix is emitted in the
reference's packed layout: rows = uint64 words of 64 genomes (MSB-first),
columns = k-mers in sorted canonical order (``create.py:38-41, 224-230``).

The singleton filter (``filter_singleton``) drops k-mers present in
exactly one genome (``bin/kover/kover:144-147``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.kmer import decode_kmers, decode_kmers_bytes, n_words_for_k
from ..utils import unpack_binary_bytes_from_ints

__all__ = [
    "KmerMatrix",
    "build_presence_matrix",
    "matrix_to_tsv",
    "counts_to_tsv",
    "parse_survey_conf",
    "read_matrix_tsv",
    "kmer_rows_sort_key",
]

ENGINES = ("auto", "native", "numpy")


def kmer_rows_sort_key(kmers):
    """A lexicographically-sortable 1-column key view of (n, nw) uint32 rows.

    Words are big-endian significant (word 0 most significant), so a memcmp
    over big-endian bytes equals numeric/DNA lexicographic order. For nw<=2
    a uint64 key is returned; otherwise a void (memcmp) view.
    """
    kmers = np.ascontiguousarray(kmers, dtype=np.uint32)
    nw = kmers.shape[1]
    if nw == 1:
        return kmers[:, 0].copy()
    if nw == 2:
        return (kmers[:, 0].astype(np.uint64) << np.uint64(32)) | kmers[:, 1].astype(
            np.uint64
        )
    be = np.ascontiguousarray(kmers.astype(">u4"))
    return be.view("V%d" % (4 * nw)).reshape(-1)


@dataclass
class KmerMatrix:
    """Packed presence matrix over the union k-mer space.

    ``kmers``: (K, nw) uint32 sorted canonical k-mers (the column order).
    ``matrix``: (ceil(G/64), K) uint64, genome g = bit 63-(g%64) of row g//64.
    ``genome_ids``: list of genome identifiers (row order).
    """

    k: int
    kmers: np.ndarray
    matrix: np.ndarray
    genome_ids: list

    @property
    def n_genomes(self):
        return len(self.genome_ids)

    @property
    def n_kmers(self):
        return self.kmers.shape[0]

    def kmer_strings(self):
        return decode_kmers(self.kmers, self.k)

    def dense(self):
        return unpack_binary_bytes_from_ints(self.matrix)[: self.n_genomes]


def build_presence_matrix(genome_kmers, filter_singleton=False, k=None,
                          engine="auto", n_threads=None):
    """Merge per-genome sorted k-mer sets into the packed presence matrix.

    Parameters
    ----------
    genome_kmers : sequence of :class:`~grm_tpu_torch.kmer.counter.GenomeKmers`
    filter_singleton : drop k-mers present in exactly one genome
        (dsk2kover ``-filter singleton``, ``bin/kover/kover:144-147``).
    engine : ``"native"`` (and ``"auto"``) merges with the host library,
        whose failed build raises; ``"numpy"`` is the plain version.
    n_threads : threads of the native merge (default: every core).

    Returns a :class:`KmerMatrix`. Column order is global sorted canonical
    order.
    """
    if engine not in ENGINES:
        raise ValueError("engine must be one of %s, not %r" % (ENGINES,
                                                              engine))
    if not genome_kmers:
        raise ValueError("At least one genome is required.")
    if k is None:
        k = genome_kmers[0].k
    if any(g.k != k for g in genome_kmers):
        raise ValueError("All genomes must be counted with the same k.")
    nw = n_words_for_k(k)
    n_genomes = len(genome_kmers)

    if engine != "numpy":
        # dsk2kover role: one fused loser-tree pass per key-space partition
        # emits union, counts and the packed presence matrix, partitions
        # running thread-parallel across cores.
        from ..native.bindings import merge_union_bits_parallel

        union_kmers, genome_counts, matrix = merge_union_bits_parallel(
            [g.kmers for g in genome_kmers], nw, n_threads=n_threads
        )
    else:
        sizes = [g.n_kmers for g in genome_kmers]
        all_rows = np.concatenate(
            [g.kmers for g in genome_kmers]
            + [np.zeros((0, nw), np.uint32)]  # keep dtype/shape for empty input
        )
        keys = kmer_rows_sort_key(all_rows)
        union_keys, inverse = np.unique(keys, return_inverse=True)

        # Map union keys back to (K, nw) rows: take the first occurrence.
        first_occurrence = np.zeros(union_keys.shape[0], dtype=np.int64)
        first_occurrence[inverse] = np.arange(all_rows.shape[0])
        union_kmers = all_rows[first_occurrence]
        n_kmers = union_keys.shape[0]
        genome_counts = np.zeros(n_kmers, dtype=np.int64)
        matrix = np.zeros((-(-n_genomes // 64), n_kmers), dtype=np.uint64)
        offset = 0
        for g_idx in range(n_genomes):
            cols = inverse[offset: offset + sizes[g_idx]]
            offset += sizes[g_idx]
            genome_counts[cols] += 1
            bit = np.uint64(1) << np.uint64(63 - (g_idx % 64))
            matrix[g_idx // 64, cols] |= bit

    if filter_singleton:
        keep = genome_counts != 1
        union_kmers = union_kmers[keep]
        matrix = matrix[:, keep]

    return KmerMatrix(
        k=k,
        kmers=np.ascontiguousarray(union_kmers),
        matrix=matrix,
        genome_ids=[g.genome_id for g in genome_kmers],
    )


def matrix_to_tsv(km, path):
    """Write the reference-compatible presence TSV.

    Format consumed by ``kover dataset create from-tsv`` (create.py:121-137,
    241-269): header ``kmers\\t<id1>\\t<id2>...``, one row per k-mer with
    binary presence values, the artifact Ray Surveyor's
    ``-write-kmer-matrix`` produces for the reference pipeline.
    """
    dense = km.dense()  # (G, K)
    strings = km.kmer_strings()
    with open(path, "w") as f:
        f.write("kmers\t" + "\t".join(str(g) for g in km.genome_ids) + "\n")
        for j, s in enumerate(strings):
            f.write(s + "\t" + "\t".join("1" if v else "0" for v in dense[:, j]) + "\n")


def counts_to_tsv(genome, path):
    """Write one genome's k-mer counts as ``kmer\\tcount`` lines (DSK
    parity), assembled as vectorized bytes."""
    seqs = decode_kmers_bytes(genome.kmers, genome.k)
    counts = (
        genome.counts
        if genome.counts is not None
        else np.ones(genome.n_kmers, dtype=np.int64)
    )
    count_strs = np.char.mod(b"%d", counts.astype(np.int64))
    lines = np.char.add(np.char.add(seqs, b"\t"), count_strs)
    with open(path, "wb") as f:
        if len(lines):
            f.write(b"\n".join(lines))
            f.write(b"\n")


def parse_survey_conf(path):
    """Parse a Ray Surveyor ``survey.conf`` (reference grammar written at
    ``src/app.py:3812-3835``): ``-k K``, ``-run-surveyor``,
    ``-output <path>``, ``-write-kmer-matrix``, and one
    ``-read-sample-assembly <name> <fasta>`` per genome.

    Returns (k, [(name, fasta_path), ...], output_path_or_None).
    """
    k = None
    pairs = []
    output = None
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "-k" and len(parts) >= 2:
                try:
                    k = int(parts[1])
                except ValueError:
                    raise ValueError(
                        "survey.conf has a non-integer -k value: %r" % parts[1]
                    )
            elif parts[0] == "-output" and len(parts) >= 2:
                # maxsplit keeps paths containing spaces intact.
                output = line.split(None, 1)[1].strip()
            elif parts[0] == "-read-sample-assembly" and len(parts) >= 3:
                # The name has no spaces; the rest of the line is the path,
                # which may.
                _, name, fasta = line.split(None, 2)
                pairs.append((name, fasta.strip()))
            # -run-surveyor / -write-kmer-matrix are implied by this tool.
    if k is None:
        raise ValueError("survey.conf is missing the -k <kmer size> line")
    if not pairs:
        raise ValueError("survey.conf lists no -read-sample-assembly entries")
    return k, pairs, output


def read_matrix_tsv(path):
    """Read a presence TSV back: (genome_ids, kmer_strings, dense (G, K))."""
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        genome_ids = header[1:]
        kmer_strings = []
        rows = []
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if not parts or parts == [""]:
                continue
            kmer_strings.append(parts[0])
            rows.append([1 if v != "0" else 0 for v in parts[1:]])
    dense = np.array(rows, dtype=np.uint8).T if rows else np.zeros(
        (len(genome_ids), 0), np.uint8
    )
    return genome_ids, kmer_strings, dense
