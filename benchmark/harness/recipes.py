"""The benchmark's data, frozen: copies of the recipes ``chip_smoke.py``
uses, importing nothing of the program.

- :func:`kmer_sequence_block` is ``chip_smoke._kmer_sequence_block``
  (``chip_smoke.py:494``), the same strings, built from a look-up table of
  eight bases instead of one pass a base.
- :func:`synthetic_arrays` is ``chip_smoke.synthetic_arrays``
  (``chip_smoke.py:505``) with its ``pack_binary_bytes_to_ints`` rewritten
  in NumPy (:func:`pack_u64`). Given no ``words`` it draws the noise with
  ``RandomState.bytes`` as the original does and gives its arrays bit for
  bit; the benchmark passes noise words made on the card from a seeded
  ``torch.Generator`` (:func:`card_noise`), and the markers are then
  planted from ``RandomState(seed)``.
- :func:`ingest_genomes` is ``chip_smoke.ingest_genomes``
  (``chip_smoke.py:642``), unchanged.
"""

from __future__ import annotations

import mmap

import numpy as np

_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)
# Eight bases a word: the bytes of entry v spell the base-4 digits of v,
# most significant first.
_EIGHT = np.ascontiguousarray(
    _LUT[(np.arange(1 << 16)[:, None] >> (2 * (7 - np.arange(8)))) & 3]
).view(np.uint64)[:, 0]


def kmer_sequence_block(start, count, k):
    """(count,) distinct fixed-width k-mers: k-mer i spells i in base 4
    (A, C, G, T), most significant base first."""
    i = np.arange(start, start + count, dtype=np.uint64)
    n_chunks = -(-k // 8)
    wide = np.empty((count, n_chunks), np.uint64)
    for c in range(n_chunks):
        shift = 16 * c
        v = (i >> np.uint64(shift)) if shift < 64 else np.zeros_like(i)
        wide[:, n_chunks - 1 - c] = _EIGHT[(v & np.uint64(0xFFFF))
                                           .astype(np.int64)]
    out = np.ascontiguousarray(wide.view(np.uint8)[:, 8 * n_chunks - k:])
    return out.view("S%d" % k)[:, 0]


def pack_u64(col01):
    """A (n,) 0/1 vector packed MSB-first into (ceil(n / 64),) uint64: row i
    at bit 63 - i % 64 of word i // 64."""
    col01 = np.asarray(col01, dtype=np.uint8)
    padded = np.zeros(-(-len(col01) // 64) * 64, np.uint8)
    padded[:len(col01)] = col01
    return np.packbits(padded).view(">u8").astype(np.uint64)


def huge_empty(shape, dtype):
    """An uninitialised host array in anonymous memory advised to be
    backed by huge pages (``MADV_HUGEPAGE``, where the kernel offers it),
    so that reading it runs at one speed from the start instead of
    speeding up as the kernel collapses its pages in the background."""
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if nbytes == 0:
        return np.empty(shape, dtype)
    buf = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    if hasattr(mmap, "MADV_HUGEPAGE"):
        try:
            buf.madvise(mmap.MADV_HUGEPAGE)
        except OSError:
            pass
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def card_noise(n_genomes, n_kmers, seed, device):
    """The noise words of :func:`synthetic_arrays`, made on ``device`` from
    a ``torch.Generator`` seeded with ``seed``: (ceil(n_genomes / 64),
    n_kmers) uint64 on the host (:func:`huge_empty`), every bit 1 with
    probability 3/4 (a byte OR its shift), the padding bits past the last
    genome clear."""
    import torch

    w64 = -(-n_genomes // 64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    valid = torch.from_numpy(pack_u64(np.ones(n_genomes, np.uint8))
                             .view(np.int64).copy()).to(device)
    host = huge_empty((w64, n_kmers), np.uint64)
    out = torch.from_numpy(host.view(np.int64))
    for r in range(w64):
        row = torch.randint(0, 256, (n_kmers * 8,), dtype=torch.uint8,
                            generator=gen, device=device).view(torch.int64)
        row |= row << 1
        row &= valid[r]
        out[r].copy_(row)
    return host


def synthetic_arrays(n_genomes, n_kmers, seed, n_classes=2, words=None):
    """The artifact recipe of ``chip_smoke.synthetic_arrays``: ~75% dense
    noise, a planted conjunction of three markers (marker i absent on third
    i of the negatives, lightly flip-noised) and 20 noisier decoys. With
    more than two classes the genomes fall into equal classes and the
    first decoys become one flip-noised marker per class. ``words``: the
    noise, (ceil(n_genomes / 64), n_kmers) uint64 (written into), else
    drawn as the original draws it."""
    rng = np.random.RandomState(seed)
    # sorted by label, like the reference
    labels = (np.arange(n_genomes) * n_classes // n_genomes).astype(np.uint8)
    w64 = -(-n_genomes // 64)
    if words is None:
        matrix = np.frombuffer(rng.bytes(w64 * n_kmers * 8),
                               dtype=np.uint64).reshape(w64, n_kmers).copy()
        matrix |= matrix << np.uint64(1)
        matrix &= pack_u64(np.ones(n_genomes, np.uint8))[:, None]
    else:
        matrix = words
        if matrix.shape != (w64, n_kmers) or matrix.dtype != np.uint64:
            raise ValueError("words must be (%d, %d) uint64" % (w64, n_kmers))
    neg = np.where(labels == 0)[0]
    marker_cols = rng.choice(n_kmers, 23, replace=False)
    thirds = np.array_split(rng.permutation(neg), 3)
    for i in range(3):
        col = np.ones(n_genomes, np.uint8)
        col[thirds[i]] = 0
        flips = rng.choice(n_genomes, max(1, n_genomes * (1 + i) // 200),
                           replace=False)
        col[flips] = 1 - col[flips]
        matrix[:, marker_cols[i]] = pack_u64(col)
    for i, c in enumerate(marker_cols[3:]):
        col = (labels > 0).astype(np.uint8)
        flips = rng.choice(n_genomes, max(2, n_genomes * (30 + 2 * (i % 6))
                                          // 100), replace=False)
        col[flips] = 1 - col[flips]
        matrix[:, c] = pack_u64(col)
    if n_classes > 2:
        for cl, c in enumerate(marker_cols[3:3 + n_classes]):
            col = (labels == cl).astype(np.uint8)
            flips = rng.choice(n_genomes, n_genomes // 20, replace=False)
            col[flips] = 1 - col[flips]
            matrix[:, c] = pack_u64(col)
    arrays = {
        "genome_identifiers": np.array([("g%05d" % i).encode()
                                        for i in range(n_genomes)]),
        "phenotype": labels,
        "phenotype_tags": np.array([b"%d" % c for c in range(n_classes)]),
        "kmer_sequences": kmer_sequence_block(0, n_kmers, 31),
        "kmer_by_matrix_column": np.arange(n_kmers, dtype=np.uint32),
        "kmer_matrix": matrix,
    }
    attrs = {"uuid": "smoke-%dx%d-seed%d" % (n_genomes, n_kmers, seed),
             "genomic_data": "synthetic://median",
             "phenotype_description": "synthetic resistance",
             "phenotype_metadata_source": "synthetic://labels"}
    return arrays, attrs


def ingest_genomes(n_genomes, length, n_snps, pool, seed, k=31):
    """Genomes for the ingest path: each a copy of one random backbone of
    ``length`` bases (from ``seed``) carrying ``n_snps`` SNPs drawn from a
    shared pool of ``pool`` sites, plus a planted 3-marker conjunction as
    synthetic_arrays plants it (genomes sorted by label; marker i absent on
    third i of the negatives, lightly flip-noised). A marker is a SNP at a
    site no pool site comes within k of, so that its k windows are the same
    in every genome that carries it.

    Returns (int8 code arrays, labels, {canonical k-mer string of a
    marker's window: that marker's index})."""
    rng = np.random.RandomState(seed)
    backbone = rng.randint(0, 4, length).astype(np.int8)
    sites = rng.choice(np.arange(k, length - k), pool, replace=False)
    alt = ((backbone[sites] + rng.randint(1, 4, pool)) % 4).astype(np.int8)
    near = np.zeros(length + 1, np.int32)  # pool sites within k of a base
    np.add.at(near, np.maximum(sites - k, 0), 1)
    np.add.at(near, np.minimum(sites + k + 1, length), -1)
    near = np.cumsum(near)[:length] > 0
    markers = []
    for s in rng.permutation(np.flatnonzero(~near[k:length - k]) + k):
        if all(abs(s - m) > k for m in markers):
            markers.append(int(s))
            if len(markers) == 3:
                break
    else:
        raise ValueError("the SNP pool leaves no room for 3 markers")
    markers = np.array(markers)
    malt = ((backbone[markers] + rng.randint(1, 4, 3)) % 4).astype(np.int8)
    labels = (np.arange(n_genomes) * 2 // n_genomes).astype(np.uint8)
    carries = np.ones((3, n_genomes), bool)
    thirds = np.array_split(rng.permutation(np.where(labels == 0)[0]), 3)
    for i in range(3):
        carries[i, thirds[i]] = False
        flips = rng.choice(n_genomes, max(1, n_genomes * (1 + i) // 200),
                           replace=False)
        carries[i, flips] = ~carries[i, flips]
    codes_list = []
    for g in range(n_genomes):
        c = backbone.copy()
        chosen = rng.choice(pool, n_snps, replace=False)
        c[sites[chosen]] = alt[chosen]
        c[markers[carries[:, g]]] = malt[carries[:, g]]
        codes_list.append(c)
    comp = str.maketrans("ACGT", "TGCA")
    marker_kmers = {}
    for i, (s, a) in enumerate(zip(markers, malt)):
        seq = backbone[s - k + 1:s + k].copy()
        seq[k - 1] = a
        text = "".join("ACGT"[b] for b in seq)
        for t in range(k):
            w = text[t:t + k]
            marker_kmers[min(w, w.translate(comp)[::-1])] = i
    return codes_list, labels, marker_kmers
