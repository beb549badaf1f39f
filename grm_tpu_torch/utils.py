"""Host-side utilities: bit packing, dtype helpers, blacklist parsing.

The port's own copy of the parts of ``grm_tpu/utils.py`` that the learners
and the ingest need. Contracts mirror the reference
(``bin/kover/core/kover/utils.py``):

- MSB-first packing of a binary byte matrix into uint32/uint64 words, rows
  of ``pack_size`` examples per word (utils.py:133-156) and its inverse
  (utils.py:159-187);
- minimum uint dtype selection (utils.py:117-130);
- per-word row masks (learning/common/rules.py:210-222);
- FASTA contig reading, gzipped or not (utils.py:57-75);
- k-mer blacklist parsing (utils.py:189-213).
"""

from __future__ import annotations

import gzip as _gzip

import numpy as np

__all__ = [
    "minimum_uint_size",
    "pack_binary_bytes_to_ints",
    "unpack_binary_bytes_from_ints",
    "parse_kmer_blacklist",
    "build_row_mask",
    "fasta_to_sequences",
]


def minimum_uint_size(max_value):
    """Smallest numpy unsigned integer dtype able to store ``max_value``."""
    if max_value <= np.iinfo(np.uint8).max:
        return np.uint8
    elif max_value <= np.iinfo(np.uint16).max:
        return np.uint16
    elif max_value <= np.iinfo(np.uint32).max:
        return np.uint32
    return np.uint64


def pack_binary_bytes_to_ints(a, pack_size):
    """Pack a binary (n_rows, n_cols) uint8 matrix into words, MSB-first.

    Row ``i`` lands in word ``i // pack_size`` at bit
    ``pack_size - 1 - (i % pack_size)`` (bit 0 = LSB).
    """
    if pack_size == 64:
        dtype = np.uint64
    elif pack_size == 32:
        dtype = np.uint32
    else:
        raise ValueError("Supported pack sizes are 32 and 64.")

    a = np.asarray(a)
    n_rows = a.shape[0]
    n_words = -(-n_rows // pack_size)
    padded = np.zeros((n_words * pack_size,) + a.shape[1:], dtype=dtype)
    padded[:n_rows] = a.astype(dtype)
    padded = padded.reshape((n_words, pack_size) + a.shape[1:])
    shifts = (pack_size - 1 - np.arange(pack_size, dtype=dtype)).astype(dtype)
    shifts = shifts.reshape((1, pack_size) + (1,) * (a.ndim - 1))
    return np.bitwise_or.reduce(padded << shifts, axis=1)


def unpack_binary_bytes_from_ints(a):
    """Unpack MSB-first packed words back to a uint8 0/1 matrix.

    The output has ``n_words * pack_size`` rows (padding rows included), as
    the reference's does.
    """
    a = np.asarray(a)
    if a.dtype == np.uint32:
        pack_size = 32
    elif a.dtype == np.uint64:
        pack_size = 64
    else:
        raise ValueError("Supported dtypes are uint32 and uint64.")

    squeeze = a.ndim == 1
    if squeeze:
        a = a.reshape(-1, 1)
    shifts = (pack_size - 1 - np.arange(pack_size, dtype=a.dtype)).astype(a.dtype)
    bits = (a[:, None, :] >> shifts[None, :, None]) & a.dtype.type(1)
    out = bits.astype(np.uint8).reshape(a.shape[0] * pack_size, a.shape[1])
    if squeeze:
        out = out.reshape(-1)
    return out


def build_row_mask(example_idx, n_examples, mask_n_bits):
    """Per-word bitmask selecting a set of example rows, MSB-first: word
    ``i // mask_n_bits`` gets bit ``mask_n_bits - 1 - (i % mask_n_bits)``
    set for each selected example i."""
    if mask_n_bits not in (8, 16, 32, 64):
        raise ValueError("Unsupported mask size. Use 8, 16, 32 or 64 bits.")
    dtype = np.dtype("u%d" % (mask_n_bits // 8))
    n_words = -(-n_examples // mask_n_bits)
    masks = np.zeros(n_words, dtype=np.uint64)
    idx = np.asarray(example_idx, dtype=np.int64)
    if idx.size:
        word = idx // mask_n_bits
        bit = (mask_n_bits - 1 - (idx % mask_n_bits)).astype(np.uint64)
        np.bitwise_or.at(masks, word, np.uint64(1) << bit)
    return masks.astype(dtype)


def _open_maybe_gzip(path, mode="rt"):
    """``open``, or ``gzip.open`` for a path ending in ``.gz``."""
    if str(path).endswith(".gz"):
        return _gzip.open(path, mode)
    return open(path, mode)


def fasta_to_sequences(path):
    """Upper-cased contig sequences of a (optionally gzipped) FASTA file:
    contigs are concatenated across line breaks and headers discarded."""
    contigs = []
    buffer = None
    with _open_maybe_gzip(path) as f:
        for line in f:
            if line.startswith(">"):
                if buffer is not None:
                    contigs.append(buffer.upper())
                buffer = ""
            elif buffer is None:
                buffer = line.strip()
            else:
                buffer += line.strip()
    if buffer is not None and buffer != "":
        contigs.append(buffer.upper())
    return contigs


def parse_kmer_blacklist(blacklist_path, expected_kmer_len):
    """Parse a k-mer blacklist file (FASTA or one k-mer per line); every
    k-mer must be ACGT-only and of the dataset's k-mer length."""
    fasta_extensions = (".fasta", ".fa", ".fas", ".fna")
    if any(str(blacklist_path).endswith(ext) for ext in fasta_extensions):
        data = fasta_to_sequences(blacklist_path)
    else:
        with open(blacklist_path, "r") as f:
            data = [l.rstrip("\n") for l in f]
        data = [x for x in data if x]

    for kmer in data:
        if set(kmer).difference("ACGTacgt"):
            raise ValueError("%s is not a valid DNA sequence" % kmer)
    if not all(len(kmer) == expected_kmer_len for kmer in data):
        raise ValueError(
            "Extracted k-mers to blacklist do not have all the same length as "
            "the dataset k-mers"
        )
    return data
