"""Rule lists and the device-backed rule-classification engine (the port's
copy of ``grm_tpu/learning/rules.py``).

``KmerRuleClassifications`` replaces the reference's HDF5-block +
Cython-popcount engine (``learning/common/rules.py:99-267``) with the
device-resident :class:`~grm_tpu_torch.ops.popcount.BitMatrix`:

- ``sum_rows(rows)`` — one masked-popcount sweep on device; returns the
  length-2K presence+absence count vector with the reference's dtype contract;
- ``presence_counts(rows_list)`` — several row sets in a single matrix pass
  (the reference rereads the matrix once per call);
- ``get_columns(columns)`` — a gather of a few columns (model prediction
  paths), with absence-rule inversion.
"""

from __future__ import annotations

import numpy as np

from ..utils import minimum_uint_size

__all__ = ["LazyKmerRuleList", "KmerRuleClassifications"]

from .models import KmerRule

# Process-wide caches for lazy sequence lookups (see
# LazyKmerRuleList._read_blocked): sequences keyed by (artifact, kmer_idx)
# — the HP grid's 16 rule lists resolve the SAME winners, so the cache
# must outlive any one list — and chunk blocks under a byte-budget LRU
# (~31 MB/block at the artifact writer's 1M-entry chunking).
_SEQ_CACHE = {}
_BLOCK_CACHE = {}
_BLOCK_CACHE_BUDGET = 512 << 20
_block_cache_bytes = 0


class LazyKmerRuleList:
    """Virtual list of 2K rules: first half presence, second half absence.

    Mirrors reference rules.py:57-79: ``rules[i]`` materializes a
    :class:`KmerRule` with the k-mer sequence looked up lazily.
    """

    # Whole-chunk reads: a single-element fancy read of a gzip-chunked
    # HDF5 dataset inflates the WHOLE chunk anyway. Reading chunk-aligned
    # blocks once and serving from a small process-wide cache (shared
    # across the HP grid's per-combo rule lists) makes repeat winners free.

    def __init__(self, dataset):
        self._dataset = dataset
        self._n_kmers = dataset.kmer_count
        self.n_rules = self._n_kmers * 2

    def _cache_tag(self):
        return self._dataset.cache_tag()

    def _read_blocked(self, f, name, idx):
        global _block_cache_bytes
        ds = f[name]
        chunks = getattr(ds, "chunks", None)
        chunk = chunks[0] if chunks else ds.shape[0]
        lo = (int(idx) // chunk) * chunk
        key = self._cache_tag() + (name, lo)
        blk = _BLOCK_CACHE.get(key)
        if blk is None:
            blk = ds[lo: lo + chunk]
            _block_cache_bytes += blk.nbytes
            while _BLOCK_CACHE and _block_cache_bytes > _BLOCK_CACHE_BUDGET:
                old = _BLOCK_CACHE.pop(next(iter(_BLOCK_CACHE)))
                _block_cache_bytes -= old.nbytes
            _BLOCK_CACHE[key] = blk
        else:
            # refresh recency (dicts preserve insertion order -> the
            # first key is always the least recently used)
            _BLOCK_CACHE.pop(key)
            _BLOCK_CACHE[key] = blk
        return blk[int(idx) - lo]

    def _sequence(self, kmer_idx):
        key = self._cache_tag() + (int(kmer_idx),)
        seq = _SEQ_CACHE.get(key)
        if seq is None:
            with self._dataset.open() as f:
                kmer_by_col = self._read_blocked(
                    f, "kmer_by_matrix_column", kmer_idx)
                raw = self._read_blocked(f, "kmer_sequences", kmer_by_col)
            seq = raw.decode() if isinstance(raw, bytes) else str(raw)
            _SEQ_CACHE[key] = seq
        return seq

    def __getitem__(self, idx):
        idx = int(idx)
        if idx >= self.n_rules:
            raise ValueError(
                "Index %d is out of range for list of size %d" % (idx, self.n_rules)
            )
        rule_type = "absence" if idx >= self._n_kmers else "presence"
        kmer_idx = idx % self._n_kmers
        return KmerRule(kmer_idx, self._sequence(kmer_idx), rule_type)

    def __len__(self):
        return self.n_rules


class KmerRuleClassifications:
    """Device-backed rule classifications over the packed k-mer matrix."""

    def __init__(self, dataset, n_rows=None):
        self.dataset = dataset
        self.n_rows = int(n_rows if n_rows is not None else dataset.genome_count)
        self.bit_matrix = dataset.bit_matrix()
        self.n_kmers = self.bit_matrix.n_columns

    @property
    def shape(self):
        return self.n_rows, self.n_kmers * 2

    def presence_counts(self, rows_list):
        return self.bit_matrix.presence_counts(rows_list)

    def sum_rows(self, rows):
        """Reference contract (rules.py:201-267): presence then absence counts."""
        rows = np.asarray(rows)
        presence = self.bit_matrix.presence_counts([rows])[0]
        out = np.empty(self.n_kmers * 2,
                       dtype=minimum_uint_size(max(rows.shape[0], 1)))
        out[: self.n_kmers] = presence
        out[self.n_kmers:] = rows.shape[0] - presence
        return out

    def get_columns(self, columns):
        """Unpacked rule columns for all genomes (absence rules inverted).

        Accepts an int or a list/array of rule indices in [0, 2K).
        Mirrors rules.py:135-171.
        """
        columns_is_int = isinstance(columns, (int, np.integer)) or (
            isinstance(columns, np.ndarray) and columns.ndim == 0
        )
        if columns_is_int:
            columns = [int(columns)]
        result = self.dataset.get_matrix_columns(np.asarray(columns, dtype=np.int64))
        if columns_is_int:
            return result.reshape(-1)
        return result
