"""In-memory end-to-end pipeline: contigs -> matrix -> split -> SCM model,
in one process and with no artifact in between.

Port of ``grm_tpu/pipeline.py``. Two ingests:

- :meth:`InMemoryDataset.from_contigs` (host ingest): each genome's k-mers
  counted on the card (:func:`grm_tpu_torch.kmer.counter.count_fasta`),
  the union merged on the host into a
  :class:`~grm_tpu_torch.kmer.matrix.KmerMatrix`, which the
  :class:`InMemoryDataset` splits on the card
  (``BitMatrix.from_u64``) when it is first asked for a ``BitMatrix``;
- :meth:`InMemoryDataset.from_contigs_device` builds the packed presence
  matrix on the card (:mod:`grm_tpu_torch.parallel.device_build`) and
  returns a :class:`DeviceDataset`, whose matrix never leaves the card:
  only the model's few rule columns and k-mers come back.

:func:`train_scm` fits SCM on either through the argmax engine's
full-train fit (:func:`grm_tpu_torch.parallel.mesh.scm_fit_batch_device`,
one ``popcount_colsum`` launch a greedy step, one a shard over a ``mesh``,
where the matrix is placed column-sharded as ``grm_tpu`` places it).
"""

from __future__ import annotations

from dataclasses import dataclass
from math import ceil

import numpy as np
import torch

from .device import resolve_device
from .kmer.counter import count_fasta
from .kmer.matrix import KmerMatrix, build_presence_matrix
from .learning.metrics import get_binary_metrics
from .learning.models import ConjunctionModel, DisjunctionModel, KmerRule
from .ops.kmer import decode_kmers, encode_contigs
from .ops.popcount import BitMatrix, masks_to_tensor
from .parallel.device_build import (build_matrix_device,
                                    build_matrix_device_batched)
from .parallel.mesh import MeshSharding, check_mesh, scm_fit_batch_device
from .parallel.scm_device import build_packed_mask
from .profiling import span, spanned
from .utils import fasta_to_sequences, unpack_binary_bytes_from_ints

__all__ = ["InMemoryDataset", "DeviceDataset", "train_scm", "PipelineResult"]


class InMemoryDataset:
    """A :class:`KmerMatrix` + labels exposing the surface the learners
    need. ``device`` (default ``"cuda"``) holds the bit matrix; a
    ``sharding`` (:class:`~grm_tpu_torch.parallel.mesh.MeshSharding`)
    places it on a mesh instead."""

    def __init__(self, km: KmerMatrix, labels_by_genome_id, sharding=None,
                 device=None):
        self._sharding = sharding
        self.device = resolve_device(device)
        self.km = km
        self.genome_count = km.n_genomes
        self.kmer_count = km.n_kmers
        self.labels = np.array(
            [int(labels_by_genome_id[g]) for g in km.genome_ids],
            dtype=np.uint8)
        self._bm = None
        self._dense = None

    @classmethod
    def from_contigs(cls, genome_specs, labels_by_genome_id, k,
                     filter_singleton=False, sharding=None, device=None):
        """Host ingest: per-genome counting on the card + the host union
        merge. ``genome_specs``: (genome id, FASTA path) pairs."""
        dev = resolve_device(device)
        gks = [count_fasta(path, k, genome_id=gid, device=dev)
               for gid, path in genome_specs]
        km = build_presence_matrix(gks, filter_singleton=filter_singleton)
        return cls(km, labels_by_genome_id, sharding=sharding, device=dev)

    @classmethod
    def from_contigs_device(cls, genome_specs, labels_by_genome_id, k,
                            filter_singleton=False, k_budget=None,
                            genome_batch=None, batch_budget=None,
                            device=None):
        """Ingest on the card: extraction, union and packing stay there.

        ``genome_specs``: (genome id, FASTA path) pairs. Returns a
        :class:`DeviceDataset`. ``genome_batch`` (a multiple of 32) switches
        to the batched builder: a sort per batch and one union merge.
        """
        codes_list = [encode_contigs(fasta_to_sequences(path))
                      for _, path in genome_specs]
        ids = [gid for gid, _ in genome_specs]
        if genome_batch:
            dm = build_matrix_device_batched(
                codes_list, k, genome_ids=ids, k_budget=k_budget,
                genome_batch=genome_batch, batch_budget=batch_budget,
                filter_singleton=filter_singleton, device=device)
        else:
            dm = build_matrix_device(
                codes_list, k, genome_ids=ids, k_budget=k_budget,
                filter_singleton=filter_singleton, device=device)
        return DeviceDataset(dm, labels_by_genome_id)

    def bit_matrix(self, sharding=None):
        """The packed matrix on ``sharding`` (else the dataset's own),
        built anew when the sharding asked for is not that of the one
        kept."""
        sharding = sharding or self._sharding
        if self._bm is None or self._bm.sharding != sharding:
            self._bm = None
            self._bm = BitMatrix.from_u64(self.km.matrix, self.km.n_genomes,
                                          self.device, sharding=sharding)
        return self._bm

    def get_matrix_columns(self, columns):
        if self._dense is None:
            self._dense = self.km.dense()
        columns = np.asarray(columns, dtype=np.int64)
        base = np.where(columns >= self.kmer_count, columns - self.kmer_count,
                        columns)
        out = self._dense[:, base].copy()
        inv = columns >= self.kmer_count
        out[:, inv] = 1 - out[:, inv]
        return out


class DeviceDataset:
    """In-memory dataset over a matrix built on the card. The packed
    matrix lives only there; :meth:`get_matrix_columns` unpacks the few
    rule columns the model needs."""

    def __init__(self, device_matrix, labels_by_genome_id):
        self.dm = device_matrix
        self.genome_count = len(device_matrix.genome_ids)
        self.kmer_count = device_matrix.n_kmers
        self.labels = np.array(
            [int(labels_by_genome_id[g]) for g in device_matrix.genome_ids],
            dtype=np.uint8)
        self._bm = device_matrix.bit_matrix()
        self.device = self._bm.device
        self._sharded = {}
        self.km = _DeviceKmerView(device_matrix)

    def bit_matrix(self, sharding=None):
        """The card's matrix, or its copy placed on ``sharding`` (made once
        per sharding)."""
        if sharding is None:
            return self._bm
        if sharding not in self._sharded:
            bm = self._bm
            self._sharded[sharding] = BitMatrix(
                bm.data, bm.n_rows, n_columns=bm.n_columns,
                columns_sharding=sharding)
        return self._sharded[sharding]

    def get_matrix_columns(self, columns):
        """(genomes, len(columns)) uint8: presence for a column below
        ``kmer_count``, absence for ``kmer_count + c``. Gathers the columns
        on the card."""
        columns = np.asarray(columns, dtype=np.int64)
        base = np.where(columns >= self.kmer_count, columns - self.kmer_count,
                        columns)
        data = self._bm.data
        packed = data.index_select(
            1, torch.as_tensor(base, device=data.device)).cpu().numpy()
        dense = unpack_binary_bytes_from_ints(
            packed.view(np.uint32))[:self.genome_count]
        inv = columns >= self.kmer_count
        dense[:, inv] = 1 - dense[:, inv]
        return dense


class _DeviceKmerView:
    """Minimal KmerMatrix-like view for rule decoding."""

    def __init__(self, device_matrix):
        self._dm = device_matrix
        self.k = device_matrix.k
        self._kmers = None

    @property
    def kmers(self):
        if self._kmers is None:
            with span("pipeline.decode") as rec:  # the union's download
                self._kmers = self._dm.union_kmers_host()
                rec["bytes"] = self._kmers.nbytes
        return self._kmers


@dataclass
class PipelineResult:
    model: object
    rules: list
    train_metrics: dict
    test_metrics: dict
    train_idx: np.ndarray
    test_idx: np.ndarray


@spanned("pipeline.fit")
def train_scm(dataset, model_type="conjunction", p=1.0, max_rules=10,
              train_prop=0.75, random_seed=0, mesh=None):
    """Greedy SCM on the in-memory matrix with the argmax engine's fit.

    The split mirrors the reference (RandomState shuffle, ceil of the
    proportion). Returns the fitted model and train/test metrics. With a
    ``mesh`` the matrix is placed column-sharded on it
    (``grm_tpu/pipeline.py:191-196``) and each greedy step counts shard by
    shard.
    """
    rngen = np.random.RandomState(random_seed)
    n = dataset.genome_count
    idx = np.arange(n)
    rngen.shuffle(idx)
    n_train = int(ceil(train_prop * n))
    train_idx, test_idx = np.sort(idx[:n_train]), np.sort(idx[n_train:])

    labels = dataset.labels
    pos = train_idx[labels[train_idx] == 1]
    neg = train_idx[labels[train_idx] == 0]
    if model_type == "disjunction":
        pos, neg = neg, pos

    sharding = None
    if mesh is not None:
        check_mesh(mesh, dataset.device)
        sharding = MeshSharding(mesh)
    bm = dataset.bit_matrix(sharding=sharding)
    rules_arr, _, _ = scm_fit_batch_device(
        bm.data,
        masks_to_tensor(build_packed_mask(pos, n, bm.n_words)[None],
                        bm.device),
        masks_to_tensor(build_packed_mask(neg, n, bm.n_words)[None],
                        bm.device),
        torch.tensor([p], dtype=torch.float32, device=bm.device),
        bm.n_columns, max_rules)
    rule_idx = [int(r) for r in rules_arr[0] if r >= 0]

    model = ConjunctionModel() if model_type == "conjunction" \
        else DisjunctionModel()
    rules = []
    for ridx in rule_idx:
        kmer_i = ridx % dataset.kmer_count
        rule_type = "absence" if ridx >= dataset.kmer_count else "presence"
        seq = decode_kmers(dataset.km.kmers[kmer_i:kmer_i + 1],
                           dataset.km.k)[0]
        rule = KmerRule(kmer_i, seq, rule_type)
        if model_type == "disjunction":
            rule = rule.inverse()
        model.add(rule)
        rules.append(rule)

    X = dataset.get_matrix_columns([r.kmer_index for r in model.rules])
    readdressed = ConjunctionModel() if model_type == "conjunction" \
        else DisjunctionModel()
    for i, r in enumerate(model.rules):
        readdressed.add(KmerRule(i, r.kmer_sequence, r.type))
    train_pred = readdressed.predict(X[train_idx])
    test_pred = readdressed.predict(X[test_idx])
    return PipelineResult(
        model=model,
        rules=rules,
        train_metrics=get_binary_metrics(train_pred, labels[train_idx]),
        test_metrics=get_binary_metrics(test_pred, labels[test_idx]),
        train_idx=train_idx,
        test_idx=test_idx,
    )
