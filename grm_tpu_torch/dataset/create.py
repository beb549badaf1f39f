"""Writing an artifact's arrays, to an HDF5 file or to memory.

The array-writing part of ``grm_tpu/dataset/create.py``: the layout that
the reference writes (``create.py:196-238``) and ``grm_tpu``'s benchmark
artifact uses: attrs, ``genome_identifiers``, ``phenotype`` (with attr
``description``), ``phenotype_tags``, fixed-width ``kmer_sequences``,
``kmer_by_matrix_column`` and the uint64 MSB-first ``kmer_matrix`` in
``(1, min(K, 100000))`` chunks. One writer serves both targets: an h5py
file and a :class:`~grm_tpu_torch.dataset.artifact.MemoryArtifact`.
"""

from __future__ import annotations

import numpy as np

from .artifact import MemoryArtifact

__all__ = ["write_artifact", "from_numpy_artifact", "ARRAY_NAMES"]

BLOCK_SIZE = 100000
ARRAY_NAMES = ("genome_identifiers", "phenotype", "phenotype_tags",
               "kmer_sequences", "kmer_by_matrix_column", "kmer_matrix")


def _default_attrs(arrays):
    n_classes = len(arrays["phenotype_tags"])
    return {
        "uuid": "in-memory",
        "genome_source_type": "tsv",
        "genomic_data": "NA",
        "phenotype_description": "NA",
        "phenotype_metadata_source": "NA",
        "filter": "nothing",
        "compression": "gzip (level 0)",
        "classification_type": "binary" if n_classes == 2 else "multiclass",
    }


def write_artifact(target, arrays, attrs=None, gzip=0):
    """Write an artifact's arrays into ``target``, an open h5py File or a
    :class:`MemoryArtifact`.

    ``arrays`` maps every name in :data:`ARRAY_NAMES` to its array:
    genome ids and phenotype tags as bytes, labels as uint8 sorted by label
    (the reference's genome order), k-mer sequences as fixed-width bytes,
    the packed uint64 ``kmer_matrix`` (W64, K). ``attrs`` override the
    root attributes; the phenotype description also lands on the
    ``phenotype`` dataset. ``gzip`` > 0 compresses a file's datasets.
    """
    missing = [n for n in ARRAY_NAMES if n not in arrays]
    if missing:
        raise ValueError("missing artifact arrays: %s" % ", ".join(missing))
    matrix = np.ascontiguousarray(arrays["kmer_matrix"], dtype=np.uint64)
    n_genomes = len(arrays["genome_identifiers"])
    if matrix.shape[0] != -(-n_genomes // 64):
        raise ValueError("kmer_matrix must hold ceil(n_genomes / 64) rows")
    if matrix.shape[1] != len(arrays["kmer_sequences"]):
        raise ValueError("kmer_matrix must hold one column per k-mer")
    root_attrs = _default_attrs(arrays)
    root_attrs.update(attrs or {})
    for key, value in root_attrs.items():
        target.attrs[key] = value
    comp = {}
    if gzip > 0 and not isinstance(target, MemoryArtifact):
        comp = {"compression": "gzip", "compression_opts": gzip}
    for name in ARRAY_NAMES[:-1]:
        ds = target.create_dataset(name, data=np.asarray(arrays[name]), **comp)
        if name == "phenotype":
            ds.attrs["description"] = root_attrs["phenotype_description"]
    chunks = (1, max(1, min(matrix.shape[1], BLOCK_SIZE)))
    if isinstance(target, MemoryArtifact) or not matrix.shape[1]:
        target.create_dataset("kmer_matrix", data=matrix)
    else:
        target.create_dataset("kmer_matrix", data=matrix, chunks=chunks,
                              **comp)
    return target


def from_numpy_artifact(arrays, attrs=None):
    """An in-memory artifact from numpy arrays (see :func:`write_artifact`);
    pass it to ``GrmDataset``, ``split_with_proportion`` or ``learn_SCM``
    in place of a path."""
    return write_artifact(MemoryArtifact(), arrays, attrs)
