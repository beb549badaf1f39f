"""Dataset creation: from contigs / reads / presence-TSV, and the array
writer.

Port of ``grm_tpu/dataset/create.py``, under the same names. It mirrors the
reference creation semantics (``create.py:65-523``), with the C++
multidsk/dsk2kover subprocess stages replaced by the port's k-mer pipeline
(:mod:`grm_tpu_torch.kmer`: each genome counted on the card, the union
merged on the host):

- metadata parsing: labels sorted alphabetically -> numeric uint8, binary
  vs multiclass (<=255 classes), genomes missing metadata discarded with a
  warning (``create.py:65-116``);
- genomes sorted by label before matrix construction (``create.py:190-194``)
  with numpy's default argsort, as the reference sorts;
- matrix packed as uint64 rows of 64 genomes, MSB-first, chunked
  ``(1, min(K, 100000))`` with optional gzip (``create.py:38-41, 224-230``),
  chunks deflated on a thread pool and written with ``write_direct_chunk``;
- k-mer columns in sorted canonical order with an identity
  ``kmer_by_matrix_column`` (the from_tsv behaviour, ``create.py:269``).

Every creator writes an HDF5 file (``h5py`` is imported only then) or, when
``output_path`` is a :class:`~grm_tpu_torch.dataset.artifact.
MemoryArtifact`, fills that artifact with the same arrays and attrs and
returns it: how a machine without ``h5py`` creates a dataset. Every creator
takes ``device`` (default ``"cuda"``, which raises without CUDA; ``"cpu"``
runs the kernels' plain versions). :func:`write_artifact` writes arrays
made elsewhere, to either target.
"""

from __future__ import annotations

import logging
import os
import time
from uuid import uuid1

import numpy as np

from ..device import resolve_device
from ..kmer.counter import _tick, count_fasta_many, count_reads_many
from ..kmer.matrix import build_presence_matrix
from ..ops.kmer import decode_kmers_bytes, n_words_for_k
from ..utils import minimum_uint_size, pack_binary_bytes_to_ints
from .artifact import MemoryArtifact

__all__ = ["from_contigs", "from_reads", "from_tsv", "parse_metadata",
           "write_artifact", "from_numpy_artifact", "ARRAY_NAMES"]

KMER_MATRIX_PACKING_SIZE = 64
KMER_MATRIX_DTYPE = np.uint64
PHENOTYPE_LABEL_DTYPE = np.uint8
BLOCK_SIZE = 100000
ARRAY_NAMES = ("genome_identifiers", "phenotype", "phenotype_tags",
               "kmer_sequences", "kmer_by_matrix_column", "kmer_matrix")


def _callbacks(warning_callback, error_callback, progress_callback):
    if warning_callback is None:
        warning_callback = lambda w: logging.warning(w)
    if error_callback is None:

        def error_callback(exception):
            raise exception

    if progress_callback is None:
        progress_callback = lambda t, p: None
    return warning_callback, error_callback, progress_callback


def parse_metadata(metadata_path, matrix_genome_ids, warning_callback=None,
                   error_callback=None):
    """Parse ``genome_id<whitespace>label`` metadata (create.py:65-116)."""
    warning_callback, error_callback, _ = _callbacks(
        warning_callback, error_callback, None
    )
    with open(metadata_path) as f:
        pairs = [l.split() for l in f if l.strip()]
    md_genome_ids = [p[0] for p in pairs]
    md_genome_labels = [p[1] for p in pairs]
    md_unique_labels, indices = np.unique(md_genome_labels, return_inverse=True)

    # Backward-compat: raw 0/1 labels keep their numeric identity; otherwise
    # sort labels alphabetically for consistent indices across datasets.
    if not (
        len(md_unique_labels) == 2
        and "0" in md_unique_labels
        and "1" in md_unique_labels
    ):
        md_unique_labels = np.sort(md_unique_labels)
        label_to_index = {l: i for i, l in enumerate(md_unique_labels)}
        indices = np.array([label_to_index[l] for l in md_genome_labels])

    if len(md_unique_labels) < 2:
        error_callback(Exception("The dataset must contain at least 2 different phenotypes"))
    elif len(md_unique_labels) > 255:
        error_callback(Exception("The dataset can contain at most 255 different phenotypes"))
    classification_type = "binary" if len(md_unique_labels) == 2 else "multiclass"

    numerical_labels = np.arange(0, len(md_unique_labels))
    md_genome_labels = numerical_labels[indices]

    if len(md_genome_ids) > len(set(md_genome_ids)):
        error_callback(Exception("The metadata contains multiple values for the same genome."))

    matrix_genome_ids = list(matrix_genome_ids)
    only_matrix = set(matrix_genome_ids) - set(md_genome_ids)
    if only_matrix:
        warning_callback(
            "Missing metadata for %d genomes (%s). These genomes will be discarded."
            % (len(only_matrix), ", ".join(sorted(only_matrix)))
        )
    only_metadata = set(md_genome_ids) - set(matrix_genome_ids)
    if only_metadata:
        warning_callback(
            "The metadata contains values for %d genomes that are not in the "
            "genomic data (%s)." % (len(only_metadata), ", ".join(sorted(only_metadata)))
        )

    matrix_set = set(matrix_genome_ids)
    keep = [
        (g, l)
        for g, l in zip(md_genome_ids, md_genome_labels)
        if g in matrix_set
    ]
    if not keep:
        error_callback(Exception("No genomes with both genomic data and metadata."))
    genome_ids, labels = zip(*keep)
    return (
        np.array(genome_ids),
        np.array(labels, dtype=np.uint8),
        np.asarray(md_unique_labels),
        classification_type,
    )


def _memory(f):
    return isinstance(f, MemoryArtifact)


def _compression(gzip):
    """h5py's compression keywords of a dataset (a memory artifact
    ignores them)."""
    return {"compression": "gzip" if gzip > 0 else None,
            "compression_opts": gzip if gzip > 0 else None}


def _init_h5(output_path, source_type, genomic_data, phenotype_description,
             phenotype_metadata_path, gzip):
    """The root of the new artifact: a new HDF5 file, or the
    :class:`MemoryArtifact` passed as ``output_path``; its attrs set."""
    if _memory(output_path):
        f = output_path
    else:
        import h5py

        f = h5py.File(output_path, "w")
    f.attrs["created"] = time.time()
    f.attrs["uuid"] = str(uuid1())
    f.attrs["genome_source_type"] = source_type
    f.attrs["genomic_data"] = str(genomic_data)
    f.attrs["phenotype_description"] = (
        phenotype_description if phenotype_description is not None else "NA"
    )
    f.attrs["phenotype_metadata_source"] = (
        str(phenotype_metadata_path) if phenotype_metadata_path is not None else "NA"
    )
    f.attrs["compression"] = "gzip (level %d)" % gzip
    return f


def _close(f):
    if not _memory(f):
        f.close()


def _write_metadata(f, genome_ids, phenotype_description, phenotype_metadata_path,
                    gzip, warning_callback, error_callback):
    """Returns (sorted genome_ids, labels or None)."""
    comp = _compression(gzip)
    labels = None
    if phenotype_description is not None:
        genome_ids, labels, label_tags, classification_type = parse_metadata(
            phenotype_metadata_path, genome_ids, warning_callback, error_callback
        )
        f.attrs["classification_type"] = classification_type
        # Sort genomes by label (create.py:190-194) with np.argsort's
        # default kind, as the reference does: its equal-label order is
        # deterministic but not stable, and the artifact must be the
        # reference's byte for byte.
        sorter = np.argsort(labels)
        genome_ids = genome_ids[sorter]
        labels = labels[sorter]
        phenotype = f.create_dataset(
            "phenotype", data=labels, dtype=PHENOTYPE_LABEL_DTYPE
        )
        phenotype.attrs["description"] = phenotype_description
        f.create_dataset(
            "phenotype_tags",
            data=np.array([str(t).encode() for t in label_tags]), **comp)
    else:
        genome_ids = np.asarray(genome_ids)
        f.attrs["classification_type"] = "binary"
        f.create_dataset("phenotype_tags", data=np.array([b"0", b"1"]),
                         **comp)
    f.create_dataset(
        "genome_identifiers",
        data=np.array([str(g).encode() for g in genome_ids]), **comp)
    return genome_ids, labels


def _write_matrix(f, km, gzip, progress_callback):
    n_kmers = km.n_kmers
    if n_kmers == 0:
        raise ValueError(
            "No k-mers remain after filtering: the singleton filter removed "
            "every k-mer (each was present in exactly one genome). Pass "
            "--singleton-kmers / filter_singleton=False to keep them."
        )
    block = max(1, min(n_kmers, BLOCK_SIZE))
    # kmer_sequences is ~1 GB of text at published scale: the same
    # parallel deflate as the matrix.
    _write_1d_chunks(f, "kmer_sequences", decode_kmers_bytes(km.kmers, km.k),
                     gzip)
    f.create_dataset(
        "kmer_by_matrix_column",
        data=np.arange(n_kmers),
        dtype=minimum_uint_size(max(n_kmers, 1)),
        **_compression(gzip))
    _write_matrix_chunks(f, np.ascontiguousarray(km.matrix,
                                                 dtype=KMER_MATRIX_DTYPE),
                         gzip, block, progress_callback)
    progress_callback("Creating", 1.0)


def _n_workers():
    return min(os.cpu_count() or 1, 8)


def _write_1d_chunks(f, name, data, gzip):
    """Write a 1-D dataset with thread-parallel gzip (see
    :func:`_write_matrix_chunks`)."""
    n = data.shape[0]
    chunk_len = max(1, min(n, (4 << 20) // max(data.itemsize, 1)))
    if _memory(f) or gzip <= 0 or n * data.itemsize < (1 << 20):
        f.create_dataset(name, data=data, **_compression(gzip))
        return

    import zlib
    from concurrent.futures import ThreadPoolExecutor

    ds = f.create_dataset(
        name, shape=data.shape, dtype=data.dtype,
        compression="gzip", compression_opts=gzip, chunks=(chunk_len,),
    )

    def compress(c0):
        chunk = data[c0: c0 + chunk_len]
        if chunk.shape[0] < chunk_len:  # ragged tail: chunks are full-size
            chunk = np.concatenate(
                [chunk, np.zeros(chunk_len - chunk.shape[0], data.dtype)]
            )
        return c0, zlib.compress(np.ascontiguousarray(chunk).tobytes(), gzip)

    starts = list(range(0, n, chunk_len))
    window = 4 * _n_workers()
    with ThreadPoolExecutor(max_workers=_n_workers()) as pool:
        for lo in range(0, len(starts), window):
            for c0, payload in pool.map(compress, starts[lo: lo + window]):
                ds.id.write_direct_chunk((c0,), payload, filter_mask=0)


def _write_matrix_chunks(f, matrix, gzip, block, progress_callback,
                         name="kmer_matrix"):
    """Write the packed matrix dataset with thread-parallel gzip.

    h5py's filter pipeline compresses chunks serially on one core. Chunks
    are independent deflate streams, so they are compressed on a thread
    pool (zlib releases the GIL) and the ready bytes handed to
    ``write_direct_chunk``: the reference layout (chunked ``(1, block)``,
    deflate level = ``gzip``, ``create.py:224-230``).
    """
    if _memory(f):
        f.create_dataset(name, data=matrix)
        return
    n_rows, n_cols = matrix.shape
    ds = f.create_dataset(
        name,
        shape=matrix.shape,
        dtype=matrix.dtype,
        chunks=(1, block) if n_cols else None,
        **_compression(gzip),
    )
    if not n_cols:
        return
    if gzip <= 0:
        ds[...] = matrix
        return

    import zlib
    from concurrent.futures import ThreadPoolExecutor

    chunk_slices = [
        (r, c, min(c + block, n_cols))
        for r in range(n_rows)
        for c in range(0, n_cols, block)
    ]

    def compress(args):
        r, c0, c1 = args
        chunk = matrix[r: r + 1, c0:c1]
        if c1 - c0 < block:  # ragged tail: HDF5 chunks are full-size
            chunk = np.pad(chunk, ((0, 0), (0, block - (c1 - c0))))
        return r, c0, zlib.compress(np.ascontiguousarray(chunk).tobytes(),
                                    gzip)

    done = 0
    # A bounded in-flight window keeps the compress workers from running
    # far ahead of the serial writer and buffering GBs of payloads.
    window = 4 * _n_workers()
    with ThreadPoolExecutor(max_workers=_n_workers()) as pool:
        for lo in range(0, len(chunk_slices), window):
            for r, c0, payload in pool.map(
                compress, chunk_slices[lo: lo + window]
            ):
                ds.id.write_direct_chunk((r, c0), payload, filter_mask=0)
                done += 1
                progress_callback("Creating", done / len(chunk_slices))


def _read_list(path, missing_message, error_callback):
    """``genome_id<whitespace>path`` lines -> {genome_id: path}; a path that
    does not exist goes to ``error_callback``."""
    with open(path) as fh:
        by_genome_id = dict(l.split() for l in fh if l.strip())
    for g_id, item in by_genome_id.items():
        if not os.path.exists(item):
            error_callback(IOError(missing_message % (g_id, item)))
    return by_genome_id


def _create_from_kmers(source_type, list_path, output_path, paths_by_id,
                       count, filter_singleton, phenotype_description,
                       phenotype_metadata_path, gzip, n_cpu,
                       warning_callback, error_callback, progress_callback,
                       timings):
    """The shared body of :func:`from_contigs` and :func:`from_reads`:
    ``count(pairs)`` counts the genomes in the artifact's order."""
    t0 = time.perf_counter()
    f = _init_h5(output_path, source_type, list_path, phenotype_description,
                 phenotype_metadata_path, gzip)
    try:
        f.attrs["filter"] = "singleton" if filter_singleton else "nothing"
        genome_ids, _ = _write_metadata(
            f, list(paths_by_id), phenotype_description,
            phenotype_metadata_path, gzip, warning_callback, error_callback
        )
        _tick(timings, "write", t0)
        genome_kmers = count([(str(gid), paths_by_id[str(gid)])
                              for gid in genome_ids])
        t0 = time.perf_counter()
        km = build_presence_matrix(genome_kmers,
                                   filter_singleton=filter_singleton,
                                   n_threads=n_cpu)
        del genome_kmers
        _tick(timings, "merge", t0)
        t0 = time.perf_counter()
        _write_matrix(f, km, gzip, progress_callback)
        _tick(timings, "write", t0)
    finally:
        _close(f)
    return output_path if _memory(output_path) else None


def from_contigs(contig_list_path, output_path, kmer_size, filter_singleton=False,
                 phenotype_description=None, phenotype_metadata_path=None, gzip=4,
                 n_cpu=None, warning_callback=None, error_callback=None,
                 progress_callback=None, device=None, timings=None):
    """Create a dataset from assembled genomes (reference create.py:278-396).

    ``contig_list_path``: two-column file, ``genome_id<whitespace>fasta_path``.
    ``output_path``: an HDF5 path, or a :class:`MemoryArtifact` to fill and
    return. ``filter_singleton``: apply the dsk2kover singleton filter.
    ``n_cpu``: threads of the partition-parallel union merge (the role of
    multidsk's ``-nb-cores``, kmer_count.py:34); None/0 = all cores. ``device``: where
    each genome's k-mers are counted. ``timings``: a dict that gains the
    seconds of each stage (``"encode"``, ``"count"``, ``"merge"``,
    ``"write"``).
    """
    n_cpu = n_cpu or None
    dev = resolve_device(device)
    warning_callback, error_callback, progress_callback = _callbacks(
        warning_callback, error_callback, progress_callback
    )
    n_words_for_k(kmer_size)  # validate k
    paths_by_id = _read_list(
        contig_list_path, "The contig file for genome %s cannot be found: %s",
        error_callback)
    return _create_from_kmers(
        "contigs", contig_list_path, output_path, paths_by_id,
        lambda pairs: count_fasta_many(
            pairs, kmer_size, progress_callback=progress_callback,
            device=dev,
            timings=timings),
        filter_singleton, phenotype_description, phenotype_metadata_path,
        gzip, n_cpu, warning_callback, error_callback, progress_callback,
        timings)


def from_reads(reads_list_path, output_path, kmer_size, abundance_min=1,
               filter_singleton=False, phenotype_description=None,
               phenotype_metadata_path=None, gzip=4, n_cpu=None,
               warning_callback=None, error_callback=None,
               progress_callback=None, device=None):
    """Create a dataset from read directories (reference create.py:399-523);
    arguments as :func:`from_contigs` (no ``timings``), plus multidsk's
    ``abundance_min``."""
    n_cpu = n_cpu or None
    dev = resolve_device(device)
    warning_callback, error_callback, progress_callback = _callbacks(
        warning_callback, error_callback, progress_callback
    )
    n_words_for_k(kmer_size)
    paths_by_id = _read_list(
        reads_list_path, "The read directory for genome %s cannot be found: "
        "%s", error_callback)
    return _create_from_kmers(
        "reads", reads_list_path, output_path, paths_by_id,
        lambda pairs: count_reads_many(
            pairs, kmer_size, abundance_min=abundance_min,
            progress_callback=progress_callback, device=dev),
        filter_singleton, phenotype_description, phenotype_metadata_path,
        gzip, n_cpu, warning_callback, error_callback, progress_callback,
        None)


def from_tsv(tsv_path, output_path, phenotype_description=None,
             phenotype_metadata_path=None, gzip=4, warning_callback=None,
             error_callback=None, progress_callback=None, device=None):
    """Create a dataset from a presence TSV (reference create.py:119-275).

    The TSV has header ``kmers\\t<id1>...`` and one 0/1 row per k-mer, the
    format written by Ray Surveyor /
    :func:`grm_tpu_torch.kmer.matrix.matrix_to_tsv`. Nothing here runs on
    the card: the packing is host work. ``device`` exists only so that
    every creator (and ``dataset create``) takes the same argument; it is
    checked and then unused.
    """
    import pandas as pd

    resolve_device(device)
    warning_callback, error_callback, progress_callback = _callbacks(
        warning_callback, error_callback, progress_callback
    )
    if (phenotype_description is None) != (phenotype_metadata_path is None):
        raise ValueError(
            "If a phenotype is specified, it must have a description and a "
            "metadata file."
        )

    reader = pd.read_csv(tsv_path, sep="\t", index_col=0, iterator=True, engine="c")
    genome_ids = reader.get_chunk(1).columns.values
    del reader
    if len(set(genome_ids)) < len(genome_ids):
        error_callback(Exception("The genomic data contains genomes with the same identifier."))

    f = _init_h5(output_path, "tsv", tsv_path, phenotype_description,
                 phenotype_metadata_path, gzip)
    try:
        genome_ids, _ = _write_metadata(
            f, list(genome_ids), phenotype_description,
            phenotype_metadata_path, gzip, warning_callback, error_callback
        )

        # Stream TSV blocks, transpose to genome-major, bit-pack
        # (create.py:240-271).
        df_iter = pd.read_csv(tsv_path, sep="\t", index_col=0,
                              chunksize=BLOCK_SIZE)
        blocks_kmers, blocks_packed = [], []
        kmer_len = None
        for chunk in df_iter:
            kmers_data = chunk.index.values.astype(str)
            if kmer_len is None:
                kmer_len = len(kmers_data[0])
            dense = chunk[genome_ids].T.values.astype(np.uint8)
            blocks_kmers.append(np.array([s.encode() for s in kmers_data],
                                         dtype="S%d" % kmer_len))
            blocks_packed.append(
                pack_binary_bytes_to_ints(dense, KMER_MATRIX_PACKING_SIZE)
            )
        kmer_seqs = np.concatenate(blocks_kmers)
        packed = np.concatenate(blocks_packed, axis=1)
        n_kmers = kmer_seqs.shape[0]
        block = max(1, min(n_kmers, BLOCK_SIZE))

        f.create_dataset("kmer_sequences", data=kmer_seqs,
                         **_compression(gzip))
        f.create_dataset(
            "kmer_by_matrix_column",
            data=np.arange(n_kmers),
            dtype=minimum_uint_size(max(n_kmers, 1)),
            **_compression(gzip))
        _write_matrix_chunks(f, np.ascontiguousarray(packed,
                                                     dtype=KMER_MATRIX_DTYPE),
                             gzip, block, progress_callback)
        progress_callback("Creating", 1.0)
    finally:
        _close(f)
    return output_path if _memory(output_path) else None


# -- arrays made elsewhere ----------------------------------------------------

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
    if gzip > 0 and not _memory(target):
        comp = {"compression": "gzip", "compression_opts": gzip}
    for name in ARRAY_NAMES[:-1]:
        ds = target.create_dataset(name, data=np.asarray(arrays[name]), **comp)
        if name == "phenotype":
            ds.attrs["description"] = root_attrs["phenotype_description"]
    chunks = (1, max(1, min(matrix.shape[1], BLOCK_SIZE)))
    if _memory(target) or not matrix.shape[1]:
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
