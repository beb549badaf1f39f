"""The dataset artifact: the reference-compatible HDF5 layout, read from a
file or held in memory.

Port of ``grm_tpu/dataset/artifact.py``. The layout is a Kover ``.kover``
file's (``bin/kover/core/kover/dataset/create.py:196-238``, ``ds.py:26-148``):
attrs ``uuid``, ``genome_source_type``, ``genomic_data``,
``phenotype_description``, ``phenotype_metadata_source``, ``filter``,
``compression``, ``classification_type``; datasets ``genome_identifiers``,
``phenotype``, ``phenotype_tags``, ``kmer_sequences``, ``kmer_matrix``
(uint64 MSB-first, rows of 64 genomes), ``kmer_by_matrix_column`` and
``splits/<name>/...``. :class:`GrmDataset` reads the very files
``grm_tpu`` writes (``h5py`` is imported only when a file is opened) or a
:class:`MemoryArtifact`, a mapping of the same names and attrs, so a run can
hold its artifact in memory on a machine without ``h5py``; its path,
``memory://artifact-N``, opens it again in the process that holds it (the
CLI's ``--dataset``).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import weakref

import numpy as np
import torch

from ..device import resolve_device
from ..ops.popcount import BitMatrix, StreamingBitMatrix
from ..utils import unpack_binary_bytes_from_ints

__all__ = ["GrmDataset", "MemoryArtifact", "MemoryDataset", "as_dataset"]

_MEMORY_SERIAL = itertools.count()
_MEMORY_ARTIFACTS = weakref.WeakValueDictionary()  # path -> live artifact


class MemoryDataset:
    """A dataset of a :class:`MemoryArtifact`: a numpy array with ``attrs``,
    read like an h5py dataset (``ds[...]``, slices, ``shape``). Reads return
    views; callers must not write into them."""

    chunks = None

    def __init__(self, data):
        self.data = np.asarray(data)
        self.attrs = {}

    @property
    def shape(self):
        return self.data.shape

    def __getitem__(self, key):
        return self.data[key]


class MemoryGroup(dict):
    """A group of a :class:`MemoryArtifact`: named datasets and sub-groups
    plus ``attrs``, written like an h5py group."""

    def __init__(self):
        super().__init__()
        self.attrs = {}

    def create_group(self, name):
        if name in self:
            raise ValueError("group %r already exists" % name)
        grp = MemoryGroup()
        self[name] = grp
        return grp

    def create_dataset(self, name, data=None, dtype=None, **_):
        if name in self:
            raise ValueError("dataset %r already exists" % name)
        ds = MemoryDataset(np.asarray(data, dtype=dtype))
        self[name] = ds
        return ds


class MemoryArtifact(MemoryGroup):
    """An artifact held in memory: the root group. Each one carries a serial
    number, so caches keyed on it never confuse two artifacts."""

    def __init__(self):
        super().__init__()
        self.serial = next(_MEMORY_SERIAL)
        self.path = "memory://artifact-%d" % self.serial
        _MEMORY_ARTIFACTS[self.path] = self


class _Phenotype:
    def __init__(self, description, tags, metadata, metadata_source):
        self.description = description
        self.tags = tags
        self.metadata = metadata
        self.metadata_source = metadata_source


class _Fold:
    def __init__(self, name, grp):
        self.name = name
        self.train_genome_idx = grp["train_genome_idx"][...]
        self.test_genome_idx = grp["test_genome_idx"][...]
        self.unique_risks = grp["unique_risks"][...]
        self.unique_risk_by_kmer = grp["unique_risk_by_kmer"][...]
        self.unique_risk_by_anti_kmer = grp["unique_risk_by_anti_kmer"][...]


class _Split:
    def __init__(self, name, grp):
        self.name = name
        self.random_seed = grp.attrs["random_seed"]
        self.train_proportion = grp.attrs["train_proportion"]
        self.test_proportion = grp.attrs.get(
            "test_proportion", 1.0 - grp.attrs["train_proportion"]
        )
        self.train_genome_idx = grp["train_genome_idx"][...]
        self.test_genome_idx = grp["test_genome_idx"][...]
        self.unique_risks = grp["unique_risks"][...]
        self.unique_risk_by_kmer = grp["unique_risk_by_kmer"][...]
        self.unique_risk_by_anti_kmer = grp["unique_risk_by_anti_kmer"][...]
        if "folds" in grp:
            self.folds = [
                _Fold(name, grp["folds"][name]) for name in sorted(grp["folds"])
            ]
        else:
            self.folds = []

    def __str__(self):
        return (
            "%s   Train genomes: %d (%.3f)   Test genomes: %d (%.3f)   "
            "Folds: %d   Random Seed: %d"
            % (
                self.name,
                len(self.train_genome_idx),
                self.train_proportion,
                len(self.test_genome_idx),
                self.test_proportion,
                len(self.folds),
                self.random_seed,
            )
        )


class GrmDataset:
    """Read-mostly accessor over an artifact: an HDF5 path, a
    :class:`MemoryArtifact` or its ``memory://`` path. ``device`` (default ``"cuda"``) is where
    :meth:`bit_matrix` places the packed matrix."""

    def __init__(self, source, device=None):
        self.device = resolve_device(device)
        if isinstance(source, str) and source.startswith("memory://"):
            path, source = source, _MEMORY_ARTIFACTS.get(source)
            if source is None:
                raise FileNotFoundError("no artifact %s in this process"
                                        % path)
        self.source = source
        self._memory = isinstance(source, MemoryArtifact)
        self.path = source.path if self._memory else str(source)
        self._bit_matrix = None

    def open(self, mode="r"):
        """Context manager yielding the root group (an h5py File for a path)."""
        if self._memory:
            return contextlib.nullcontext(self.source)
        import h5py

        return h5py.File(self.path, mode)

    def cache_tag(self):
        """Key for caches of this artifact's contents: (path, mtime) for a
        file, so a rebuilt file is not served stale; the artifact's serial
        number in memory."""
        if self._memory:
            return ("memory", self.source.serial)
        try:
            return (self.path, os.path.getmtime(self.path))
        except OSError:
            return (self.path, 0)

    # -- attributes ---------------------------------------------------------
    def _attr(self, name, *default):
        """Root attribute ``name``; with a default, a missing one gives it."""
        with self.open() as f:
            return f.attrs.get(name, *default) if default else f.attrs[name]

    @property
    def uuid(self):
        return self._attr("uuid")

    @property
    def compression(self):
        return self._attr("compression")

    @property
    def kmer_filter(self):
        return self._attr("filter", "nothing")

    @property
    def classification_type(self):
        return self._attr("classification_type", "binary")

    @property
    def genome_source_type(self):
        return self._attr("genome_source_type")

    @property
    def genome_source(self):
        return self._attr("genomic_data")

    # -- datasets -----------------------------------------------------------
    @property
    def genome_identifiers(self):
        with self.open() as f:
            ids = f["genome_identifiers"][...]
        return np.array([v.decode() if isinstance(v, bytes) else str(v)
                         for v in ids])

    @property
    def genome_count(self):
        with self.open() as f:
            return f["genome_identifiers"].shape[0]

    @property
    def kmer_count(self):
        with self.open() as f:
            return f["kmer_sequences"].shape[0]

    @property
    def kmer_length(self):
        with self.open() as f:
            return len(f["kmer_sequences"][0])

    @property
    def kmer_sequences(self):
        with self.open() as f:
            return f["kmer_sequences"][...]

    @property
    def kmer_by_matrix_column(self):
        with self.open() as f:
            return f["kmer_by_matrix_column"][...]

    @property
    def phenotype(self):
        with self.open() as f:
            description = f.attrs.get("phenotype_description", "NA")
            tags = (
                f["phenotype_tags"][...]
                if "phenotype_tags" in f
                else np.array([b"0", b"1"])
            )
            tags = np.array(
                [t.decode() if isinstance(t, bytes) else str(t) for t in tags]
            )
            metadata = f["phenotype"][...] if "phenotype" in f else None
            source = f.attrs.get("phenotype_metadata_source", "NA")
        return _Phenotype(description, tags, metadata, source)

    @property
    def splits(self):
        with self.open() as f:
            if "splits" not in f:
                return []
            names = sorted(f["splits"])
        return [self.get_split(n) for n in names]

    def get_split(self, name):
        with self.open() as f:
            return _Split(name, f["splits"][name])

    # -- matrices -----------------------------------------------------------
    def kmer_matrix_u64(self):
        """Host copy of the packed uint64 matrix (reference layout).

        gzip-chunked HDF5 matrices inflate on a thread pool (the raw chunks
        are read serially; zlib releases the GIL)."""
        with self.open() as f:
            ds = f["kmer_matrix"]
            if (self._memory or ds.compression != "gzip" or ds.chunks is None
                    or ds.shape[1] == 0):
                return ds[...]
            return _parallel_gzip_read(ds)

    def _device_memory_budget(self):
        """Bytes of device memory: ``GRM_HBM_BUDGET_BYTES`` where it is set
        (``grm_tpu``'s override, honoured on the CPU too, so that a test can
        force streaming), else the card's total; None on the CPU."""
        env = os.environ.get("GRM_HBM_BUDGET_BYTES")
        if env:
            return int(env)
        if self.device.type != "cuda":
            return None
        _, total = torch.cuda.mem_get_info(self.device)
        return total

    def bit_matrix(self, sharding=None):
        """The packed matrix: a device-resident :class:`BitMatrix`, or,
        above 60% of the device memory budget, a :class:`StreamingBitMatrix`
        that stays in host memory and streams through the card chunk by
        chunk.

        ``sharding`` (a :class:`~grm_tpu_torch.parallel.mesh.MeshSharding`)
        places the matrix on a mesh, each of this process's shards split
        straight onto its device from the artifact's words of that shard
        alone (the columns of another process are never read); a sharded
        matrix never streams. Without ``sharding`` the matrix is unsharded.
        One matrix is kept, that of the sharding asked for last: asking for
        another frees it and loads anew, so that a sharded and an unsharded
        copy never lie on the card side by side.
        """
        bm = self._bit_matrix
        if bm is None or bm.sharding != sharding:
            self._bit_matrix = None  # free the old matrix before the new one
            del bm
            if sharding is not None:
                with self.open() as f:
                    self._bit_matrix = BitMatrix.from_u64(
                        f["kmer_matrix"], self.genome_count,
                        sharding=sharding)
                return self._bit_matrix
            m64 = self.kmer_matrix_u64()
            device_bytes = m64.shape[0] * 2 * m64.shape[1] * 4
            budget = self._device_memory_budget()
            if budget is not None and device_bytes > 0.6 * budget:
                bm = StreamingBitMatrix.from_u64(
                    m64, self.genome_count, device=self.device)
            else:
                bm = BitMatrix.from_u64(
                    m64, self.genome_count, device=self.device)
            self._bit_matrix = bm
        return self._bit_matrix

    def get_matrix_columns(self, columns):
        """Unpacked presence columns (n_genomes, len(columns)) uint8.

        Columns may include absence-rule indices (>= kmer_count), which are
        returned inverted (reference rules.py:135-171)."""
        columns = np.asarray(columns, dtype=np.int64)
        n_kmers = self.kmer_count
        base_cols = np.where(columns >= n_kmers, columns - n_kmers, columns)
        invert = columns >= n_kmers
        uniq, inverse = np.unique(base_cols, return_inverse=True)
        bm = self._bit_matrix
        if bm is not None:
            dense = bm.get_columns_dense(uniq)
        else:
            with self.open() as f:
                packed = f["kmer_matrix"][:, uniq.tolist()]
            dense = unpack_binary_bytes_from_ints(packed)[: self.genome_count]
        dense = dense[:, inverse]
        dense[:, invert] = 1 - dense[:, invert]
        return dense


def as_dataset(source, device=None):
    """``source`` itself where it is a :class:`GrmDataset`, so that the
    matrix it has loaded serves again (``device``, where given, must be its
    own); else a :class:`GrmDataset` over the artifact ``source`` on
    ``device``."""
    if not isinstance(source, GrmDataset):
        return GrmDataset(source, device=device)
    if device is not None and resolve_device(device) != source.device:
        raise ValueError("the dataset lies on %s, not %s"
                         % (source.device, device))
    return source


def _parallel_gzip_read(ds):
    """Read a gzip-chunked 2-D HDF5 dataset with thread-parallel inflate."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    n_rows, n_cols = ds.shape
    crows, ccols = ds.chunks
    out = np.empty(ds.shape, ds.dtype)

    def inflate(args):
        r, c, raw = args
        arr = np.frombuffer(zlib.decompress(raw), dtype=ds.dtype).reshape(
            crows, ccols
        )
        h = min(crows, n_rows - r)
        w = min(ccols, n_cols - c)
        out[r : r + h, c : c + w] = arr[:h, :w]

    coords = [
        (r, c)
        for r in range(0, n_rows, crows)
        for c in range(0, n_cols, ccols)
    ]
    n_workers = min(os.cpu_count() or 1, 8)
    window = 4 * n_workers
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        for lo in range(0, len(coords), window):
            batch = [
                (r, c, ds.id.read_direct_chunk((r, c))[1])
                for r, c in coords[lo : lo + window]
            ]
            list(pool.map(inflate, batch))
    return out
