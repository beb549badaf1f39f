"""Train/test/fold splits with per-k-mer risk precomputation (port of
``grm_tpu/dataset/split.py``: ``split_with_proportion``, ``split_with_ids``).

Mirrors the reference's ``split.py:31-256`` semantics bit-for-bit:

- ``np.random.RandomState(seed)`` drives the genome shuffle and then the
  fold-assignment shuffle, in that order;
- fold assignment is ``arange(n_train) % n_folds`` shuffled (split.py:198-199);
- per-k-mer empirical risks on the train set and on each fold's train set are
  rounded to 5 decimals and stored as a unique-value table plus per-k-mer /
  per-anti-k-mer index arrays (split.py:171-188, 213-228) — these are the SCM
  tie-breaker tables.

The risk computation itself is one masked-popcount device sweep (the
``popcount_colsum`` kernel): all masks (train pos/neg + every fold's
pos/neg) go through the bit matrix in a single multi-mask pass instead of
the reference's 2 x (1 + n_folds) full matrix reads. The split lands in the
artifact it was read from: an HDF5 file or an in-memory artifact.
"""

from __future__ import annotations

import logging
from math import ceil

import numpy as np

from .artifact import as_dataset
from ..utils import minimum_uint_size

__all__ = ["split_with_ids", "split_with_proportion"]


def _callbacks(warning_callback, error_callback, progress_callback):
    if warning_callback is None:
        warning_callback = lambda w: logging.warning(w)
    if error_callback is None:

        def error_callback(exception):
            raise exception

    if progress_callback is None:
        progress_callback = lambda t, p: None
    return warning_callback, error_callback, progress_callback


def split_with_proportion(input, split_name, train_prop, random_seed, n_folds=0,
                          warning_callback=None, error_callback=None,
                          progress_callback=None, device=None):
    """Random train/test split by proportion (split.py:86-121).

    ``input`` is an artifact path, a ``MemoryArtifact`` or a ``GrmDataset``
    (whose loaded matrix serves again); ``device``
    (default ``"cuda"``) runs the risk-table sweep."""
    warning_callback, error_callback, progress_callback = _callbacks(
        warning_callback, error_callback, progress_callback
    )
    random_generator = np.random.RandomState(random_seed)
    dataset = as_dataset(input, device=device)

    n_genomes = dataset.genome_count
    n_train = int(ceil(train_prop * n_genomes))
    idx = np.arange(n_genomes)
    random_generator.shuffle(idx)
    train_idx = idx[:n_train]
    test_idx = idx[n_train:]

    _split(dataset, split_name, random_generator, random_seed, train_idx,
           test_idx, warning_callback, error_callback, progress_callback, n_folds)


def split_with_ids(input, split_name, train_ids_file, test_ids_file,
                   random_seed, n_folds=0, warning_callback=None,
                   error_callback=None, progress_callback=None, device=None):
    """Train/test split from explicit genome id files (split.py:31-83);
    ``input`` and ``device`` as in :func:`split_with_proportion`."""
    warning_callback, error_callback, progress_callback = _callbacks(
        warning_callback, error_callback, progress_callback
    )
    random_generator = np.random.RandomState(random_seed)
    dataset = as_dataset(input, device=device)
    idx_by_genome_id = {g: i for i, g in enumerate(dataset.genome_identifiers)}

    def _parse_ids(ids_file, learning_step):
        with open(ids_file) as f:
            ids = [l.strip() for l in f.read().split("\n") if l.strip()]
        missing = [i for i in ids if i not in idx_by_genome_id]
        if missing:
            error_callback(
                Exception(
                    "The %s genome identifiers contain IDs that are not in the "
                    "dataset: %s" % (learning_step, ", ".join(missing))
                )
            )
        return ids

    train_ids = _parse_ids(train_ids_file, "training")
    test_ids = _parse_ids(test_ids_file, "testing")
    train_idx = np.array([idx_by_genome_id[i] for i in train_ids])
    test_idx = np.array([idx_by_genome_id[i] for i in test_ids])

    _split(dataset, split_name, random_generator, random_seed, train_idx,
           test_idx, warning_callback, error_callback, progress_callback, n_folds)


def _risk_tables(n_pos, n_neg, counts_pos, counts_neg, n_kmers):
    """Risks rounded to 5 decimals -> unique table + index arrays.

    Exactly mirrors split.py:178-188: risk = (pos errors + neg errors) / n,
    anti-risk = 1 - risk, both rounded, and a single np.unique over their
    concatenation.
    """
    kmer_risks = (float(n_pos) - counts_pos[:n_kmers]).astype(np.float64)
    kmer_risks += counts_neg[:n_kmers]
    kmer_risks /= float(n_pos + n_neg)
    np.round(kmer_risks, 5, out=kmer_risks)
    anti_kmer_risks = 1.0 - kmer_risks
    np.round(anti_kmer_risks, 5, out=anti_kmer_risks)
    unique_risks, unique_idx = np.unique(
        np.hstack((kmer_risks, anti_kmer_risks)), return_inverse=True
    )
    return unique_risks, unique_idx


def _write_risk_tables(grp, unique_risks, unique_idx, n_kmers):
    idx_dtype = minimum_uint_size(len(unique_risks))
    grp.create_dataset("unique_risks", data=unique_risks)
    grp.create_dataset(
        "unique_risk_by_kmer", data=unique_idx[:n_kmers], dtype=idx_dtype
    )
    grp.create_dataset(
        "unique_risk_by_anti_kmer", data=unique_idx[n_kmers:], dtype=idx_dtype
    )


def _split(dataset, split_name, random_generator, random_seed, train_idx,
           test_idx, warning_callback, error_callback, progress_callback,
           n_folds=0):
    _validate_split(dataset, split_name, train_idx, test_idx, n_folds,
                    warning_callback, error_callback)
    train_idx = np.array(train_idx)
    test_idx = np.array(test_idx)

    labels = dataset.phenotype.metadata
    n_kmers = dataset.kmer_count
    bit_matrix = dataset.bit_matrix()

    # Fold assignment BEFORE the device sweep so the RNG call order matches
    # the reference (shuffle(idx) then shuffle(fold_by_training_set_genome)).
    fold_by_training_set_genome = None
    if n_folds > 0:
        fold_by_training_set_genome = np.arange(len(train_idx)) % n_folds
        random_generator.shuffle(fold_by_training_set_genome)

    # One multi-mask device pass computes every risk table's counts.
    train_pos_idx = train_idx[labels[train_idx] == 1]
    train_neg_idx = train_idx[labels[train_idx] == 0]
    mask_rows = [train_pos_idx, train_neg_idx]
    fold_sets = []
    for fold in range(n_folds):
        fold_train_idx = train_idx[fold_by_training_set_genome != fold]
        fold_test_idx = train_idx[fold_by_training_set_genome == fold]
        fp = fold_train_idx[labels[fold_train_idx] == 1]
        fn = fold_train_idx[labels[fold_train_idx] == 0]
        fold_sets.append((fold_train_idx, fold_test_idx, fp, fn))
        mask_rows.extend([fp, fn])
    counts = bit_matrix.presence_counts(mask_rows)

    example_idx_dtype = minimum_uint_size(dataset.genome_count)
    with dataset.open("r+") as f:
        if "splits" not in f:
            f.create_group("splits")
        split = f["splits"].create_group(split_name)
        split.attrs["random_seed"] = random_seed
        split.attrs["n_folds"] = n_folds
        split.attrs["train_proportion"] = 1.0 * len(train_idx) / dataset.genome_count
        split.attrs["test_proportion"] = 1.0 * len(test_idx) / dataset.genome_count
        split.create_dataset(
            "train_genome_idx", data=np.sort(train_idx), dtype=example_idx_dtype
        )
        split.create_dataset(
            "test_genome_idx", data=np.sort(test_idx), dtype=example_idx_dtype
        )
        progress_callback("Split", 0.5 / (1 + n_folds))

        unique_risks, unique_idx = _risk_tables(
            len(train_pos_idx), len(train_neg_idx), counts[0], counts[1], n_kmers
        )
        _write_risk_tables(split, unique_risks, unique_idx, n_kmers)
        progress_callback("Split", 1.0 / (1 + n_folds))

        if n_folds > 0:
            folds = split.create_group("folds")
            for fold, (ftr, fte, fp, fn) in enumerate(fold_sets):
                grp = folds.create_group("fold_%d" % (fold + 1))
                grp.create_dataset(
                    "train_genome_idx", data=np.sort(ftr), dtype=example_idx_dtype
                )
                grp.create_dataset(
                    "test_genome_idx", data=np.sort(fte), dtype=example_idx_dtype
                )
                unique_risks, unique_idx = _risk_tables(
                    len(fp), len(fn), counts[2 + 2 * fold], counts[3 + 2 * fold],
                    n_kmers,
                )
                _write_risk_tables(grp, unique_risks, unique_idx, n_kmers)
                progress_callback("Split", (1.0 + fold + 1) / (1 + n_folds))


def _validate_split(dataset, split_name, train_idx, test_idx, n_folds,
                    warning_callback, error_callback):
    """Reference validation rules (split.py:234-256)."""
    if dataset.phenotype.description == "NA":
        error_callback(Exception("A dataset must contain phenotypic metadata to be split."))
    if split_name in (s.name for s in dataset.splits):
        error_callback(
            Exception(
                'A split with the identifier "%s" already exists in the dataset.'
                % split_name
            )
        )
    if n_folds > len(train_idx):
        error_callback(
            Exception(
                "There cannot be more cross-validation folds (%d) than genomes "
                "in the training set (%d)." % (n_folds, len(train_idx))
            )
        )
    if n_folds == 1:
        error_callback(Exception("The number of cross-validation folds must be greater than 1."))
    if len(set(train_idx)) < len(train_idx):
        error_callback(Exception("The training set contains duplicate genomes."))
    if len(set(test_idx)) < len(test_idx):
        error_callback(Exception("The testing set contains duplicate genomes."))
    if len(set(train_idx).union(test_idx)) < len(train_idx) + len(test_idx):
        error_callback(Exception("The training and testing sets overlap."))
