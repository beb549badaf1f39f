"""``learn_SCM`` of the port (on the CPU, through the kernels' plain
versions) against ``grm_tpu``'s, engine by engine, on tie-rich artifacts
that ``grm_tpu.dataset.from_tsv`` and ``split_with_proportion`` build: the
hyperparameters, score, rules, tie sets, importances, metrics and
classifications must be equal. Also the port's own split and its in-memory
artifact against the same files."""

import h5py
import numpy as np
import pytest

from grm_tpu.dataset import from_tsv
from grm_tpu.dataset.split import split_with_proportion as jax_split
from grm_tpu.learning.experiments.scm_experiment import learn_SCM as jax_learn

from grm_tpu_torch.dataset import from_numpy_artifact, split_with_proportion
from grm_tpu_torch.dataset.create import ARRAY_NAMES
from grm_tpu_torch.learning.experiments import learn_SCM

ENGINES = ["host", "device", "device-argmax"]


def _write_tsv(tmp_path, dense, labels, name):
    n_genomes, n_kmers = dense.shape
    ids = ["g%03d" % i for i in range(n_genomes)]
    k = 8
    kmers = ["".join("ACGT"[(i >> (2 * j)) & 3] for j in range(k))
             for i in range(n_kmers)]
    lines = ["kmers\t" + "\t".join(ids)]
    for r in range(n_kmers):
        lines.append(kmers[r] + "\t"
                     + "\t".join(str(int(v)) for v in dense[:, r]))
    tsv = tmp_path / (name + ".tsv")
    tsv.write_text("\n".join(lines) + "\n")
    meta = tmp_path / (name + "_meta.tsv")
    meta.write_text("\n".join(
        "%s\t%s" % (g, l) for g, l in zip(ids, labels)) + "\n")
    return tsv, meta


def _tied_dense(seed, n_genomes=24, n_kmers=60):
    rng = np.random.RandomState(seed)
    dense = (rng.rand(n_genomes, n_kmers) > 0.5).astype(np.uint8)
    labels = rng.randint(0, 2, n_genomes)
    for c, noise in [(4, 3), (12, 6), (18, 9)]:
        col = (labels > 0).astype(np.uint8)
        flips = rng.choice(n_genomes, noise, replace=False)
        col[flips] = 1 - col[flips]
        dense[:, c] = col
    dense[:, 30] = dense[:, 4]
    dense[:, 31] = dense[:, 4]
    dense[:, 40] = dense[:, 12]
    dense[:, 50] = 1 - dense[:, 4]
    return dense, labels


def _artifact(tmp_path, dense, labels, name, seed, n_folds=3,
              train_prop=0.7):
    tsv, meta = _write_tsv(tmp_path, dense, labels, name)
    path = tmp_path / (name + ".h5")
    from_tsv(tsv, path, phenotype_description="synthetic",
             phenotype_metadata_path=meta, gzip=0)
    raw = _read_arrays(path)
    jax_split(path, "sp", train_prop=train_prop, random_seed=seed,
              n_folds=n_folds)
    return path, raw


def _read_arrays(path):
    with h5py.File(path) as f:
        arrays = {n: f[n][...] for n in ARRAY_NAMES}
        attrs = dict(f.attrs)
    return arrays, attrs


def _s(x):
    return x.decode() if isinstance(x, bytes) else str(x)


def _rule_key(r):
    return (_s(r.kmer_sequence), _s(r.type))


def _norm_metrics(m):
    if m is None:
        return None
    return {k: [float(x) if not isinstance(x, list) else x for x in v]
            if isinstance(v, (list, np.ndarray)) else float(v)
            for k, v in m.items()}


def _scm_fingerprint(out):
    best_hp, score, train_m, test_m, model, imps, equiv, cls = out
    return {
        "hp": (_s(best_hp["model_type"]), float(best_hp["p"]),
               int(best_hp["max_rules"])),
        "score": None if score is None else float(score),
        "rules": [_rule_key(r) for r in model.rules],
        "importances": [float(v) for v in np.asarray(imps).ravel()],
        "equiv": [sorted(_rule_key(e) for e in eq) for eq in equiv],
        "train": _norm_metrics(train_m),
        "test": _norm_metrics(test_m),
        "cls": {k: sorted(_s(g) for g in v) for k, v in cls.items()},
    }


def _both(path, engine, **kwargs):
    want = _scm_fingerprint(jax_learn(dataset_file=path, engine=engine,
                                      **kwargs))
    got = _scm_fingerprint(learn_SCM(dataset_file=path, engine=engine,
                                     device="cpu", **kwargs))
    return got, want


CV = dict(split_name="sp", model_type=["conjunction", "disjunction"],
          p=[0.5, 1.0, 2.0], kmer_blacklist_file=None, max_rules=4,
          max_equiv_rules=100, parameter_selection="cv", n_cpu=1,
          random_seed=17, authorized_rules="", bound_delta=0.05,
          bound_max_genome_size=60)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", [0, 3])
def test_learn_scm_cv_matches_jax(tmp_path, seed, engine):
    dense, labels = _tied_dense(seed)
    path, _ = _artifact(tmp_path, dense, labels, "cv%d" % seed, seed)
    got, want = _both(path, engine, **CV)
    assert got == want
    if seed == 0 and engine != "device-argmax":
        assert any(len(eq) > 1 for eq in want["equiv"])


@pytest.mark.parametrize("engine", ENGINES)
def test_learn_scm_bound_matches_jax(tmp_path, engine):
    dense, labels = _tied_dense(5)
    path, _ = _artifact(tmp_path, dense, labels, "bd", 5)
    kwargs = dict(CV, p=[1.0, 2.0], max_rules=3, parameter_selection="bound",
                  random_seed=3, bound_max_genome_size=1000)
    got, want = _both(path, engine, **kwargs)
    assert got == want


@pytest.mark.parametrize("engine", ENGINES)
def test_learn_scm_equiv_subsample_matches_jax(tmp_path, engine):
    """max_equiv_rules below the tie-set size forces the RandomState
    subsample of the equivalent rules: same seed, same sample."""
    rng = np.random.RandomState(9)
    dense = (rng.rand(20, 40) > 0.5).astype(np.uint8)
    labels = (rng.rand(20) > 0.5).astype(np.uint8)
    for c in range(8):
        dense[:, 10 + c] = labels
    path, _ = _artifact(tmp_path, dense, labels, "sub", 9, n_folds=2)
    kwargs = dict(CV, model_type=["conjunction"], p=[1.0], max_rules=3,
                  max_equiv_rules=3, parameter_selection="none",
                  random_seed=1234, bound_max_genome_size=40)
    got, want = _both(path, engine, **kwargs)
    if engine != "device-argmax":  # the argmax engine keeps no tie sets
        assert max(len(eq) for eq in want["equiv"]) == 3
    assert got == want


@pytest.mark.parametrize("engine", ENGINES)
def test_learn_scm_blacklist_matches_jax(tmp_path, engine):
    rng = np.random.RandomState(14)
    dense = (rng.rand(24, 50) > 0.5).astype(np.uint8)
    labels = (rng.rand(24) > 0.5).astype(np.uint8)
    dense[:, 7] = labels
    col = labels.copy()
    col[rng.choice(24, 3, replace=False)] ^= 1
    dense[:, 20] = col
    path, _ = _artifact(tmp_path, dense, labels, "bl", 14, n_folds=2)
    with h5py.File(path) as f:
        marker = _s(f["kmer_sequences"][int(f["kmer_by_matrix_column"][7])])
    bl = tmp_path / "bl.txt"
    bl.write_text(marker + "\n")
    kwargs = dict(CV, model_type=["conjunction"], p=[1.0],
                  kmer_blacklist_file=str(bl), max_rules=3, random_seed=1,
                  bound_max_genome_size=50)
    got, want = _both(path, engine, **kwargs)
    assert all(seq != marker for seq, _ in want["rules"])
    assert got == want


def test_port_split_and_memory_artifact_match_jax(tmp_path):
    """The port's split of an in-memory copy of the artifact writes the same
    split arrays as grm_tpu's split of the file, and learn_SCM on the
    in-memory artifact gives grm_tpu's fingerprint."""
    dense, labels = _tied_dense(0)
    path, (arrays, attrs) = _artifact(tmp_path, dense, labels, "mem", 11,
                                      n_folds=4)
    mem = from_numpy_artifact(arrays, attrs)
    split_with_proportion(mem, "sp", train_prop=0.7, random_seed=11,
                          n_folds=4, device="cpu")
    with h5py.File(path) as f:
        want, got = f["splits"]["sp"], mem["splits"]["sp"]
        keys = ("train_genome_idx", "test_genome_idx", "unique_risks",
                "unique_risk_by_kmer", "unique_risk_by_anti_kmer")
        for key in keys:
            np.testing.assert_array_equal(got[key][...], want[key][...])
            assert got[key][...].dtype == want[key][...].dtype
        assert sorted(got["folds"]) == sorted(want["folds"])
        for fold in want["folds"]:
            for key in keys:
                np.testing.assert_array_equal(got["folds"][fold][key][...],
                                              want["folds"][fold][key][...])
    expected = _scm_fingerprint(jax_learn(dataset_file=path, engine="host",
                                          **CV))
    for engine in ("host", "device"):
        assert _scm_fingerprint(learn_SCM(
            dataset_file=mem, engine=engine, device="cpu", **CV)) == expected


def test_write_artifact_to_hdf5_reads_in_both_packages(tmp_path):
    """The port's writer, to an HDF5 file with gzip chunks: grm_tpu reads
    and splits it, and both packages learn the same model from it."""
    from grm_tpu.dataset import GrmDataset as JaxDataset

    from grm_tpu_torch.dataset import GrmDataset, write_artifact

    dense, labels = _tied_dense(3)
    _, (arrays, attrs) = _artifact(tmp_path, dense, labels, "src", 3)
    path = tmp_path / "written.h5"
    with h5py.File(path, "w") as f:
        write_artifact(f, arrays, attrs, gzip=4)
    with h5py.File(path) as f:
        assert f["kmer_matrix"].compression == "gzip"
    np.testing.assert_array_equal(JaxDataset(path).kmer_matrix_u64(),
                                  arrays["kmer_matrix"])
    np.testing.assert_array_equal(
        GrmDataset(path, device="cpu").kmer_matrix_u64(),
        arrays["kmer_matrix"])
    jax_split(path, "sp", train_prop=0.7, random_seed=3, n_folds=3)
    got, want = _both(path, "device", **CV)
    assert got == want
