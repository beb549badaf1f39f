"""The plain references agree with the program on the CPU at small sizes,
ties included: the same split, rules, tie sets, scores, metrics; the same
union, matrix and fit."""

import numpy as np
import pytest

from harness import recipes
from harness.compare import compare
from reference import scm as ref

SETTINGS = {"model_type": ["conjunction", "disjunction"],
            "p": [0.1, 0.178, 0.316, 0.562, 1.0, 1.778, 3.162, 5.623, 10.0,
                  999999.0],
            "max_rules": 10, "max_equiv_rules": 10000, "random_seed": 42,
            "bound_delta": 0.05, "engine": "device"}


def tied(arrays, n, k, seed):
    """Copies of a quarter of the columns over another quarter, a third of
    them complemented: exact ties among rules."""
    m = arrays["kmer_matrix"]
    rng = np.random.RandomState(seed)
    src = rng.choice(k, k // 4, replace=False)
    dst = rng.choice(k, k // 4, replace=False)
    m[:, dst] = m[:, src]
    flip = dst[:len(dst) // 3]
    m[:, flip] = ~m[:, flip] & recipes.pack_u64(np.ones(n, np.uint8))[:, None]


@pytest.mark.parametrize("n,k,seed,ties", [(40, 2000, 1, True),
                                           (100, 5000, 11, True),
                                           (130, 3001, 7, False)])
def test_scm_reference_equals_the_program(n, k, seed, ties):
    from grm_tpu_torch.dataset import from_numpy_artifact, \
        split_with_proportion
    from grm_tpu_torch.learning.experiments import learn_SCM

    import jobs_learn_scm as job

    arrays, attrs = recipes.synthetic_arrays(n, k, seed)
    if ties:
        tied(arrays, n, k, seed)
    mem = from_numpy_artifact(arrays, attrs)
    split_with_proportion(mem, "sp", train_prop=0.67, random_seed=42,
                          n_folds=5, device="cpu")
    pm = ref.PackedMatrix(arrays["kmer_matrix"], n, "cpu", chunk_cols=1000)
    split = ref.make_split(pm, arrays["phenotype"], 0.67, 42, 5)
    grp = mem["splits"]["sp"]
    tables = [(grp, split)] + [(grp["folds"]["fold_%d" % (i + 1)], f)
                               for i, f in enumerate(split["folds"])]
    for g, s in tables:
        assert np.array_equal(g["train_genome_idx"][...], s["train"])
        assert np.array_equal(g["test_genome_idx"][...], s["test"])
        for name, want in zip(("unique_risks", "unique_risk_by_kmer",
                               "unique_risk_by_anti_kmer"), s["risks"]):
            assert np.array_equal(g[name][...], want), name
    want = ref.learn_scm(pm, arrays["phenotype"],
                         [g.decode() for g in arrays["genome_identifiers"]],
                         arrays["kmer_sequences"], split, SETTINGS)
    for engine in ("host", "device"):
        out = learn_SCM(dataset_file=mem, split_name="sp",
                        model_type=SETTINGS["model_type"], p=SETTINGS["p"],
                        max_rules=10, max_equiv_rules=10000,
                        parameter_selection="cv", random_seed=42,
                        bound_delta=0.05, bound_max_genome_size=k,
                        engine=engine, device="cpu")
        assert compare(job.fingerprint(out), want) == (0, 0.0), engine


@pytest.mark.parametrize("n,k,seed", [(120, 3000, 3), (342, 5000, 1),
                                      (200, 20000, 7)])
def test_cart_reference_equals_the_program(n, k, seed):
    from grm_tpu_torch.dataset import from_numpy_artifact, \
        split_with_proportion
    from grm_tpu_torch.learning.experiments import learn_CART

    from reference import cart as cref
    import jobs_learn_cart as job

    arrays, attrs = recipes.synthetic_arrays(n, k, seed)
    mem = from_numpy_artifact(arrays, attrs)
    split_with_proportion(mem, "sp", train_prop=0.67, random_seed=42,
                          n_folds=5, device="cpu")
    pm = ref.PackedMatrix(arrays["kmer_matrix"], n, "cpu", chunk_cols=4096)
    split = ref.make_split(pm, arrays["phenotype"], 0.67, 42, 5)
    settings = {"criterion": "gini", "max_depth": 10,
                "min_samples_split": 2,
                "class_importance": {"0": 1.0, "1": 1.0}}
    want = cref.learn_tree(pm, arrays["phenotype"],
                           [g.decode() for g in arrays["genome_identifiers"]],
                           arrays["kmer_sequences"], split, settings,
                           ["0", "1"])
    for engine in ("host", "device"):
        out = learn_CART(dataset_file=mem, split_name="sp",
                         criterion="gini", max_depth=[10],
                         min_samples_split=[2],
                         class_importance=[{0: 1.0, 1: 1.0}],
                         bound_delta=0.05, bound_max_genome_size=k,
                         parameter_selection="cv", engine=engine,
                         device="cpu")
        assert compare(job.fingerprint(out), want) == (0, 0.0), engine


def test_ingest_reference_equals_the_program():
    import torch

    from grm_tpu_torch.parallel.device_build import \
        build_matrix_device_batched
    from reference import ingest as iref

    codes, labels, markers = recipes.ingest_genomes(70, 20000, 90, 520, 3)
    dm = build_matrix_device_batched(
        codes, 31, k_budget=1 << 17, genome_batch=32, batch_budget=1 << 17,
        filter_singleton=True, device="cpu")
    union, dense = iref.ingest(codes, 31, 2, "cpu")
    n = dm.n_kmers
    assert n == union.numel()
    assert torch.equal(dm.union_words[:n], iref.key_words(union, 31))
    assert torch.equal(dm.matrix[:, :n], iref.pack_rows(dense))
    assert {iref.decode(union[i], 31) for i in range(n)} >= set(markers)
