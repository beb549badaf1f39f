"""``learn_CART`` over GRM's GUI grid of class importances (0.25, 0.5,
0.75 and 1.0 for each class: 16 combinations, ``src/kover.py:249``) against
the benchmark's plain reference of it (``benchmark/reference/
cart_grid.py``), on seeded random matrices on the CPU, with the exact
device engine and the host engine.

The fingerprints (the chosen hyperparameters, class importance included,
the tree kept, its rules and tie sets, classifications and metrics) must
be equal, and their floats (CV score, pruning alpha, importances, metrics)
within ``FLOAT_GAP`` of each other. Both sides compute Kover's float64
operations in Kover's order, so they agree to the last bit here; 1e-12
(about 4,500 ulps at 1) admits no more than a reordered sum of a few
dozen terms, and the reference in float32 misses it by five orders
(:func:`test_the_float32_reference_misses_the_tolerance`).

Also the pruning's tree copies (``copy_tree``) and its scalar
``np.allclose``, which keep the grid's 96 finishes linear in the trees'
size.
"""

import os
import sys
from itertools import product

import numpy as np
import pytest

from grm_tpu_torch import profiling
from grm_tpu_torch.dataset import from_numpy_artifact, split_with_proportion
from grm_tpu_torch.learning.cart import _allclose, copy_tree, prune_tree
from grm_tpu_torch.learning.experiments import learn_CART

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness import recipes  # noqa: E402
from harness.compare import compare  # noqa: E402
from harness.runner import load_module  # noqa: E402
from reference import cart_grid  # noqa: E402
from reference import scm as scm_ref  # noqa: E402

job = load_module(os.path.join(BENCH, "jobs", "learn_cart_grid.py"),
                  "test_job_learn_cart_grid")

FLOAT_GAP = 1e-12
VALUES = [0.25, 0.5, 0.75, 1.0]
GRID = [{0: a, 1: b} for a, b in product(VALUES, VALUES)]
SETTINGS = {"criterion": "gini", "max_depth": 10, "min_samples_split": 2,
            "class_importance": [{"0": a, "1": b}
                                 for a, b in product(VALUES, VALUES)]}
N_FOLDS = 5
# A seed of 96 genomes x 3,000 k-mers on which combinations tie: a tie won
# by a smaller master tree, one won by a lower variance of the importances,
# and a final choice whose hyperparameters are not those of the tree kept.
TIE_SEED = 643


def _data(n, k, seed):
    arrays, attrs = recipes.synthetic_arrays(n, k, seed)
    mem = from_numpy_artifact(arrays, attrs)
    split_with_proportion(mem, "sp", train_prop=0.67, random_seed=42,
                          n_folds=N_FOLDS, device="cpu")
    pm = scm_ref.PackedMatrix(arrays["kmer_matrix"], n, "cpu",
                              chunk_cols=4096)
    split = scm_ref.make_split(pm, arrays["phenotype"], 0.67, 42, N_FOLDS)
    return mem, arrays, pm, split


def _reference(arrays, pm, split, dtype=np.float64):
    return cart_grid.learn_grid(
        pm, arrays["phenotype"],
        [g.decode() for g in arrays["genome_identifiers"]],
        arrays["kmer_sequences"], split, SETTINGS, ["0", "1"], dtype)


def _learn(mem, k, engine):
    return learn_CART(dataset_file=mem, split_name="sp", criterion="gini",
                      max_depth=[10], min_samples_split=[2],
                      class_importance=[dict(ci) for ci in GRID],
                      bound_delta=0.05, bound_max_genome_size=k,
                      parameter_selection="cv", engine=engine, device="cpu")


@pytest.mark.parametrize("n,k,seed", [(96, 3000, TIE_SEED), (96, 3000, 2),
                                      (96, 3000, 95), (130, 5000, 11)])
@pytest.mark.parametrize("engine", ["device", "host"])
def test_grid_equals_the_reference(n, k, seed, engine):
    mem, arrays, pm, split = _data(n, k, seed)
    want = _reference(arrays, pm, split)
    entries, gap = compare(job.fingerprint(_learn(mem, k, engine)), want)
    assert entries == 0
    assert gap <= FLOAT_GAP


def _grid_choices(seed):
    _, arrays, pm, split = _data(96, 3000, seed)
    importances = cart_grid.importance_grid(SETTINGS, 2)
    choices = cart_grid.grow_grid(pm, arrays["phenotype"], split, SETTINGS,
                                  importances)
    return importances, choices


def _shape(tree):
    return None if tree.is_leaf else (tree.rule, _shape(tree.left),
                                      _shape(tree.right))


def test_the_tie_seed_exercises_every_tie_rule():
    """On ``TIE_SEED`` the smaller tree wins a tie, a lower variance wins
    another, and the hyperparameters chosen are not those of the master
    tree kept: a tree that differs from the chosen combination's own."""
    importances, choices = _grid_choices(TIE_SEED)
    best, kept, decisions = cart_grid.select(
        [(imp, s, t) for imp, (s, t, _) in zip(importances, choices)])
    assert decisions == [(0, "lower"), (5, "tie"), (6, "lower"),
                         (10, "variance"), (11, "lower"), (15, "size")]
    assert (best, kept) == (15, 11)
    assert _shape(choices[best][1]) != _shape(choices[kept][1])
    # Each decision, by hand from the combinations' results.
    score = [s for s, _, _ in choices]
    size = [cart_grid.n_nodes(t) for _, t, _ in choices]
    var = [np.var(list(imp.values())) for imp in importances]
    assert score[6] < score[0] and np.isclose(score[10], score[6])
    assert size[10] == size[6] and var[10] < var[6]
    assert score[11] < score[10]
    assert np.isclose(score[15], score[11]) and size[15] < size[11]
    assert np.isclose(score[5], score[0]) and size[5] == size[0] \
        and var[5] == var[0]


def test_the_program_keeps_the_earlier_tree_on_a_won_tie():
    """The program's tree is the kept combination's, its hyperparameters,
    score and alpha the chosen one's."""
    mem, arrays, pm, split = _data(96, 3000, TIE_SEED)
    importances, choices = _grid_choices(TIE_SEED)
    best, kept, _ = cart_grid.select(
        [(imp, s, t) for imp, (s, t, _) in zip(importances, choices)])
    out = _learn(mem, 3000, "device")
    best_hp, score = out[0], out[1]
    assert best_hp["class_importance"] == importances[best]
    assert score == choices[best][0]
    assert best_hp["pruning_alpha"] == choices[best][2]
    fp = job.fingerprint(out)
    kept_fp = cart_grid.describe(
        pm, np.asarray(arrays["phenotype"]),
        [g.decode() for g in arrays["genome_identifiers"]],
        arrays["kmer_sequences"], split, choices[kept][1], ["0", "1"])
    assert fp["tree"] == kept_fp["tree"] and fp["rules"] == kept_fp["rules"]


def test_the_float32_reference_misses_the_tolerance():
    _, arrays, pm, split = _data(96, 3000, TIE_SEED)
    want = _reference(arrays, pm, split)
    _, gap = compare(_reference(arrays, pm, split, np.float32), want)
    assert gap > 1e5 * FLOAT_GAP


@pytest.fixture
def spans_on():
    profiling.take_spans()
    profiling.record_spans(True)
    yield
    profiling.record_spans(False)
    profiling.take_spans()


def test_grow_and_select_counters(spans_on):
    """One forest of 16 x 6 = 96 trees over 16 combinations (``cart.grow``'s
    ``trees`` and ``combos``), and one ``cart.select`` a combination whose
    ``ties`` add up to the reference's ties with the best so far."""
    mem, _, _, _ = _data(96, 3000, TIE_SEED)
    _learn(mem, 3000, "device")
    recs, dropped = profiling.take_spans()
    assert dropped == 0
    (grow,) = [r for r in recs if r.name == "cart.grow"]
    assert grow.counts == {"trees": 16 * (N_FOLDS + 1), "combos": 16}
    assert grow.parent.name == "cart.learn"
    selects = [r for r in recs if r.name == "cart.select"]
    assert len(selects) == 16
    assert all(r.parent.name == "cart.learn" for r in selects)
    importances, choices = _grid_choices(TIE_SEED)
    _, _, decisions = cart_grid.select(
        [(imp, s, t) for imp, (s, t, _) in zip(importances, choices)])
    ties = sum(why != "lower" for _, why in decisions)
    assert ties >= 2
    assert sum(r.counts["ties"] for r in selects) == ties
    assert [r.counts["ties"] for r in selects] == [
        int(dict(decisions).get(i, "lower") != "lower") for i in range(16)]


# -- the pruning's copies, which the grid's 96 trees made the job's cost ----

def _walk(node, parent=None):
    yield node, parent
    if node.left_child is not None:
        yield from _walk(node.left_child, node)
        yield from _walk(node.right_child, node)


def test_copy_tree_copies_nodes_and_rules_and_shares_examples():
    mem, _, _, _ = _data(96, 3000, TIE_SEED)
    out = _learn(mem, 3000, "device")
    tree = out[4].decision_tree
    before = str(tree)
    copied = copy_tree(tree)
    assert str(copied) == before and copied.parent is None
    for (a, pa), (b, pb) in zip(_walk(tree), _walk(copied)):
        assert a is not b and b.parent is pb
        assert b.class_examples_idx is a.class_examples_idx
        assert b.breiman_info is a.breiman_info
        if a.rule is not None:
            assert b.rule is not a.rule
            assert (b.rule.kmer_index, str(b.rule)) == \
                (a.rule.kmer_index, str(a.rule))
    # Pruning and readdressing a copy leave the tree as it was.
    for _, node in copied:
        if node.rule is not None:
            node.rule.kmer_index = -1
    copied.left_child = copied.right_child = copied.rule = None
    alphas, trees = prune_tree(tree)
    assert str(tree) == before and str(trees[0]) != str(trees[-1])
    assert all(n.rule.kmer_index >= 0 for _, n in tree if n.rule is not None)


def test_allclose_equals_numpy_on_float64_scalars():
    rng = np.random.RandomState(3)
    base = [0.0, -0.0, 1e-9, 1e-8, 2e-8, 1.0, 0.1 + 0.2, 0.3, 1e300,
            5e-324, np.inf, -np.inf, np.nan]
    base += list(rng.rand(50) * 1e-3)
    base += [v * (1 + d) for v in rng.rand(40)
             for d in (1e-5, -1e-5, 1.0000001e-5, 0.9999999e-5)]
    for x in base:
        for y in base:
            assert _allclose(x, y) == bool(np.allclose(x, y)), (x, y)
