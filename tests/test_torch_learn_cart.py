"""``learn_CART`` of the port (on the CPU, through the kernels' plain
versions) against ``grm_tpu``'s, engine by engine, on tie-rich artifacts
that ``grm_tpu.dataset.from_tsv`` and ``split_with_proportion`` build: the
hyperparameters (with ``pruning_alpha``), score, tree, rules, tie sets,
importances, metrics and classifications must be equal. The host and the
exact device engine are float64 op for op, so everything is compared
exactly; the argmax engine compares the same fields (it keeps no tie sets
on either side: each rule's set is the rule itself). Also the pieces with no device in them
(``prune_tree``, ``BetweenDict``, the impurities, the bound, the metrics)
against their originals."""

import numpy as np
import pytest

from grm_tpu.learning import cart as jax_cart
from grm_tpu.learning.bounds import cart_bound as jax_cart_bound
from grm_tpu.learning.experiments import cart_experiment as jax_exp
from grm_tpu.learning.metrics import get_multiclass_metrics as jax_mc_metrics
from grm_tpu.learning.rules import (
    KmerRuleClassifications as JaxClassifications,
    LazyKmerRuleList as JaxRuleList,
)
from grm_tpu.dataset import GrmDataset as JaxDataset

from grm_tpu_torch.dataset import GrmDataset
from grm_tpu_torch.learning import cart as port_cart
from grm_tpu_torch.learning.bounds import cart_bound
from grm_tpu_torch.learning.experiments import cart_experiment as port_exp
from grm_tpu_torch.learning.experiments import learn_CART
from grm_tpu_torch.learning.metrics import get_multiclass_metrics
from grm_tpu_torch.learning.rules import (
    KmerRuleClassifications,
    LazyKmerRuleList,
)

from test_torch_learn_scm import _artifact, _norm_metrics, _rule_key, _s

ENGINES = ["host", "device", "device-argmax"]


def _tied_dense(seed, n_genomes=30, n_kmers=120, n_classes=2, mirror=True):
    """Random presence with planted markers at several noise levels, exact
    duplicates (impurity ties between identical columns) and, with
    ``mirror``, a complement (a column and its count-mirror)."""
    rng = np.random.RandomState(seed)
    dense = (rng.rand(n_genomes, n_kmers) > 0.5).astype(np.uint8)
    labels = rng.randint(0, n_classes, n_genomes)
    for c, noise in [(4, 3), (12, 6), (18, 9)]:
        col = (labels > 0).astype(np.uint8)
        flips = rng.choice(n_genomes, noise, replace=False)
        col[flips] = 1 - col[flips]
        dense[:, c] = col
    dense[:, 30] = dense[:, 4]
    dense[:, 31] = dense[:, 4]
    dense[:, 40] = dense[:, 12]
    if mirror:
        dense[:, 50] = 1 - dense[:, 4]
    return dense, labels


def _tree_fingerprint(node):
    if node.is_leaf:
        return ("leaf", int(node.class_prediction))
    return ("split", _rule_key(node.rule),
            _tree_fingerprint(node.left_child),
            _tree_fingerprint(node.right_child))


def _cart_fingerprint(out):
    best_hp, score, train_m, test_m, model, imps, equiv, cls = out
    ci = best_hp["class_importance"]
    return {
        "hp": (_s(best_hp["criterion"]),
               tuple(sorted((int(k), float(v)) for k, v in ci.items())),
               int(best_hp["max_depth"]),
               float(best_hp["min_samples_split"]),
               float(best_hp["pruning_alpha"])),
        "score": float(score),
        "tree": _tree_fingerprint(model.decision_tree),
        "tree_str": str(model),
        "importances": {_rule_key(r): float(v) for r, v in imps.items()},
        "equiv": {_rule_key(r): sorted(_rule_key(e) for e in eq)
                  for r, eq in equiv.items()},
        "train": _norm_metrics(train_m),
        "test": _norm_metrics(test_m),
        "cls": {k: sorted(_s(g) for g in v) for k, v in cls.items()},
    }


def _both(path, engine, **kwargs):
    want = _cart_fingerprint(jax_exp.learn_CART(
        dataset_file=path, engine=engine, **kwargs))
    got = _cart_fingerprint(learn_CART(
        dataset_file=path, engine=engine, device="cpu", **kwargs))
    return got, want


CV = dict(split_name="sp", criterion=["gini"], max_depth=[3],
          min_samples_split=[2],
          class_importance=[{0: 1.0, 1: 1.0}, {0: 0.5, 1: 1.0}],
          bound_delta=0.05, bound_max_genome_size=120,
          kmer_blacklist_file=None, parameter_selection="cv", n_cpu=1,
          authorized_rules="")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("criterion", ["gini", "cross-entropy"])
@pytest.mark.parametrize("seed", [2, 5])
def test_learn_cart_cv_matches_jax(tmp_path, seed, criterion, engine):
    dense, labels = _tied_dense(seed)
    path, _ = _artifact(tmp_path, dense, labels, "cv%d" % seed, seed)
    got, want = _both(path, engine, **dict(CV, criterion=[criterion]))
    assert got == want
    assert want["tree"][0] == "split"
    if engine == "host" and seed == 2:
        assert any(len(eq) > 1 for eq in want["equiv"].values())


@pytest.mark.parametrize("engine", ENGINES)
def test_learn_cart_bound_matches_jax(tmp_path, engine):
    dense, labels = _tied_dense(6)
    path, _ = _artifact(tmp_path, dense, labels, "bd", 6, n_folds=2)
    kwargs = dict(CV, criterion=["gini", "cross-entropy"],
                  parameter_selection="bound", bound_max_genome_size=1000)
    got, want = _both(path, engine, **kwargs)
    assert got == want
    assert 0.0 < want["score"] < 1.0


GRID = dict(CV, criterion=["gini", "cross-entropy"], max_depth=[1, 2, 4],
            min_samples_split=[2, 6])


@pytest.mark.parametrize("engine", ENGINES)
def test_learn_cart_grid_with_tied_scores_matches_jax(tmp_path, engine):
    """A grid of 24 combinations, several with the same CV score: the
    selection runs through train_tree's tie rule (smaller tree, then lower
    class-importance variance, and its quirk of keeping the earlier tree)."""
    dense, labels = _tied_dense(3)
    path, _ = _artifact(tmp_path, dense, labels, "grid", 3)
    got, want = _both(path, engine, **GRID)
    assert got == want


def test_grid_scores_do_tie(tmp_path):
    """The grid of the test above does reach the tie rule: two combinations
    score the same to np.isclose."""
    dense, labels = _tied_dense(3)
    path, _ = _artifact(tmp_path, dense, labels, "grid", 3)
    dataset = GrmDataset(path, device="cpu")
    scores = []
    for crit in GRID["criterion"]:
        for ci in GRID["class_importance"]:
            for depth in GRID["max_depth"]:
                hps = {"criterion": crit, "class_importance": ci,
                       "max_depth": depth, "min_samples_split": 2}
                scores.append(port_exp._learn_pruned_tree_cv(
                    hps, dataset, "sp", [])[1])
    best = min(scores)
    assert sum(np.isclose(s, best) for s in scores) >= 2


@pytest.mark.parametrize("engine", ENGINES)
def test_learn_cart_blacklist_matches_jax(tmp_path, engine):
    # 256 k-mers: grm_tpu's argmax scorer takes a blacklist only where the
    # k-mer count equals its padded matrix width (its mask is K long, its
    # scores padded-K long).
    dense, labels = _tied_dense(1, n_kmers=256)
    path, _ = _artifact(tmp_path, dense, labels, "bl", 1)
    base = _cart_fingerprint(learn_CART(dataset_file=path, engine=engine,
                                        device="cpu", **CV))
    banned = base["tree"][1][0]
    bl = tmp_path / "bl.txt"
    bl.write_text(banned + "\n")
    got, want = _both(path, engine,
                      **dict(CV, kmer_blacklist_file=str(bl)))
    assert got == want
    assert all(seq != banned for seq, _ in want["importances"])
    assert want["tree"] != base["tree"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("criterion", ["gini", "cross-entropy"])
def test_learn_cart_multiclass_matches_jax(tmp_path, criterion, engine):
    # No count-mirror column here: with three classes and cross-entropy,
    # XLA on the CPU scores a column and its mirror one ulp apart (the sum
    # of the two children is not symmetric once it is contracted), so
    # grm_tpu's argmax engine takes the mirror where the port, whose two
    # scores are equal, takes the lower column (ROADMAP.md, Queue 3).
    dense, labels = _tied_dense(4, n_genomes=36, n_classes=3, mirror=False)
    path, _ = _artifact(tmp_path, dense, labels, "mc", 4, n_folds=2)
    kwargs = dict(CV, criterion=[criterion],
                  class_importance=[{0: 1.0, 1: 1.0, 2: 1.0}])
    got, want = _both(path, engine, **kwargs)
    assert got == want
    assert "confusion_matrix" in want["test"]


def test_exact_engine_and_mesh_raise_instead_of_switching(tmp_path,
                                                          monkeypatch):
    """No engine quietly runs another: the exact engine serves its own
    frontiers (and gives the host engine's model), and a mesh of another
    device type than the run's raises instead of moving the run there."""
    from grm_tpu_torch.parallel import cart_exact, cart_forest

    dense, labels = _tied_dense(2)
    path, _ = _artifact(tmp_path, dense, labels, "ex", 2)
    served = []
    orig = cart_exact.cart_frontier_candidates

    def spy(*args, **kwargs):
        served.append(len(args[1]))
        return orig(*args, **kwargs)

    monkeypatch.setattr(cart_forest, "cart_frontier_candidates", spy)
    got = _cart_fingerprint(learn_CART(dataset_file=path, engine="device",
                                       device="cpu", **CV))
    assert served and sum(served) > 0
    assert got == _cart_fingerprint(learn_CART(dataset_file=path,
                                               engine="host", device="cpu",
                                               **CV))
    import torch

    from grm_tpu_torch.parallel.mesh import make_mesh

    cuda = make_mesh(2, devices=[torch.device("cuda", 0)] * 2)
    for engine in ("host", "device"):
        with pytest.raises(ValueError, match="mesh"):
            learn_CART(dataset_file=path, engine=engine, mesh=cuda,
                       device="cpu", **CV)
    cpu = make_mesh(2, devices=[torch.device("cpu")] * 2)
    tree = port_cart.DecisionTreeClassifier("gini", 3, 2, {0: 1.0, 1: 1.0},
                                            engine="device", mesh=cpu)
    assert tree.mesh == cpu
    with pytest.raises(ValueError):
        learn_CART(dataset_file=path, engine="gpu", device="cpu", **CV)


def test_deferred_equiv_raises_if_one_turns_up(tmp_path):
    """A deferred equivalence set that turns up on the chosen tree resolves
    to the set the host engine computes at once (the root split's winning
    tuple at the largest train occurrence); with nothing deferred the
    resolver does nothing."""
    dense, labels = _tied_dense(2)
    path, _ = _artifact(tmp_path, dense, labels, "de", 2)
    model = learn_CART(dataset_file=path, engine="host", device="cpu",
                       **CV)[4]
    dataset = GrmDataset(path, device="cpu")
    root = model.decision_tree
    want = np.asarray(root.rule.equivalent_rules_idx)
    port_exp._resolve_deferred_equiv(dataset, "sp", root, [])
    np.testing.assert_array_equal(root.rule.equivalent_rules_idx, want)
    assert len(want) > 1
    # The spec of the root split: its tuple of left counts (one key), at the
    # train occurrence its equivalent columns share.
    x = dataset.get_matrix_columns(want)
    classes = sorted(root.class_examples_idx)
    n_node = [len(root.class_examples_idx[c]) for c in classes]
    keys = np.zeros(len(want), np.int64)
    for c, n in zip(classes, n_node):
        keys = keys * (n + 1) + x[root.class_examples_idx[c]].sum(0)
    train = dataset.get_split("sp").train_genome_idx
    occ = x[train].sum(0)
    assert len(set(occ.tolist())) == 1
    root.rule.equivalent_rules_idx = port_cart.DeferredEquiv(
        np.unique(keys), int(occ[0]))
    port_exp._resolve_deferred_equiv(dataset, "sp", root, [])
    np.testing.assert_array_equal(root.rule.equivalent_rules_idx, want)


def _grown_trees(path, criterion):
    """The same overgrown tree from both packages' host learners."""
    trees = []
    for dataset, rules_cls, rc_cls, mod in (
            (JaxDataset(path), JaxRuleList, JaxClassifications, jax_cart),
            (GrmDataset(path, device="cpu"), LazyKmerRuleList,
             KmerRuleClassifications, port_cart)):
        labels = dataset.phenotype.metadata
        train = dataset.get_split("sp").train_genome_idx
        clf = mod.DecisionTreeClassifier(criterion, 6, 2, {0: 1.0, 1: 1.0})
        clf.fit(rules_cls(dataset), rc_cls(dataset),
                {c: train[labels[train] == c] for c in (0, 1)})
        trees.append(clf.decision_tree)
    return trees


@pytest.mark.parametrize("criterion", ["gini", "cross-entropy"])
def test_prune_tree_matches_original(tmp_path, criterion):
    dense, labels = _tied_dense(7, n_genomes=40)
    path, _ = _artifact(tmp_path, dense, labels, "pr", 7)
    jax_tree, port_tree = _grown_trees(path, criterion)
    assert str(port_tree) == str(jax_tree)
    want_alphas, want_trees = jax_cart.prune_tree(jax_tree)
    assert len(want_alphas) > 2
    # The port's pruning of its own tree, and of the original's tree.
    for tree in (port_tree, jax_tree):
        alphas, trees = port_cart.prune_tree(tree)
        assert list(alphas) == list(want_alphas)
        assert [str(t) for t in trees] == [str(t) for t in want_trees]


def test_between_dict_matches_original():
    pairs = [((0.0, 0.1), "a"), ((0.1, 0.5), "b"), ((0.5, np.inf), "c"),
             ((-np.inf, 0.0), "z")]
    got, want = port_exp.BetweenDict(), jax_exp.BetweenDict()
    for key, value in pairs:
        got[key] = value
        want[key] = value
    for probe in (-3.0, 0.0, 0.05, 0.1, 0.4999, 0.5, 7.0, np.inf):
        assert got[probe] == want[probe]
        assert (probe in got) == (probe in want)
    assert port_exp.BetweenDict({(1, 2): "x"})[1.5] == "x"
    assert 2 not in port_exp.BetweenDict({(1, 2): "x"})
    for bad in ((1,), (2, 1), (1, 1)):
        for cls in (port_exp.BetweenDict, jax_exp.BetweenDict):
            with pytest.raises((ValueError, RuntimeError)):
                cls()[bad] = 0


@pytest.mark.parametrize("criterion", ["gini", "cross-entropy"])
def test_impurities_equal_originals_bit_for_bit(criterion):
    rng = np.random.RandomState(11)
    priors = {0: 0.2, 1: 0.5, 2: 0.3}
    totals = {0: 17.0, 1: 40.0, 2: 23.0}
    node_n = {0: 9, 1: 0, 2: 14}
    left = {c: rng.randint(0, node_n[c] + 1, 500) for c in node_n}
    got = port_cart.score_candidates_f64(criterion, priors, totals, node_n,
                                         left)
    want = jax_cart.score_candidates_f64(criterion, priors, totals, node_n,
                                         left)
    np.testing.assert_array_equal(got, want)
    counts = {c: left[c].astype(np.float64) for c in (0, 2)}
    for flag in (False, True):
        with np.errstate(divide="ignore", invalid="ignore"):
            np.testing.assert_array_equal(
                port_cart.gini_impurity(priors, totals, counts, flag),
                jax_cart.gini_impurity(priors, totals, counts, flag))
            np.testing.assert_array_equal(
                port_cart.cross_entropy(priors, totals, counts, flag),
                jax_cart.cross_entropy(priors, totals, counts, flag))


def test_blacklist_to_exclusion_mask_matches_original():
    for bl in (None, [], [3, 7], [3, 7, 13, 17], [3, 14], [12]):
        got = port_cart.device_excl_from_blacklist(bl, 10)
        want = jax_cart.device_excl_from_blacklist(bl, 10)
        assert got[1] == want[1]
        assert (got[0] is None) == (want[0] is None)
        if want[0] is not None:
            np.testing.assert_array_equal(got[0], want[0])


def test_argmax_engine_refuses_an_absence_rule_blacklist(tmp_path):
    """A blacklist with an absence rule that lacks its presence rule has no
    column mask: the argmax engine raises instead of scoring on the host;
    a presence/absence pair masks the presence rule's column."""
    dense, labels = _tied_dense(2)
    path, _ = _artifact(tmp_path, dense, labels, "ab", 2)
    dataset = GrmDataset(path, device="cpu")
    n_kmers = dense.shape[1]
    train = dataset.get_split("sp").train_genome_idx
    y = dataset.phenotype.metadata
    example_idx = {c: train[y[train] == c] for c in (0, 1)}

    def fit(engine, blacklist):
        clf = port_cart.DecisionTreeClassifier("gini", 3, 2, {0: 1.0, 1: 1.0},
                                               engine=engine)
        clf.fit(LazyKmerRuleList(dataset), KmerRuleClassifications(dataset),
                example_idx, rule_blacklist=blacklist)
        return clf.decision_tree

    with pytest.raises(ValueError, match="device-argmax"):
        fit("device-argmax", [n_kmers + 4])
    paired = fit("device-argmax", [4, n_kmers + 4])
    assert str(paired) == str(fit("host", [4]))


def test_multiclass_metrics_and_bound_equal_originals(tmp_path):
    rng = np.random.RandomState(5)
    answers = rng.randint(0, 3, 40).astype(np.uint8)
    predictions = rng.randint(0, 3, (4, 40))
    assert dict(get_multiclass_metrics(predictions, answers, 3)) == dict(
        jax_mc_metrics(predictions, answers, 3))

    dense, labels = _tied_dense(2)
    path, _ = _artifact(tmp_path, dense, labels, "bnd", 2)
    jax_tree, port_tree = _grown_trees(path, "gini")
    train = JaxDataset(path).get_split("sp").train_genome_idx
    preds = rng.randint(0, 2, len(train))
    truth = rng.randint(0, 2, len(train))
    common = dict(train_predictions=preds, train_answers=truth,
                  train_example_idx=train, delta=0.05, max_genome_size=1000,
                  n_classes=2)
    assert cart_bound(
        model=port_tree, rule_classifications=KmerRuleClassifications(
            GrmDataset(path, device="cpu")), **common
    ) == jax_cart_bound(
        model=jax_tree,
        rule_classifications=JaxClassifications(JaxDataset(path)), **common)
