"""The port's exact CART engine (``learn_CART(engine="device")`` on the CPU,
through the plain PyTorch versions of the ``cart_exact`` kernels) against
``grm_tpu``'s (XLA on the CPU, no Pallas on its path) and against the port's
host engine, case by case as ``tests/test_cart_exact.py`` holds ``grm_tpu``'s
device engine to its host engine.

The three ``learn_CART`` fingerprints (hyperparameters with the pruning
alpha, CV score, tree, rules, equivalence sets, importances, metrics and
classifications) must be equal exactly. Tuple-regime payloads of
``cart_frontier_candidates`` must equal ``grm_tpu``'s field for field, and
the winner's bits must be its matrix column. In the gather regime, the
float64 tie set after the tree's replay must be equal and the port's
candidate pool must cover it; the pools themselves may differ at the
margin's edge, because XLA on the CPU contracts the float32 scores into
fused multiply-adds and the port does not (ROADMAP.md, Queue 3).

Below them, the plain versions of ``ops/cart_exact.py`` against a numpy
brute force: the tuple tables, the key decode, the ascending compaction,
excluded and padded columns, and a node whose every valid column passes.
"""

import numpy as np
import pytest
import torch

from grm_tpu.dataset import GrmDataset as JaxDataset
from grm_tpu.learning.cart import DecisionTreeClassifier as JaxTree
from grm_tpu.learning.experiments.cart_experiment import (
    learn_CART as jax_learn_CART,
)
from grm_tpu.learning.rules import (
    KmerRuleClassifications as JaxClassifications,
    LazyKmerRuleList as JaxRuleList,
)
from grm_tpu.ops.popcount import BitMatrix as JaxBitMatrix
from grm_tpu.parallel.cart_exact import (
    cart_frontier_candidates as jax_candidates,
)

from grm_tpu_torch.dataset import GrmDataset
from grm_tpu_torch.learning import cart as port_cart
from grm_tpu_torch.learning import rules as port_rules
from grm_tpu_torch.learning.experiments import learn_CART
from grm_tpu_torch.ops import cart_exact as ce
from grm_tpu_torch.ops.cart_sweep import NO_COLUMN
from grm_tpu_torch.ops.popcount import BitMatrix
from grm_tpu_torch.parallel.cart_exact import (
    S_MAX,
    cart_frontier_candidates,
    resolve_equiv_specs,
)
from grm_tpu_torch.utils import unpack_binary_bytes_from_ints

from test_cart_exact import _tied_cart_dataset, _write_ds
from test_torch_learn_cart import _cart_fingerprint

CRITERIA = ["gini", "cross-entropy"]


def _three_ways(ds, **kwargs):
    """(grm_tpu device, port device, port host) fingerprints."""
    kwargs = dict(dataset_file=ds, split_name="sp", **kwargs)
    jax_dev = _cart_fingerprint(jax_learn_CART(engine="device", **kwargs))
    dev = _cart_fingerprint(learn_CART(engine="device", device="cpu",
                                       **kwargs))
    host = _cart_fingerprint(learn_CART(engine="host", device="cpu",
                                        **kwargs))
    return jax_dev, dev, host


def _assert_three_equal(ds, **kwargs):
    jax_dev, dev, host = _three_ways(ds, **kwargs)
    assert dev == jax_dev
    assert dev == host
    return dev


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("criterion", CRITERIA)
def test_exact_engine_matches_jax_and_host_cv(tmp_path, seed, criterion):
    ds = _tied_cart_dataset(tmp_path, seed, "c%d%s" % (seed, criterion[:1]))
    fp = _assert_three_equal(
        ds, criterion=[criterion], max_depth=[3], min_samples_split=[2],
        class_importance=[{0: 1.0, 1: 1.0}, {0: 0.5, 1: 1.0}],
        parameter_selection="cv")
    # the engineered duplicates must actually produce equivalence sets
    assert any(len(v) > 1 for v in fp["equiv"].values()) or seed != 0


def test_exact_engine_matches_jax_and_host_bound(tmp_path):
    ds = _tied_cart_dataset(tmp_path, 7, "cb")
    _assert_three_equal(
        ds, criterion=["gini"], max_depth=[3], min_samples_split=[2],
        class_importance=[{0: 1.0, 1: 1.0}], parameter_selection="bound",
        bound_delta=0.05, bound_max_genome_size=1000)


def test_exact_engine_presence_only_blacklist(tmp_path, monkeypatch):
    """The CART blacklist (presence indices only) maps to the device's column
    exclusion: the exact engine never runs the host scorer's count sweeps."""
    ds = _tied_cart_dataset(tmp_path, 9, "cbl")
    dataset = JaxDataset(ds)
    seqs = [s.decode() for s in dataset.kmer_sequences]
    kmer = seqs[int(dataset.kmer_by_matrix_column[5])]
    bl = tmp_path / "bl.txt"
    bl.write_text(kmer + "\n")
    kwargs = dict(criterion=["gini"], max_depth=[2], min_samples_split=[2],
                  class_importance=[{0: 1.0, 1: 1.0}],
                  parameter_selection="cv", kmer_blacklist_file=str(bl))
    jax_dev, _, host = _three_ways(ds, **kwargs)
    calls = []
    orig = port_rules.KmerRuleClassifications.presence_counts

    def counting(self, rows_list):
        calls.append(len(rows_list))
        return orig(self, rows_list)

    monkeypatch.setattr(port_rules.KmerRuleClassifications, "presence_counts",
                        counting)
    dev = _cart_fingerprint(learn_CART(
        dataset_file=ds, split_name="sp", engine="device", device="cpu",
        **kwargs))
    assert dev == jax_dev == host
    assert not calls, "the exact engine ran the host scorer's sweeps"
    assert all(seq != kmer for seq, _ in dev["importances"])


def test_exact_engine_occurrence_tiebreak_equivalence_sets(tmp_path):
    """Two perfect root splits with identical impurity: both columns are the
    chosen split's equivalent rules."""
    n_genomes = 24
    labels = np.zeros(n_genomes, np.uint8)
    labels[12:] = 1
    rng = np.random.RandomState(4)
    dense = (rng.rand(n_genomes, 30) > 0.5).astype(np.uint8)
    dense[:, 2] = labels
    dense[:, 9] = labels
    ds = _write_ds(tmp_path, dense, labels, "occ", n_folds=2, seed=2)
    fp = _assert_three_equal(
        ds, criterion=["gini"], max_depth=[2], min_samples_split=[2],
        class_importance=[{0: 1.0, 1: 1.0}], parameter_selection="cv")
    assert any(len(v) >= 2 for v in fp["equiv"].values())


@pytest.mark.parametrize("criterion", CRITERIA)
def test_exact_engine_multiclass(tmp_path, criterion):
    rng = np.random.RandomState(6)
    n_genomes, n_kmers = 36, 50
    dense = (rng.rand(n_genomes, n_kmers) > 0.5).astype(np.uint8)
    labels = (np.arange(n_genomes) % 3).astype(np.uint8)
    for c, cls in [(4, 0), (11, 1), (19, 2)]:
        col = (labels == cls).astype(np.uint8)
        flips = rng.choice(n_genomes, 4, replace=False)
        col[flips] = 1 - col[flips]
        dense[:, c] = col
    ds = _write_ds(tmp_path, dense, labels, "mc", n_folds=2, seed=6)
    fp = _assert_three_equal(
        ds, criterion=[criterion], max_depth=[3], min_samples_split=[2],
        class_importance=[{0: 1.0, 1: 1.0, 2: 1.0}],
        parameter_selection="cv")
    assert "confusion_matrix" in fp["test"]


def _identity_tiebreak_case(tmp_path):
    """tests/test_cart_exact.py's identity-tiebreak data: at a depth-1 node
    columns 20 and 40 have the same left-count tuple but different
    occurrences, so the identity tiebreak (lowest column) and the
    occurrence tiebreak disagree."""
    n_genomes = 24
    labels = np.zeros(n_genomes, np.uint8)
    labels[12:] = 1
    rng = np.random.RandomState(4)
    dense = (rng.rand(n_genomes, 60) > 0.5).astype(np.uint8)
    root = labels.copy()
    root[[0, 23]] ^= 1
    dense[:, 5] = root
    node = np.where(root == 1)[0]
    off = np.where(root == 0)[0]
    pattern = np.zeros(n_genomes, np.uint8)
    pattern[node[labels[node] == 1]] = 1
    dense[:, 20] = pattern
    dense[off[:6], 20] = 1
    dense[:, 40] = pattern.copy()
    dense[off, 40] = 1
    return _write_ds(tmp_path, dense, labels, "idtb", n_folds=2, seed=2)


def _fit_rules(mod, dataset, rules_cls, rc_cls, engine, **fit_kwargs):
    labels = dataset.phenotype.metadata
    idx = np.arange(len(labels))
    clf = mod(criterion="gini", max_depth=2, min_samples_split=2,
              class_importance={0: 1.0, 1: 1.0}, engine=engine)
    clf.fit(rules_cls(dataset), rc_cls(dataset),
            {c: idx[labels == c] for c in range(2)}, **fit_kwargs)
    return [(r.kmer_index, r.type) for r in clf.decision_tree.rules]


def test_exact_engine_identity_tiebreaker(tmp_path):
    """fit() without a tiebreaker takes the identity default (the first
    candidate, regardless of occurrences); the exact engine replays that."""
    ds = _identity_tiebreak_case(tmp_path)
    port_ds = GrmDataset(ds, device="cpu")
    port = [_fit_rules(port_cart.DecisionTreeClassifier, port_ds,
                       port_rules.LazyKmerRuleList,
                       port_rules.KmerRuleClassifications, engine)
            for engine in ("host", "device")]
    want = _fit_rules(JaxTree, JaxDataset(ds), JaxRuleList,
                      JaxClassifications, "device")
    assert port[0] == port[1] == want
    assert any(k in (20, 40) for k, _ in want)


def test_exact_engine_refuses_a_custom_tiebreaker(tmp_path):
    """A custom tiebreaker that is not the reference's rule cannot be
    replayed on the host: a loud error, as in grm_tpu."""
    ds = _identity_tiebreak_case(tmp_path)
    with pytest.raises(ValueError, match="tiebreaker"):
        _fit_rules(port_cart.DecisionTreeClassifier,
                   GrmDataset(ds, device="cpu"), port_rules.LazyKmerRuleList,
                   port_rules.KmerRuleClassifications, "device",
                   tiebreaker=lambda idx: idx[::-1])
    with pytest.raises(ValueError, match="tiebreaker"):
        _fit_rules(JaxTree, JaxDataset(ds), JaxRuleList, JaxClassifications,
                   "device", tiebreaker=lambda idx: idx[::-1])


def _norm_payload(p):
    if p is None:
        return None
    spec = p.get("equiv_spec")
    return {"winner": int(p["winner"]),
            "equiv": None if p.get("equiv") is None
            else [int(x) for x in p["equiv"]],
            "equiv_spec": None if spec is None
            else ([int(x) for x in spec[0]], int(spec[1]))}


def _assert_winner_bits(payloads, dense):
    for p in payloads:
        if p is None or "winner" not in p:
            continue
        bits = unpack_binary_bytes_from_ints(
            np.asarray(p["winner_bits"], np.uint32))[:dense.shape[0]]
        np.testing.assert_array_equal(bits, dense[:, p["winner"]])


def test_tuple_payloads_with_forty_tied_markers(tmp_path):
    """tests/test_cart_exact.py's escalation data: two perfect-split tuples
    (labels and their complement), each over 20 columns, so the minimum tie
    set holds two tuples and the equivalence set spans up to 40 columns
    (grm_tpu escalates its tuple budget of 1 there; the port has no budget).
    """
    rng = np.random.RandomState(3)
    n_genomes, n_kmers = 30, 400
    dense = (rng.rand(n_genomes, n_kmers) > 0.5).astype(np.uint8)
    labels = (rng.rand(n_genomes) > 0.5).astype(np.uint8)
    for c in range(40, 60):
        dense[:, c] = labels
    for c in range(60, 80):
        dense[:, c] = 1 - labels
    idx = np.arange(n_genomes)
    node = {0: idx[labels == 0], 1: idx[labels == 1]}
    priors = {0: 0.5, 1: 0.5}
    totals = {0: float(len(node[0])), 1: float(len(node[1]))}
    want = jax_candidates(JaxBitMatrix.from_dense(dense), [node], priors,
                          totals, "gini", [idx])
    want_tiny = jax_candidates(JaxBitMatrix.from_dense(dense), [node],
                               priors, totals, "gini", [idx],
                               tuple_budget=1)
    got = cart_frontier_candidates(BitMatrix.from_dense(dense, device="cpu"),
                                   [node], priors, totals, "gini", [idx])
    assert _norm_payload(got[0]) == _norm_payload(want[0]) \
        == _norm_payload(want_tiny[0])
    n1, n0 = int(labels.sum()), int((1 - labels).sum())
    expected = (list(range(40, 60)) if n1 > n0 else list(range(60, 80))
                if n0 > n1 else list(range(40, 80)))
    assert list(got[0]["equiv"]) == expected
    assert got[0]["winner"] == min(expected)
    _assert_winner_bits(got, dense)


def _forest_frontier(seed, n_genomes=40, n_kmers=300):
    """A frontier of nodes from three trees of a forest (different train
    sets and priors), with duplicated markers for ties and a node that no
    rule splits."""
    rng = np.random.RandomState(seed)
    dense = (rng.rand(n_genomes, n_kmers) > 0.5).astype(np.uint8)
    labels = (rng.rand(n_genomes) > 0.5).astype(np.int64)
    for c in (7, 8, 9, 150):
        dense[:, c] = labels
    dense[:, 151] = dense[:, 3]
    idx = np.arange(n_genomes)
    trains = [idx[idx % 3 != f] for f in range(2)] + [idx]
    nodes, priors, totals, train_of = [], [], [], []
    for t, train in enumerate(trains):
        by_class = {c: train[labels[train] == c] for c in (0, 1)}
        tot = {c: float(len(by_class[c])) for c in (0, 1)}
        pri = {0: 0.4 + 0.1 * t, 1: 0.6 - 0.1 * t}
        rows = [by_class,
                {c: v[v < n_genomes // 2] for c, v in by_class.items()},
                {c: v[dense[v, 3] == 1] for c, v in by_class.items()},
                {0: by_class[0][:1], 1: by_class[1][:0]}]
        for r in rows:
            nodes.append(r)
            priors.append(pri)
            totals.append(tot)
            train_of.append(train)
    return dense, nodes, priors, totals, train_of


@pytest.mark.parametrize("criterion", CRITERIA)
def test_tuple_payloads_of_a_forest_frontier(criterion):
    """Nodes of different trees carry different train masks and priors;
    per-node options vary too (equivalence sets now, deferred, or none;
    occurrence or identity tiebreak)."""
    dense, nodes, priors, totals, trains = _forest_frontier(5)
    n = len(nodes)
    opts = dict(need_equiv=[i % 3 != 2 for i in range(n)],
                occ_tiebreak=[i % 4 != 1 for i in range(n)],
                defer_equiv=[i % 2 == 1 for i in range(n)])
    want = jax_candidates(JaxBitMatrix.from_dense(dense), nodes, priors,
                          totals, criterion, trains, **opts)
    bm = BitMatrix.from_dense(dense, device="cpu")
    got = cart_frontier_candidates(bm, nodes, priors, totals, criterion,
                                   trains, **opts)
    assert [_norm_payload(p) for p in got] == [_norm_payload(p) for p in want]
    assert got[3] is None  # one example: no rule splits it
    assert sum(p is not None and p.get("equiv_spec") is not None
               for p in got) >= 2
    _assert_winner_bits(got, dense)
    # The deferred sets resolve to what the immediate compaction gives.
    deferred = [i for i, p in enumerate(got)
                if p is not None and p.get("equiv_spec") is not None]
    sets = resolve_equiv_specs(bm, [nodes[i] for i in deferred],
                               [trains[i] for i in deferred],
                               [got[i]["equiv_spec"] for i in deferred])
    now = cart_frontier_candidates(
        bm, [nodes[i] for i in deferred], [priors[i] for i in deferred],
        [totals[i] for i in deferred], criterion,
        [trains[i] for i in deferred],
        occ_tiebreak=[opts["occ_tiebreak"][i] for i in deferred])
    for s, p in zip(sets, now):
        np.testing.assert_array_equal(s, p["equiv"])


def test_gather_regime_tie_set_is_covered(tmp_path):
    """600 genomes: the root's count lattice (301 x 301) passes S_MAX, so the
    node takes the gather regime; the float64 tie set after the tree's
    replay equals grm_tpu's, and the port's pool covers it."""
    rng = np.random.RandomState(9)
    n_genomes, n_kmers = 600, 120
    dense = (rng.rand(n_genomes, n_kmers) > 0.5).astype(np.uint8)
    labels = (np.arange(n_genomes) >= 300).astype(np.uint8)
    col = labels.copy()
    col[rng.choice(n_genomes, 30, replace=False)] ^= 1
    dense[:, 7] = col
    dense[:, 8] = dense[:, 7]
    idx = np.arange(n_genomes)
    node = {0: idx[labels == 0], 1: idx[labels == 1]}
    assert (len(node[0]) + 1) * (len(node[1]) + 1) > S_MAX
    priors = {0: 0.5, 1: 0.5}
    totals = {0: 300.0, 1: 300.0}
    want = jax_candidates(JaxBitMatrix.from_dense(dense), [node], priors,
                          totals, "gini", [idx])[0]
    got = cart_frontier_candidates(BitMatrix.from_dense(dense, device="cpu"),
                                   [node], priors, totals, "gini", [idx])[0]
    assert set(got) == {"cols", "left", "occ"}

    def tie_set(p):
        vals = port_cart.score_candidates_f64(
            "gini", priors, totals, {c: len(v) for c, v in node.items()},
            p["left"])
        tie = vals == vals.min()
        return list(p["cols"][tie]), list(p["occ"][tie])

    assert tie_set(got) == tie_set(want)
    assert tie_set(got)[0] == [7, 8]
    # Every candidate's counts and occurrence are its column's.
    for cl in (0, 1):
        np.testing.assert_array_equal(
            got["left"][cl], dense[node[cl]][:, got["cols"]].sum(0))
    np.testing.assert_array_equal(got["occ"], dense[:, got["cols"]].sum(0))
    assert np.all(np.diff(got["cols"]) > 0)


def test_exact_engine_unsplittable_impure_node(tmp_path):
    """An impure node whose every column is constant is a leaf on every
    engine (the payload is None)."""
    rng = np.random.RandomState(11)
    dense = np.zeros((24, 40), np.uint8)
    labels = (rng.rand(24) > 0.5).astype(np.uint8)
    if labels.min() == labels.max():
        labels[0] = 1 - labels[0]
    ds = _write_ds(tmp_path, dense, labels, "unsplit", seed=11)
    fp = _assert_three_equal(
        ds, criterion=["gini"], max_depth=[3], min_samples_split=[2],
        class_importance=[{0: 1.0, 1: 1.0}], parameter_selection="cv")
    assert fp["tree"] == ("leaf", fp["tree"][1])


def test_exact_engine_refuses_an_absence_rule_blacklist(tmp_path):
    """As the argmax engine: a blacklist with an absence rule that lacks its
    presence rule has no column mask, so the exact engine raises instead of
    scoring on the host."""
    ds = _identity_tiebreak_case(tmp_path)
    with pytest.raises(ValueError, match="'device'"):
        _fit_rules(port_cart.DecisionTreeClassifier,
                   GrmDataset(ds, device="cpu"), port_rules.LazyKmerRuleList,
                   port_rules.KmerRuleClassifications, "device",
                   rule_blacklist=[60 + 4])


# -- the plain versions of ops/cart_exact.py against numpy ---------------------

def _brute(dense, nodes, train, excl, limit):
    """numpy per (node, column): class counts, occurrence and validity."""
    left = np.stack([np.stack([dense[idx].sum(0) for idx in node])
                     for node in nodes]).astype(np.int64)  # (N, C, K)
    occ = np.stack([dense[t].sum(0) for t in train]).astype(np.int64)
    valid = np.arange(dense.shape[1]) < limit
    if excl is not None:
        valid &= ~excl
    return left, occ, valid


def _ops_case(seed, n_genomes=70, n_kmers=333, c=2, n=5):
    rng = np.random.RandomState(seed)
    dense = (rng.rand(n_genomes, n_kmers) > 0.4).astype(np.uint8)
    nodes, train = [], []
    for i in range(n):
        pick = np.where(rng.rand(n_genomes) < 0.15 + 0.15 * i)[0]
        owner = rng.randint(0, c, len(pick))
        nodes.append([pick[owner == ci] for ci in range(c)])
        train.append(np.where(rng.rand(n_genomes) < 0.7)[0])
    # the last node: two examples, one a class, so every valid split of it
    # falls on one of two keys (the all-hit node)
    nodes[-1] = [np.array([0]), np.array([1])] + [
        np.array([], np.int64)] * (c - 2)
    excl = rng.rand(n_kmers) < 0.1
    bm = BitMatrix.from_dense(dense, device="cpu")
    w = bm.n_words
    from grm_tpu_torch.parallel.scm_device import build_packed_mask
    masks = np.stack([np.stack([build_packed_mask(idx, n_genomes, w)
                                for idx in node]) for node in nodes])
    tmask = np.stack([build_packed_mask(t, n_genomes, w) for t in train])
    n_node = np.array([[len(idx) for idx in node] for node in nodes],
                      np.int32)
    scale = (rng.rand(n, c) + 0.1).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (dense, nodes, train, excl, bm.data,
            t(masks.view(np.int32)), t(tmask.view(np.int32)), t(n_node),
            t(scale))


def _f32_scores(left, n_node, scale, criterion):
    """The plain versions' float32 split scores, in numpy float32 with the
    same operations in the same order."""
    right = n_node[:, :, None] - left
    sc = scale[:, :, None]

    def child(cnt):
        p = (sc * cnt.astype(np.float32)).astype(np.float32)
        p_t = p[:, 0]
        for ci in range(1, p.shape[1]):
            p_t = p_t + p[:, ci]
        with np.errstate(divide="ignore", invalid="ignore"):
            if criterion == "gini":
                sq = p[:, 0] * p[:, 0]
                for ci in range(1, p.shape[1]):
                    sq = sq + p[:, ci] * p[:, ci]
                return np.where(p_t > 0, (p_t * p_t - sq) / p_t,
                                np.float32(0))
            ent = np.zeros_like(p_t)
            for ci in range(p.shape[1]):
                frac = np.where(p_t > 0, p[:, ci] / p_t, np.float32(0))
                ent = ent - np.where(frac > 0, frac * np.log(frac),
                                     np.float32(0))
            return ent * p_t

    return (child(left) + child(right)).astype(np.float32)


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("criterion", CRITERIA)
def test_plain_tuple_tables_against_numpy(c, criterion):
    (dense, nodes, train, excl, matrix, masks, tmask, n_node,
     scale) = _ops_case(c, c=c)
    limit = dense.shape[1] - 4
    left, occ, valid = _brute(dense, nodes, train, excl, limit)
    nn = n_node.numpy()
    score = _f32_scores(left, nn, scale.numpy(), criterion)
    nonempty = (left.sum(1) > 0) & ((nn[:, :, None] - left).sum(1) > 0)
    # Thresholds: each node's least valid score, plus a little; the last
    # node passes every valid split.
    best = np.where(valid & nonempty, score, np.inf).min(1)
    thresh = (best + 0.01).astype(np.float32)
    thresh[-1] = np.inf
    occ_tab, col_tab, off = ce.cart_exact_tuples(
        matrix, masks, tmask, n_node, scale, torch.from_numpy(thresh),
        criterion, limit, excl=torch.from_numpy(excl.astype(np.uint8)))
    off = off.numpy()
    sizes = np.prod(nn.astype(np.int64) + 1, axis=1)
    np.testing.assert_array_equal(off,
                                  np.concatenate([[0], sizes.cumsum()[:-1]]))
    want_occ = np.zeros(sizes.sum(), np.int64)
    want_col = np.full(sizes.sum(), NO_COLUMN, np.int64)
    hit = valid & nonempty & (score <= thresh[:, None])
    for i in range(len(nodes)):
        for k in np.where(hit[i])[0]:
            key = 0
            for ci in range(c):
                key = key * (nn[i, ci] + 1) + left[i, ci, k]
            e = off[i] + key
            want_occ[e] = max(want_occ[e],
                              ((occ[i, k] + 1) << 32) | (0xFFFFFFFF - k))
            want_col[e] = min(want_col[e], k)
    np.testing.assert_array_equal(occ_tab.numpy(), want_occ)
    np.testing.assert_array_equal(col_tab.numpy(), want_col)
    # The compacted rows, and the keys decoded back to counts.
    node, key, occmax, cocc, cany = [r.numpy() for r in ce.table_rows(
        occ_tab, col_tab, torch.from_numpy(off))]
    present = np.where(want_occ > 0)[0]
    np.testing.assert_array_equal(off[node] + key, present)
    np.testing.assert_array_equal(occmax, (want_occ[present] >> 32) - 1)
    np.testing.assert_array_equal(cany, want_col[present])
    for i in range(len(nodes)):
        sel = node == i
        lefts = ce.decode_keys(key[sel], nn[i])
        for k_, col in zip(range(sel.sum()), cocc[sel]):
            assert hit[i, col]
            assert [lefts[ci][k_] for ci in range(c)] == list(left[i, :, col])
            assert occ[i, col] == occmax[sel][k_]
    # The all-hit node: every valid non-empty split folds in.
    assert hit[-1].sum() == (valid & nonempty[-1]).sum() > 0


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("criterion", CRITERIA)
def test_plain_gather_compaction_against_numpy(c, criterion):
    (dense, nodes, train, excl, matrix, masks, tmask, n_node,
     scale) = _ops_case(10 + c, c=c)
    limit = dense.shape[1] - 7
    left, occ, valid = _brute(dense, nodes, train, excl, limit)
    nn = n_node.numpy()
    score = _f32_scores(left, nn, scale.numpy(), criterion)
    nonempty = (left.sum(1) > 0) & ((nn[:, :, None] - left).sum(1) > 0)
    thresh = np.quantile(np.where(valid & nonempty, score, 9.0), 0.3,
                         axis=1).astype(np.float32)
    thresh[-1] = np.inf
    starts, cols, lft, oc = ce.cart_exact_select(
        matrix, masks, tmask, n_node, scale, criterion, limit, "gather",
        thresh=torch.from_numpy(thresh),
        excl=torch.from_numpy(excl.astype(np.uint8)))
    starts, cols, lft, oc = (x.numpy() for x in (starts, cols, lft, oc))
    hit = valid & nonempty & (score <= thresh[:, None])
    for i in range(len(nodes)):
        got = cols[starts[i]:starts[i + 1]]
        np.testing.assert_array_equal(got, np.where(hit[i])[0])
        np.testing.assert_array_equal(lft[:, starts[i]:starts[i + 1]],
                                      left[i][:, got])
        np.testing.assert_array_equal(oc[starts[i]:starts[i + 1]],
                                      occ[i, got])
        assert not excl[got].any() and (got < limit).all()
    assert starts[-1] - starts[-2] == (valid & nonempty[-1]).sum()


@pytest.mark.parametrize("c", [2, 3])
def test_plain_equiv_compaction_against_numpy(c):
    (dense, nodes, train, excl, matrix, masks, tmask, n_node,
     scale) = _ops_case(20 + c, c=c)
    limit = dense.shape[1] - 2
    left, occ, valid = _brute(dense, nodes, train, excl, limit)
    nn = n_node.numpy()
    rng = np.random.RandomState(c)
    keys = np.zeros(left.shape[::2], np.int64)
    for ci in range(c):
        keys = keys * (nn[:, ci, None] + 1) + left[:, ci]
    key_sets, occmax = [], []
    for i in range(len(nodes)):
        ks = np.unique(keys[i][valid])
        key_sets.append(ks[rng.rand(len(ks)) < 0.5])
        occmax.append(-1 if i % 2 else int(np.median(occ[i])))
    key_sets[-1] = np.unique(keys[-1])  # the all-hit node
    occmax[-1] = -1
    starts, cols, _, _ = ce.cart_exact_select(
        matrix, masks, tmask, n_node, scale, "gini", limit, "equiv",
        occmax=torch.tensor(occmax, dtype=torch.int32),
        bitmap=torch.from_numpy(ce.key_bitmap(key_sets)),
        excl=torch.from_numpy(excl.astype(np.uint8)))
    starts, cols = starts.numpy(), cols.numpy()
    for i in range(len(nodes)):
        want = np.where(valid & np.isin(keys[i], key_sets[i])
                        & ((occmax[i] < 0) | (occ[i] == occmax[i])))[0]
        np.testing.assert_array_equal(cols[starts[i]:starts[i + 1]], want)
    assert starts[-1] - starts[-2] == valid.sum()


def test_key_encode_and_decode_round_trip():
    rng = np.random.RandomState(1)
    n_node = np.array([[3, 0, 5], [7, 2, 1]], np.int32)
    left = np.stack([np.stack([rng.randint(0, n + 1, 50) for n in row])
                     for row in n_node])
    keys = ce.mixed_radix_keys(torch.from_numpy(left),
                               torch.from_numpy(n_node)).numpy()
    for i in range(2):
        assert keys[i].max() < np.prod(n_node[i] + 1)
        back = ce.decode_keys(keys[i], n_node[i])
        np.testing.assert_array_equal(np.stack(back), left[i])
    np.testing.assert_array_equal(
        ce.lattice_sizes(torch.from_numpy(n_node)).numpy(), [24, 48])
    bitmap = ce.key_bitmap([np.array([0, 31, 32, 65535]), np.array([], int)])
    words = bitmap.view(np.uint32)
    assert words[0, 0] == 0x80000001 and words[0, 1] == 1
    assert words[0, -1] == 0x80000000 and not words[1].any()


def test_wrappers_reject_what_the_kernels_do_not_take():
    (dense, nodes, train, excl, matrix, masks, tmask, n_node,
     scale) = _ops_case(1)
    thresh = torch.zeros(len(nodes))
    with pytest.raises(ValueError, match="criterion"):
        ce.cart_exact_tuples(matrix, masks, tmask, n_node, scale, thresh,
                             "entropy", 10)
    with pytest.raises(ValueError, match="thresh"):
        ce.cart_exact_tuples(matrix, masks, tmask, n_node, scale,
                             thresh[:-1], "gini", 10)
    with pytest.raises(ValueError, match="mode"):
        ce.cart_exact_select(matrix, masks, tmask, n_node, scale, "gini", 10,
                             "tuples", thresh=thresh)
    with pytest.raises(ValueError, match="bitmap"):
        ce.cart_exact_select(matrix, masks, tmask, n_node, scale, "gini", 10,
                             "equiv", occmax=thresh.int())
    big = torch.tensor([[300, 300]] * len(nodes), dtype=torch.int32)
    with pytest.raises(ValueError, match="S_MAX"):
        ce.cart_exact_tuples(matrix, masks, tmask, big, scale, thresh,
                             "gini", 10)
    with pytest.raises(ValueError, match="classes"):
        ce.exact_plan("tuples", 4, 9, 11)
