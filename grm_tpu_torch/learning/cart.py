"""CART decision-tree learner over k-mer presence rules (the port of
``grm_tpu/learning/cart.py``).

Mirrors the reference (``learning/learners/cart.py``): class-importance
altered priors (Breiman 1984 section 4.4), Gini / cross-entropy impurity
computed *vectorized over all k-mers at once*, empty-child splits forbidden
(+inf), BFS growth with max_depth / min_samples_split / purity stopping, and
minimal cost-complexity pruning producing the (alpha, tree) sequence.

Device mapping: the per-class ``sum_rows`` calls (cart.py:129-135, 194-196)
become ONE multi-mask masked-popcount pass per node split — all classes'
left-child counts in a single sweep of the device-resident bit matrix. The
impurity arithmetic stays host-side float64 for exact selection parity.

Engines: ``"host"`` (float64 scan over fetched counts), ``"device"`` (the
exact device engine, :mod:`grm_tpu_torch.parallel.cart_exact`: the host's
model bit for bit from device sweeps) and ``"device-argmax"`` (impurity and
argmin on the device, :mod:`grm_tpu_torch.parallel.cart_device`). With a
``mesh`` both device engines score the frontier over the matrix's column
shards, one kernel launch a shard.
"""

from __future__ import annotations

from collections import deque
from copy import deepcopy
from dataclasses import dataclass, field
from math import ceil

import numpy as np

from ..utils import unpack_binary_bytes_from_ints
from .tree import ProbabilisticTreeNode

__all__ = [
    "ColumnFetchRequest",
    "DecisionTreeClassifier",
    "DeferredEquiv",
    "FrontierRequest",
    "prune_tree",
    "service_frontier_request",
]

ENGINES = ("host", "device", "device-argmax")


@dataclass
class FrontierRequest:
    """One BFS level's frontier-scoring work, yielded by
    :meth:`DecisionTreeClassifier.fit_stepwise`.

    The forest-batched engine concatenates requests from many trees (per
    criterion) into one fused device pass; ``altered_priors`` /
    ``total_n_examples_by_class`` therefore ride along per request so nodes
    of different trees (different folds / class importances) can share a
    pass with per-node priors.
    """

    node_sets: list = field(default_factory=list)
    altered_priors: dict = field(default_factory=dict)
    total_n_examples_by_class: dict = field(default_factory=dict)
    criterion: str = "gini"
    excl: object = None          # optional (K,) bool column blacklist
    mesh: object = None          # optional ("rows", "cols") device mesh
    bit_matrix: object = None    # the packed presence matrix to score over
    exact: bool = False          # exact engine: candidate gathers, host ties
    train_idx: object = None     # the tree's training examples (tiebreaker)
    need_equiv: bool = True      # gather full equivalent-rule tie sets
                                 # (False for fold trees: no split_callback)
    occ_tiebreak: bool = True    # reference max-occurrence tiebreaker; False
                                 # = identity (first candidate wins)
    defer_equiv: bool = False    # exact engine: return winning-tuple specs
                                 # instead of compacting equivalence sets
                                 # now (resolved once for the chosen master
                                 # via cart_exact.resolve_equiv_specs)


@dataclass
class DeferredEquiv:
    """Placeholder equivalence set injected by split callbacks when the
    exact engine defers compaction: carries the winning tuple keys +
    occmax needed to resolve the real column set later (only the
    finally-selected master's sets are consumed —
    experiment_cart.py:636-638)."""

    keys: object   # (T,) int64 winning tuple keys
    occmax: int    # max train occurrence (-1 = identity tiebreak)

    def __iter__(self):  # defensive: never silently iterate as indices
        raise TypeError(
            "DeferredEquiv must be resolved via "
            "cart_exact.resolve_equiv_specs before use")


@dataclass
class ColumnFetchRequest:
    """Winner-column fetch for one tree's frontier, yielded between BFS
    levels so the forest engine can batch EVERY tree's winning columns
    into one device gather per round (per-tree fetches each pay a device
    round trip)."""

    cols: object                   # (n,) int64 rule indices in [0, 2K)
    rule_classifications: object   # provider (get_columns)


def gini_impurity(altered_priors, n_total_class_examples, n_examples_by_class,
                  multiply_by_node_proba=False):
    """Gini diversity index; works on scalars or per-k-mer vectors
    (cart.py:85-110)."""
    p_j_t = {
        c: 1.0 * altered_priors[c] * n_examples_by_class[c]
        / n_total_class_examples[c]
        for c in n_examples_by_class
    }
    p_t = sum(p_j_t.values())
    with np.errstate(divide="ignore", invalid="ignore"):
        p_j_given_t = {c: np.divide(p_j_t[c], p_t) for c in p_j_t}
    gini = sum(
        p_j_given_t[i] * p_j_given_t[j]
        for i in p_j_given_t
        for j in p_j_given_t
        if i != j
    )
    return gini * (p_t if multiply_by_node_proba else 1.0)


def cross_entropy(altered_priors, n_total_class_examples, n_class_examples,
                  multiply_by_node_proba=False):
    """(cart.py:167-176) — module-level twin of :func:`gini_impurity`."""
    p_class_node = {
        c: 1.0 * altered_priors[c] * n_class_examples[c]
        / n_total_class_examples[c]
        for c in n_class_examples
    }
    node_resubstitution_estimate = sum(p_class_node.values())
    with np.errstate(divide="ignore", invalid="ignore"):
        p_class_given_node = {
            c: np.divide(p_class_node[c], node_resubstitution_estimate)
            for c in p_class_node
        }
        diversity_index = -1.0 * sum(
            np.nan_to_num(p_class_given_node[c] * np.log(p_class_given_node[c]))
            for c in p_class_given_node
        )
    return diversity_index * (
        node_resubstitution_estimate if multiply_by_node_proba else 1.0
    )


def score_candidates_f64(criterion, altered_priors, n_total_class_examples,
                         node_n_by_class, left_int_by_class):
    """float64 impurity scores of candidate left-count vectors — the SAME
    math (and class handling) as the full host scan, applied elementwise to
    candidate count vectors, so values are bit-identical to the full
    scan's. ``node_n_by_class``: {class: int node example count};
    ``left_int_by_class``: {class: int array of left-child counts}.

    Shared by the in-tree candidate replay and the exact device engine's
    tuple-space replay (:mod:`grm_tpu_torch.parallel.cart_exact`), so both
    order candidates as the host scan does.
    """
    if criterion == "gini":
        left = {c: left_int_by_class[c].astype(np.float64)
                for c in node_n_by_class}
        right = {c: float(node_n_by_class[c]) - left[c]
                 for c in left}
        vals = gini_impurity(altered_priors, n_total_class_examples, left,
                             True)
        vals = vals + gini_impurity(altered_priors, n_total_class_examples,
                                    right, True)
    else:
        nonempty = {c for c in node_n_by_class
                    if node_n_by_class[c]}
        left = {c: left_int_by_class[c].astype(np.float64)
                for c in nonempty}
        right = {c: float(node_n_by_class[c]) - left[c]
                 for c in left}
        vals = cross_entropy(altered_priors, n_total_class_examples, left,
                             True)
        vals = vals + cross_entropy(altered_priors, n_total_class_examples,
                                    right, True)
    vals[sum(left.values()) == 0] = np.inf
    vals[sum(right.values()) == 0] = np.inf
    return vals


def device_excl_from_blacklist(rule_blacklist, n_kmers):
    """Map a rule blacklist to a device column-exclusion mask.

    Returns (excl or None, ok). ok means every entry is a presence rule
    (< K) — the CART CLI blacklist contract (experiment_cart.py:490-518
    appends presence indices only) — or a paired presence/absence set
    (the SCM contract; the absence half is redundant for a presence-only
    scorer). Shared by the grow path and the deferred equivalence
    resolver so grow-time and resolve-time exclusion can never drift.
    """
    if rule_blacklist is None or not len(rule_blacklist):
        return None, True
    bl = set(int(r) for r in rule_blacklist)
    pres = {r for r in bl if r < n_kmers}
    extra = bl - pres
    ok = extra <= {r + n_kmers for r in pres}
    if not ok:
        return None, False
    excl = np.zeros(n_kmers, bool)
    excl[sorted(pres)] = True
    return excl, True


def service_frontier_request(request):
    """Score one tree's frontier request (the non-batched drive path)."""
    if isinstance(request, ColumnFetchRequest):
        return request.rule_classifications.get_columns(request.cols)
    if request.exact:
        from ..parallel.cart_exact import cart_frontier_candidates

        n = len(request.node_sets)
        return [
            ("exact", d) for d in cart_frontier_candidates(
                request.bit_matrix, request.node_sets,
                request.altered_priors, request.total_n_examples_by_class,
                request.criterion, [request.train_idx] * n,
                excl=request.excl, mesh=request.mesh,
                need_equiv=[request.need_equiv] * n,
                occ_tiebreak=[request.occ_tiebreak] * n,
                defer_equiv=[request.defer_equiv] * n,
            )
        ]
    from ..parallel.cart_device import cart_frontier_splits_device

    return cart_frontier_splits_device(
        request.bit_matrix, request.node_sets, request.altered_priors,
        request.total_n_examples_by_class, request.criterion,
        excl=request.excl, mesh=request.mesh,
    )


class DecisionTreeClassifier:
    def __init__(self, criterion, max_depth, min_samples_split, class_importance,
                 engine="host", mesh=None, defer_equiv=False):
        supported_criteria = ["gini", "cross-entropy"]
        if criterion not in supported_criteria:
            raise ValueError(
                "The supporting splitting criteria are: %s." % str(supported_criteria)
            )
        self.criterion = criterion
        if max_depth < 1:
            raise ValueError("The maximum tree depth must be greater than 1.")
        self.max_depth = max_depth
        if min_samples_split < 2.0:
            raise ValueError(
                "The minimum number of examples used to split a node must be 2 or greater."
            )
        self.min_samples_split = int(min_samples_split)
        self.class_importance = class_importance
        # "host": float64 exact-parity impurity scan over fetched counts;
        # "device": the EXACT device engine — float32 score minima and tuple
        #   tables or candidate gathers on the device, float64 equality ties
        #   and the tiebreaker replayed on the host: bit-identical to "host"
        #   (parallel/cart_exact.py);
        # "device-argmax": impurity + argmin fully on device (f32, lowest
        #   column ties), only the winner fetched — the speed path.
        if engine not in ENGINES:
            raise ValueError("engine must be one of %s" % (ENGINES,))
        self.engine = engine
        # Optional ("rows", "cols") device mesh: with a device engine,
        # frontier scoring shards the k-mer columns over the mesh.
        self.mesh = mesh
        # Defer equivalence-set compaction (exact engine only): split
        # callbacks receive DeferredEquiv specs; the experiment resolves
        # the chosen master's sets once at the end.
        self.defer_equiv = bool(defer_equiv) and engine == "device"
        self.decision_tree = None

    def fit(self, rules, rule_classifications, example_idx, rule_blacklist=None,
            tiebreaker=None, level_callback=None, split_callback=None):
        """Grow the tree, servicing this tree's frontier-score requests
        one by one. :meth:`fit_stepwise` is the generator form used by the
        forest-batched engine (:mod:`grm_tpu_torch.parallel.cart_forest`),
        which scores the frontiers of MANY trees per device pass."""
        gen = self.fit_stepwise(
            rules, rule_classifications, example_idx,
            rule_blacklist=rule_blacklist, tiebreaker=tiebreaker,
            level_callback=level_callback, split_callback=split_callback,
        )
        try:
            request = next(gen)
            while True:
                request = gen.send(service_frontier_request(request))
        except StopIteration:
            pass

    def fit_stepwise(self, rules, rule_classifications, example_idx,
                     rule_blacklist=None, tiebreaker=None, level_callback=None,
                     split_callback=None):
        """Generator form of :meth:`fit`: yields a :class:`FrontierRequest`
        per BFS level when the device engine is active and expects the
        per-node (kmer_idx or None, score) result list sent back. Host-engine
        trees never yield."""
        if level_callback is None:
            level_callback = lambda x: None
        # Equivalent-rule tie sets are only consumed through split_callback
        # (experiment drivers attach it to master trees only); fold trees
        # skip the exact engine's equivalence compaction entirely.
        need_equiv = split_callback is not None
        if split_callback is None:
            split_callback = lambda x, y: None
        # The exact device engine replays the tiebreak itself, so it must
        # know which semantics apply: the reference's max-occurrence rule
        # (accepts_occurrences) or the identity default (first candidate).
        # Arbitrary custom tiebreakers cannot be replayed device-side.
        occ_tiebreak = getattr(tiebreaker, "accepts_occurrences", False)
        custom_tiebreaker = tiebreaker is not None and not occ_tiebreak
        if tiebreaker is None:
            tiebreaker = lambda x: x
        if rule_blacklist is None:
            rule_blacklist = []
        rule_blacklist = np.asarray(rule_blacklist, dtype=np.int64)

        classes = sorted(example_idx)
        n_total_class_examples = {c: float(len(example_idx[c])) for c in classes}

        # Altered priors: importance-weighted class priors (Breiman 4.4,
        # reference cart.py:71-77).
        total = sum(n_total_class_examples.values())
        priors = {c: n_total_class_examples[c] / total for c in classes}
        denum = sum(self.class_importance[c] * priors[c] for c in classes)
        altered_priors = {
            c: self.class_importance[c] * priors[c] / denum for c in classes
        }

        def _gini_impurity(n_examples_by_class, multiply_by_node_proba=False):
            return gini_impurity(altered_priors, n_total_class_examples,
                                 n_examples_by_class, multiply_by_node_proba)

        def _cross_entropy(n_class_examples, multiply_by_node_proba=False):
            return cross_entropy(altered_priors, n_total_class_examples,
                                 n_class_examples, multiply_by_node_proba)

        def _left_right_counts(node_example_idx):
            """All classes' left-child (k-mer present) counts in ONE device pass."""
            node_classes = [c for c in classes]
            counts = rule_classifications.presence_counts(
                [node_example_idx[c] for c in node_classes]
            )
            left = {
                c: counts[i].astype(np.float64) for i, c in enumerate(node_classes)
            }
            right = {
                c: float(len(node_example_idx[c])) - left[c] for c in node_classes
            }
            return left, right

        def _gini_rule_score(node_example_idx):
            """(cart.py:112-161) — presence rules only (first half)."""
            left, right = _left_right_counts(node_example_idx)
            n_kmers = next(iter(left.values())).shape[0]
            BLOCK = 100000
            gini = np.zeros(n_kmers)
            n_blocks = int(ceil(1.0 * n_kmers / BLOCK))
            for i in range(n_blocks):
                sl = slice(i * BLOCK, (i + 1) * BLOCK)
                gini[sl] = _gini_impurity(
                    {c: ex[sl] for c, ex in left.items()}, True
                )
                gini[sl] += _gini_impurity(
                    {c: ex[sl] for c, ex in right.items()}, True
                )
            gini[sum(left.values()) == 0] = np.inf
            gini[sum(right.values()) == 0] = np.inf
            return gini

        def _cross_entropy_rule_score(node_example_idx):
            """(cart.py:178-207) — note the reference only includes classes
            with a non-empty example set (`if example_idx[c].size`)."""
            nonempty = {
                c: idx for c, idx in node_example_idx.items() if len(idx)
            }
            counts = rule_classifications.presence_counts(
                [nonempty[c] for c in sorted(nonempty)]
            )
            left = {
                c: counts[i].astype(np.float64)
                for i, c in enumerate(sorted(nonempty))
            }
            right = {
                c: float(len(nonempty[c])) - left[c] for c in left
            }
            xent = _cross_entropy(left, True)
            xent = xent + _cross_entropy(right, True)
            xent[sum(left.values()) == 0] = np.inf
            xent[sum(right.values()) == 0] = np.inf
            return xent

        if self.criterion == "gini":
            get_criterion = _gini_impurity
            score_rules = _gini_rule_score
        else:
            get_criterion = _cross_entropy
            score_rules = _cross_entropy_rule_score
        node_type = ProbabilisticTreeNode

        def _score_candidates(node_example_idx, left_int):
            """float64 scores of candidate columns (bit-identical to the
            full host scan; see :func:`score_candidates_f64`)."""
            return score_candidates_f64(
                self.criterion, altered_priors, n_total_class_examples,
                {c: len(node_example_idx[c]) for c in node_example_idx},
                left_int,
            )

        def _select_best_rule(node, device_result=None):
            """Selection half of the reference's _find_best_split
            (cart.py:219-250): the winning rule + its equivalence set,
            WITHOUT the column fetch (the caller batches one fetch for the
            whole frontier). Returns (selected_rule_idx or None,
            best_rules_idx)."""
            node_example_idx = node.class_examples_idx

            if (isinstance(device_result, tuple)
                    and device_result[0] == "exact"):
                # Exact device engine. Two payload forms:
                # - {"winner", "equiv"}: the engine already replayed the
                #   float64 selection (tuple-space replay) — bit-identical
                #   by construction (it runs score_candidates_f64 + the
                #   same tiebreaker semantics);
                # - {"cols", "left", "occ"}: candidate gather — the set
                #   provably contains every column whose float64 score can
                #   reach the minimum; selection replays here.
                payload = device_result[1]
                if payload is None:
                    return None, None
                if "winner" in payload:
                    selected_rule_idx = int(payload["winner"])
                    spec = payload.get("equiv_spec")
                    if spec is not None:
                        return selected_rule_idx, DeferredEquiv(
                            np.asarray(spec[0], np.int64), int(spec[1]))
                    equiv = payload.get("equiv")
                    best_rules_idx = (
                        np.asarray(equiv, dtype=np.int64)
                        if equiv is not None
                        else np.array([selected_rule_idx])
                    )
                    return selected_rule_idx, best_rules_idx
                vals = _score_candidates(node_example_idx, payload["left"])
                vmin = np.min(vals)
                if vmin == np.inf:
                    return None, None
                tie_sel = vals == vmin
                candidate_rules_idx = payload["cols"][tie_sel]
                if getattr(tiebreaker, "accepts_occurrences", False):
                    # The engine shipped each candidate's train-set
                    # occurrence count with the candidate — no re-fetch.
                    best_rules_idx = tiebreaker(
                        candidate_rules_idx,
                        occurrences=payload["occ"][tie_sel])
                else:
                    best_rules_idx = tiebreaker(candidate_rules_idx)
                return int(best_rules_idx[0]), best_rules_idx
            elif device_result is not None:
                best, score = device_result
                if best is None:
                    return None, None
                return best, np.array([best])
            else:
                rules_criterion = score_rules(node_example_idx)
                if len(rule_blacklist):
                    rules_criterion[rule_blacklist] = np.inf
                if np.min(rules_criterion) == np.inf:
                    return None, None
                candidate_rules_idx = np.where(
                    rules_criterion == np.min(rules_criterion)
                )[0]
                best_rules_idx = tiebreaker(candidate_rules_idx)
                return int(best_rules_idx[0]), best_rules_idx

        def _dispatch_examples(node, rule_preds):
            """Dispatch half: split the node's examples on the fetched
            rule column (cart.py:245-248)."""
            node_example_idx = node.class_examples_idx
            left = {
                c: node_example_idx[c][rule_preds[node_example_idx[c]] == 1]
                for c in node_example_idx
            }
            right = {
                c: node_example_idx[c][rule_preds[node_example_idx[c]] == 0]
                for c in node_example_idx
            }
            return left, right

        root = node_type(
            class_examples_idx=example_idx,
            depth=0,
            criterion_value=get_criterion(n_total_class_examples),
            class_priors=altered_priors,
            total_n_examples_by_class=n_total_class_examples,
        )

        current_level = [root]
        runtime_infos = {}
        min_samples_split = max(self.min_samples_split, 2)
        # CART scores the K presence rules only (reference cart.py:124-129),
        # so a blacklist maps to exact column exclusion whenever its indices
        # are presence rules (< K) or a paired presence/absence set — see
        # device_excl_from_blacklist. Anything else has no column mask, and
        # the device engines refuse it rather than score on the host.
        device_excl, blacklist_ok = device_excl_from_blacklist(
            rule_blacklist, rule_classifications.shape[1] // 2)
        use_device = self.engine in ("device", "device-argmax")
        if use_device and not blacklist_ok:
            raise ValueError(
                "engine=%r takes a blacklist of presence rules (or "
                "presence/absence pairs) only; this one holds absence rules "
                "without their presence rule." % self.engine)
        exact_engine = self.engine == "device"
        if exact_engine and custom_tiebreaker:
            raise ValueError(
                "engine='device' replays the reference tiebreak semantics "
                "(max occurrence, or the identity default) on the host; a "
                "custom tiebreaker callable cannot be replayed exactly — "
                "use engine='host' or mark the callable with "
                "accepts_occurrences if it implements the reference rule."
            )
        tree_train_idx = np.hstack(
            [example_idx[c] for c in classes]
        ) if classes else np.array([], np.int64)

        # Level-synchronous BFS (node order identical to the reference's
        # FIFO deque): nodes of one depth are independent, so the device
        # engine scores the whole frontier in one fused pass per level.
        while len(current_level) > 0:
            depth = current_level[0].depth
            runtime_infos["depth"] = depth
            if depth > 0:
                level_callback(runtime_infos)
            if depth == self.max_depth:
                break  # last-level nodes stay leaves
            splittable = [
                node for node in current_level
                if 1.0 not in node.class_proportions.values()  # pure leaf
                and node.n_examples >= min_samples_split
            ]
            device_results = None
            if use_device and splittable:
                device_results = yield FrontierRequest(
                    node_sets=[
                        node.class_examples_idx for node in splittable
                    ],
                    altered_priors=altered_priors,
                    total_n_examples_by_class=n_total_class_examples,
                    criterion=self.criterion,
                    excl=device_excl,
                    mesh=self.mesh,
                    bit_matrix=rule_classifications.bit_matrix,
                    exact=exact_engine,
                    train_idx=tree_train_idx,
                    need_equiv=need_equiv,
                    occ_tiebreak=occ_tiebreak,
                    defer_equiv=self.defer_equiv,
                )
            # Phase 1: select every node's winning rule (host, no fetch).
            selections = []
            bits_by_node = {}
            for node_i, node in enumerate(splittable):
                dr = None if device_results is None \
                    else device_results[node_i]
                selections.append(_select_best_rule(node, dr))
                # Exact-engine payloads may carry the winner's PACKED
                # column bits (the engine gathers them with its tables),
                # sparing this node the phase-2 fetch.
                if (isinstance(dr, tuple) and dr[0] == "exact"
                        and isinstance(dr[1], dict)
                        and dr[1].get("winner_bits") is not None
                        and selections[-1][0] == dr[1].get("winner")):
                    bits_by_node[node_i] = dr[1]["winner_bits"]
            # Phase 2: ONE batched column fetch for the whole frontier —
            # per-node fetches each pay a device round trip (or, on the
            # HDF5 path, a full gzip-chunk inflate per packed row).
            # Device-engine trees yield the fetch so the forest engine
            # batches it across ALL trees of the round. Nodes whose
            # payload shipped winner bits don't join the fetch.
            sel_cols = [s for node_i, (s, _) in enumerate(selections)
                        if s is not None and node_i not in bits_by_node]
            if not sel_cols:
                col_block = None
            elif use_device:
                col_block = yield ColumnFetchRequest(
                    np.array(sel_cols), rule_classifications)
            else:
                col_block = rule_classifications.get_columns(
                    np.array(sel_cols))
            col_pos = 0
            n_rows = rule_classifications.shape[0]
            n_kmers_total = rule_classifications.shape[1] // 2
            # Phase 3: dispatch children.
            nodes_to_split = deque()
            for node_i, node in enumerate(splittable):
                selected_rule_idx, equivalent_rule_idx = selections[node_i]
                if selected_rule_idx is None:
                    continue
                if node_i in bits_by_node:
                    packed = np.asarray(bits_by_node[node_i],
                                        np.uint32)[:, None]
                    rule_preds = unpack_binary_bytes_from_ints(
                        packed)[:n_rows, 0]
                    if selected_rule_idx >= n_kmers_total:
                        rule_preds = 1 - rule_preds
                else:
                    rule_preds = col_block[:, col_pos]
                    col_pos += 1
                left_idx, right_idx = _dispatch_examples(node, rule_preds)

                node.rule = rules[selected_rule_idx]
                left_n = {c: len(idx) for c, idx in left_idx.items()}
                right_n = {c: len(idx) for c, idx in right_idx.items()}

                node.left_child = node_type(
                    parent=node,
                    class_examples_idx=left_idx,
                    depth=node.depth + 1,
                    criterion_value=get_criterion(left_n),
                    class_priors=altered_priors,
                    total_n_examples_by_class=n_total_class_examples,
                )
                node.right_child = node_type(
                    parent=node,
                    class_examples_idx=right_idx,
                    depth=node.depth + 1,
                    criterion_value=get_criterion(right_n),
                    class_priors=altered_priors,
                    total_n_examples_by_class=n_total_class_examples,
                )
                # Unnormalized rule importance = impurity decrease
                # (cart.py:325-329).
                node.rule.importance = (
                    node.breiman_info.p_t * node.criterion_value
                    - node.left_child.breiman_info.p_t
                    * node.left_child.criterion_value
                    - node.right_child.breiman_info.p_t
                    * node.right_child.criterion_value
                )
                split_callback(node, equivalent_rule_idx)
                nodes_to_split.append(node.left_child)
                nodes_to_split.append(node.right_child)
                runtime_infos["model"] = root
            current_level = list(nodes_to_split)

        self.decision_tree = root

    def predict(self, X):
        if not self._is_fitted():
            raise RuntimeError("The classifier must be fitted before predicting.")
        return self.decision_tree.predict(X)

    def predict_proba(self, X):
        if not self._is_fitted():
            raise RuntimeError("The classifier must be fitted before predicting.")
        return self.decision_tree.predict_proba(X)

    def _is_fitted(self):
        return self.decision_tree is not None


def prune_tree(tree):
    """Minimal cost-complexity pruning -> (alphas, trees) (cart.py:362-470).

    Iterative implementations of the reference's recursive passes (no
    recursion limits), with identical np.allclose comparisons.
    """

    def _get_leaf_parents(root):
        leaf_parents = []
        stack = [root]
        while stack:
            node = stack.pop()
            if not node.is_leaf:
                if node.left_child.is_leaf and node.right_child.is_leaf:
                    leaf_parents.append(node)
                else:
                    stack.append(node.left_child)
                    stack.append(node.right_child)
        return leaf_parents

    def _initial_pruning(root):
        """Collapse zero-gain leaf parents (Tmax -> T1, cart.py:367-401)."""
        parents = _get_leaf_parents(root)
        while parents:
            node = parents.pop()
            if np.allclose(
                node.breiman_info.R_t,
                node.left_child.breiman_info.R_t + node.right_child.breiman_info.R_t,
            ):
                node.rule = None
                node.left_child = None
                node.right_child = None
                if (
                    not node.is_root
                    and node.parent.left_child.is_leaf
                    and node.parent.right_child.is_leaf
                ):
                    parents.append(node.parent)

    def _find_weakest_links(node):
        """(cart.py:403-429)"""
        if node.is_leaf:
            return np.inf, [node]
        RTt = sum(l.breiman_info.R_t for l in node.leaves)
        current_gt = float(node.breiman_info.R_t - RTt) / (len(node.leaves) - 1)
        left_min_gt, left_links = _find_weakest_links(node.left_child)
        right_min_gt, right_links = _find_weakest_links(node.right_child)

        if np.allclose(current_gt, min(left_min_gt, right_min_gt)):
            if np.allclose(left_min_gt, right_min_gt):
                return current_gt, [node] + left_links + right_links
            return current_gt, [node] + (
                left_links if left_min_gt < right_min_gt else right_links
            )
        elif current_gt < min(left_min_gt, right_min_gt):
            return current_gt, [node]
        elif np.allclose(left_min_gt, right_min_gt):
            return left_min_gt, left_links + right_links
        elif left_min_gt > right_min_gt:
            return right_min_gt, right_links
        else:
            return left_min_gt, left_links

    tree = deepcopy(tree)
    _initial_pruning(tree)
    T1 = tree

    sequence = [(0, T1)]
    current = T1
    while not current.is_leaf:
        current = deepcopy(current)
        min_gt, weakest_links = _find_weakest_links(current)
        for n in weakest_links:
            n.rule = None
            n.left_child = None
            n.right_child = None
        sequence.append((min_gt, current))

    alphas, trees = zip(*sequence)
    return alphas, trees
