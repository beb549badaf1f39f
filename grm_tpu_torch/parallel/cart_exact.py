"""Exact-parity device CART split selection (the port of
``grm_tpu/parallel/cart_exact.py``).

The argmax engine (:mod:`grm_tpu_torch.parallel.cart_device`) resolves
impurity ties to the lowest column in float32. This engine gives the
reference's selection bit for bit (``learners/cart.py:219-250``: float64
scores, exact-equality tie sets, then the max-occurrence tiebreaker of
``experiment_cart.py:82-94``) while the matrix sweeps run on the device, in
two regimes keyed on a node's per-class count lattice ``prod(n_c + 1)``:

**Tuple regime** (lattice at most ``S_MAX`` = 65536: every node of a
two-class dataset up to ~255 genomes a class, and all small nodes, where
exact impurity ties span millions of columns). A split's float64 score
depends only on its tuple of left-child class counts, so the device builds
per node a table over the tuples (:func:`grm_tpu_torch.ops.cart_exact.
cart_exact_tuples`: the largest train occurrence, the lowest column at it
and the lowest column of each tuple, for the columns whose float32 score is
within a margin of the node's float32 minimum), and the host replays the
float64 impurity (:func:`grm_tpu_torch.learning.cart.score_candidates_f64`,
the host engine's own operations) over the present tuples: the minimum tie
set, the tiebreak and the winning column are exact, with no margin
machinery. The winner's column bits come back in the same call, so the tree
fetches no column for it.

**Gather regime** (larger lattices): every column within the margin of the
node's float32 minimum is compacted with its class counts and occurrence
(:func:`~grm_tpu_torch.ops.cart_exact.cart_exact_select`, ``"gather"``),
and the tree replays the float64 selection over that candidate pool.

Equivalent-rule sets (consumed only by master trees' split callbacks) are
compacted in one more pass restricted to the winning tuples (``"equiv"``),
at once or, with ``defer_equiv``, once at the end for the chosen master
(:func:`resolve_equiv_specs`).

Pass 1, the per-node float32 minimum, is the argmax engine's frontier sweep
(:func:`grm_tpu_torch.ops.cart_sweep.cart_frontier_scores`): the same score
function, so a column's score in pass 2 is the bits whose minimum set the
threshold. What ``grm_tpu`` needed for the TPU is not ported: the distinct-
key extraction with its budget and escalation, the per-chunk programs of
``_DeviceStream`` and their environment knobs, shape buckets, the debug
timer, and the tuple, gather and equivalence budgets with their x8
re-runs; the kernels take a frontier and a matrix of any size, so a
resident matrix is swept whole (``grm_tpu``'s ``_DeviceStream`` and
``GRM_MONOLITH_MAX_COLS`` existed because XLA could not compile long scans
on the TPU).

A :class:`~grm_tpu_torch.ops.popcount.StreamingBitMatrix` (past the device
budget, in host memory) streams through the same kernels chunk by chunk
(``_HostStream``, ``grm_tpu/parallel/cart_exact.py:495-537``): pass 1's
per-node minima are reduced over the chunks; each chunk's tuple tables,
built with the global thresholds, are merged in chunk order (the largest
occurrence, then the lowest column at it; the lowest column of each
tuple); the compacted columns are concatenated in ascending order. A
chunk's columns become global by adding its first column in torch, which
is exact, so no kernel takes a column base.

A matrix sharded over a mesh (``mesh=``, or a matrix loaded sharded) is
walked the same way, its column shards taking the chunks' place: each
shard's passes run on its own device with the frontier's inputs copied
there, and their results come to the mesh's first device for the same
merges (a shard of padding only is skipped). On a mesh that spans
processes each process walks only its own shards, and the merges span the
processes: pass 1's minima by a min all-reduce, the tuple tables (their
columns made global first) by a max and a min all-reduce, the compacted
columns by a gather, merged node-major and ascending by global column;
every process then replays the same selection.
"""

from __future__ import annotations

import numpy as np
import torch

from ..learning.cart import score_candidates_f64
from ..ops.cart_exact import (
    S_MAX,
    _table_offsets,
    cart_exact_select,
    cart_exact_tuples,
    decode_keys,
    key_bitmap,
    lattice_sizes,
    table_rows,
)
from ..ops.cart_sweep import NO_COLUMN, cart_frontier_scores
from ..ops.popcount import StreamingBitMatrix, masks_to_tensor
from ..profiling import span
from .cart_device import _frontier_masks, _per_node_dicts, sharded_data
from .distributed import all_gather_arrays, all_reduce, check_agreement
from .mesh import ShardedMatrix, spans_processes
from .scm_device import build_packed_mask

__all__ = ["S_MAX", "cart_frontier_candidates", "resolve_equiv_specs"]

_F32_EPS = 1.2e-7


def _thresh_from_gmin(gmin, c):
    """Per-node filter thresholds from the float32 minima: a margin that
    over-covers the float32 evaluation error of the impurity (a few dozen
    rounded operations per class on exact counts), so every float64-minimum
    tuple's columns pass together; -inf where a node has no valid split."""
    margin = (256.0 + 128.0 * c) * _F32_EPS * (1.0 + gmin.abs())
    return torch.where(torch.isfinite(gmin), gmin + margin,
                       torch.tensor(-np.inf, device=gmin.device))


class _HostStream:
    """A streamed matrix's chunks, each with its slice of the column
    exclusion mask (the blacklist; padding columns too), cached on the bit
    matrix per blacklist as ``grm_tpu`` caches its ``_HostStream``."""

    def __init__(self, source, n_kmers, excl):
        if n_kmers >= NO_COLUMN:
            raise ValueError("the exact CART kernels index columns in int32")
        self.source = source
        self.n_kmers = n_kmers
        self.excl = None
        if excl is not None:
            ch = source.chunk_cols
            full = np.ones(source.n_chunks * ch, np.uint8)
            full[:n_kmers] = 0
            lim = min(len(excl), n_kmers)
            full[:lim] |= np.asarray(excl[:lim], bool)
            self.excl = torch.from_numpy(full.reshape(-1, ch)).to(
                source.device)

    @classmethod
    def cached(cls, bit_matrix, excl):
        key = None if excl is None else np.asarray(excl, bool).tobytes()
        cache = getattr(bit_matrix, "_host_stream_cache", None)
        if cache is None:
            cache = bit_matrix._host_stream_cache = {}
        if key not in cache:
            cache[key] = cls(bit_matrix.source, bit_matrix.n_columns, excl)
        return cache[key]

    def chunks(self):
        for ci, (lo, width, chunk) in enumerate(self.source.chunks()):
            yield (lo, max(0, min(width, self.n_kmers - lo)), chunk,
                   None if self.excl is None else self.excl[ci])


class _Frontier:
    """A frontier's device inputs: masks, counts, scales and train masks,
    with its matrix (resident, sharded over a mesh, or streamed by chunks)
    and the matrix's column-exclusion mask."""

    def __init__(self, bit_matrix, masks, n_node, priors, totals,
                 train_masks, excl, mesh=None):
        dev = self.device = bit_matrix.device
        self.n_kmers = bit_matrix.n_columns
        self.masks = masks_to_tensor(masks, dev)
        self.train = masks_to_tensor(train_masks, dev)
        self.n_node = torch.from_numpy(np.ascontiguousarray(n_node)).to(dev)
        self.priors = torch.from_numpy(priors).to(dev)
        self.totals = torch.from_numpy(totals).to(dev)
        # The scales pass 1 scores with (ops/cart_sweep._frontier_scores).
        self.scale = (self.priors / self.totals).contiguous()
        self.matrix = self.excl = self.stream = self.shards = None
        self.spans = False
        if isinstance(bit_matrix, StreamingBitMatrix):
            self.stream = _HostStream.cached(bit_matrix, excl)
            return
        data = bit_matrix.data if mesh is None else sharded_data(bit_matrix,
                                                                 mesh)
        if isinstance(data, ShardedMatrix):
            self.matrix = data
            self.shards = _shard_chunks(data, self.n_kmers, excl)
            self.spans = spans_processes(data)
            return
        self.matrix = data
        if excl is not None:
            self.excl = torch.from_numpy(np.ascontiguousarray(
                excl, dtype=bool).view(np.uint8)).to(dev)

    def chunks(self):
        """(first column, limit, matrix, exclusion mask) of the resident
        matrix whole, of each shard of a sharded one, or of each chunk of a
        streamed one."""
        if self.shards is not None:
            yield from self.shards
        elif self.stream is None:
            yield 0, self.n_kmers, self.matrix, self.excl
        else:
            yield from self.stream.chunks()

    def columns(self, cols):
        """(W, len(cols)) uint32 numpy: the packed columns ``cols``."""
        if self.stream is None:
            idx = torch.as_tensor(cols, device=self.device)
            if self.shards is not None:
                return self.matrix.gather_columns(idx).T.cpu().numpy().view(
                    np.uint32)
            return self.matrix.index_select(1, idx).cpu().numpy().view(
                np.uint32)
        return self.stream.source.columns(cols).T

    def rows(self, idx):
        """(masks, train masks, n_node, scale) of the nodes ``idx``."""
        sel = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        return (self.masks[sel].contiguous(), self.train[sel].contiguous(),
                self.n_node[sel].contiguous(), self.scale[sel].contiguous())

    def select(self, idx, criterion, mode, **per_node):
        """``cart_exact_select`` for the nodes ``idx`` over every chunk,
        merged node-major and ascending by global column: (starts (N + 1,),
        cols, left (C, T) or None, occ or None) int64 numpy."""
        masks, train, nn, scale = self.rows(idx)
        node_of, cols, lefts, occs = [], [], [], []
        for lo, limit, matrix, excl in self.chunks():
            dev = matrix.device
            starts, col, left, occ = cart_exact_select(
                matrix, masks.to(dev), train.to(dev), nn.to(dev),
                scale.to(dev), criterion, limit, mode, excl=excl,
                **{k: v.to(dev) for k, v in per_node.items()})
            node_of.append(np.repeat(np.arange(len(idx)),
                                     np.diff(starts.cpu().numpy())))
            cols.append(col.cpu().numpy().astype(np.int64) + lo)
            if mode == "gather":
                lefts.append(left.cpu().numpy().astype(np.int64))
                occs.append(occ.cpu().numpy().astype(np.int64))
        c = masks.shape[1]
        node_of = np.concatenate(node_of + [np.zeros(0, np.int64)])
        cols = np.concatenate(cols + [np.zeros(0, np.int64)])
        left = np.concatenate(lefts + [np.zeros((c, 0), np.int64)], 1)
        occ = np.concatenate(occs + [np.zeros(0, np.int64)])
        if self.spans:  # every process's selections, in process order
            rows = np.concatenate([node_of[None], cols[None], left,
                                   occ[None]] if mode == "gather" else
                                  [node_of[None], cols[None]])
            rows = np.concatenate(all_gather_arrays(rows.T)).T
            node_of, cols = rows[0], rows[1]
            if mode == "gather":
                left, occ = rows[2:2 + c], rows[2 + c]
        # Node-major, then ascending by global column (the processes'
        # shards need not come in column order).
        order = np.lexsort((cols, node_of))
        starts = np.concatenate(
            [[0], np.cumsum(np.bincount(node_of, minlength=len(idx)))])
        if mode != "gather":
            return starts, cols[order], None, None
        return starts, cols[order], left[:, order], occ[order]


def _shard_chunks(matrix, n_kmers, excl):
    """(first column, limit, shard, its exclusion mask) of each column
    shard of ``matrix`` that holds a real column, in ascending order."""
    lk = matrix.local_k
    full = None
    if excl is not None:
        full = np.zeros(matrix.shape[1], np.uint8)
        lim = min(len(excl), n_kmers)
        full[:lim] = np.asarray(excl[:lim], bool)
    out = []
    for lo, shard in matrix.column_shards():
        limit = min(max(n_kmers - lo, 0), lk)
        if limit:
            out.append((lo, limit, shard, None if full is None else
                        torch.from_numpy(full[lo:lo + lk]).to(shard.device)))
    return out


def _train_masks(bit_matrix, train_example_idx, w):
    n = len(train_example_idx)
    if not n:
        return np.zeros((0, w), np.uint32)
    return np.stack([build_packed_mask(idx, bit_matrix.n_rows, w)
                     for idx in train_example_idx])


def cart_frontier_candidates(bit_matrix, node_example_sets, altered_priors,
                             total_n_examples_by_class, criterion,
                             train_example_idx, excl=None, need_equiv=None,
                             occ_tiebreak=None, defer_equiv=None, mesh=None):
    """Exact-selection data for a BFS frontier.

    ``node_example_sets``: per-node {class: example idx} dicts.
    ``altered_priors`` / ``total_n_examples_by_class``: one dict or a
    per-node list (forest batching mixes trees with different priors).
    ``train_example_idx``: per-node training-set index arrays (the
    occurrence-tiebreaker population). ``excl``: optional (K,) bool column
    blacklist. ``need_equiv``: per-node bools, False skips the
    equivalent-rule compaction (fold trees). ``occ_tiebreak``: per-node
    bools, True for the reference's max-occurrence tiebreak, False for the
    identity tiebreak (the lowest column). ``defer_equiv``: per-node bools,
    True returns the winning-tuple spec (``equiv_spec``) instead of
    compacting the equivalence set now (:func:`resolve_equiv_specs`).
    ``mesh``: a ("rows", "cols") mesh whose column shards the passes walk.

    Returns a list per node: ``None`` when no valid split exists (exactly
    when the host's float64 minimum is +inf), else one of

    - ``{"winner": col, "equiv": ndarray | None, "winner_bits": (W,)
      uint32}``: tuple regime, the float64 selection already replayed;
      with deferral the dict carries ``equiv_spec`` = (winning tuple keys,
      occmax) instead of ``equiv``; ``winner_bits`` is the winner's packed
      column;
    - ``{"cols", "left", "occ"}``: gather regime, ascending by column; the
      candidates cover the float64 minimum tie set, and the selection
      replays in the tree.
    """
    n = len(node_example_sets)
    if n == 0:
        return []
    crit = "gini" if criterion == "gini" else "cross-entropy"
    masks, n_node, priors, totals = _frontier_masks(
        bit_matrix, node_example_sets, altered_priors,
        total_n_examples_by_class)
    c, w = masks.shape[1], masks.shape[2]
    priors_l = _per_node_dicts(altered_priors, n)
    totals_l = _per_node_dicts(total_n_examples_by_class, n)
    classes = sorted(totals_l[0])
    need_equiv = [True] * n if need_equiv is None else list(need_equiv)
    occ_tiebreak = [True] * n if occ_tiebreak is None else list(occ_tiebreak)
    defer_equiv = [False] * n if defer_equiv is None else list(defer_equiv)
    train = _train_masks(bit_matrix, train_example_idx, w)
    front = _Frontier(bit_matrix, masks, n_node, priors, totals, train, excl,
                      mesh)
    if front.spans:
        check_agreement("the frontier, its criterion, train sets, options "
                        "and the blacklist", masks, n_node, priors, totals,
                        train, crit, need_equiv, occ_tiebreak, defer_equiv,
                        None if excl is None else np.asarray(excl, bool))

    # Pass 1: per-node float32 minima, the frontier sweep's own, reduced
    # over the chunks of a streamed matrix or the shards of a sharded one
    # (and over the processes of a mesh that spans them).
    gmin = torch.full((n,), np.inf, device=front.device)
    for _, limit, matrix, chunk_excl in front.chunks():
        dev = matrix.device
        _, g = cart_frontier_scores(
            matrix, front.masks.to(dev), front.n_node.to(dev),
            front.priors.to(dev), front.totals.to(dev), crit, limit,
            excl=chunk_excl)
        gmin = torch.minimum(gmin, g.to(front.device))
    if front.spans:
        gmin = torch.from_numpy(all_reduce(gmin.cpu().numpy(), "min")).to(
            front.device)
    thresh = _thresh_from_gmin(gmin, float(c)).contiguous()

    lattice = np.prod(n_node.astype(np.int64) + 1, axis=1)
    is_tuple = lattice <= S_MAX
    out = [None] * n
    t_idx = np.where(is_tuple)[0]
    g_idx = np.where(~is_tuple)[0]
    if len(t_idx):
        _run_tuple_regime(out, t_idx, front, thresh, n_node, crit, classes,
                          priors_l, totals_l, need_equiv, occ_tiebreak,
                          defer_equiv)
    if len(g_idx):
        _run_gather_regime(out, g_idx, front, thresh, crit, classes)
    return out


def _run_tuple_regime(out, t_idx, front, thresh, n_node, crit, classes,
                      priors_l, totals_l, need_equiv, occ_tiebreak,
                      defer_equiv):
    masks, train, nn, scale = front.rows(t_idx)
    sel = torch.as_tensor(t_idx, device=front.device)
    th = thresh[sel].contiguous()
    # Empty tables (no column of any key has passed), laid out as
    # cart_exact_tuples lays them out.
    table_off, total = _table_offsets(lattice_sizes(nn))
    occ_tab = torch.zeros(total, dtype=torch.int64, device=front.device)
    col_tab = torch.full((total,), NO_COLUMN, dtype=torch.int32,
                         device=front.device)
    for lo, limit, matrix, excl in front.chunks():
        dev = matrix.device
        occ, col, _ = (t.to(front.device) for t in cart_exact_tuples(
            matrix, masks.to(dev), train.to(dev), nn.to(dev), scale.to(dev),
            th.to(dev), crit, limit, excl=excl))
        # The chunk's columns made global (the packed occurrence entry holds
        # 0xFFFFFFFF - col in its low word), then merged: the largest
        # occurrence, then the lowest column at it; the lowest column.
        occ_tab = torch.maximum(occ_tab, torch.where(occ != 0, occ - lo, 0))
        col_tab = torch.minimum(col_tab, torch.where(col != NO_COLUMN,
                                                     col + lo, NO_COLUMN))
    if front.spans:  # the same merges over the processes' tables
        occ_tab = torch.from_numpy(all_reduce(occ_tab.cpu().numpy(),
                                              "max")).to(front.device)
        col_tab = torch.from_numpy(all_reduce(col_tab.cpu().numpy(),
                                              "min")).to(front.device)
    # One download: the present tuples' (node, key, occmax, column at
    # occmax, lowest column).
    node_of, keys, occs, coccs, canys = torch.stack(
        table_rows(occ_tab, col_tab, table_off)).cpu().numpy()
    bounds = np.searchsorted(node_of, np.arange(len(t_idx) + 1))

    # Host float64 replay over the near-minimum tuples. Every float64-minimum
    # tuple is within the float32 margin, so the minimum over this subset is
    # the global minimum (and all its columns passed the filter together:
    # each tuple's occurrence maximum is over all its columns).
    with span("cart.replay"):
        winners = []
        equiv_jobs = []  # (node, winning tuple keys, occmax)
        for i, ni in enumerate(t_idx):
            lo, hi = bounds[i], bounds[i + 1]
            if lo == hi:
                continue
            tkeys, toccs = keys[lo:hi], occs[lo:hi]
            lefts = decode_keys(tkeys, n_node[ni])
            node_counts = {cl: int(n_node[ni, cj])
                           for cj, cl in enumerate(classes)}
            left_int = {cl: lefts[cj] for cj, cl in enumerate(classes)}
            vals = score_candidates_f64(crit, priors_l[ni], totals_l[ni],
                                        node_counts, left_int)
            vmin = np.min(vals)
            if vmin == np.inf:
                continue
            tie = vals == vmin
            if occ_tiebreak[ni]:
                # The reference's tiebreak, np.isclose(occ, occ.max()): exact
                # equality for integer occurrences. The winner is the lowest
                # column at the largest occurrence over the tie set's tuples.
                occmax = int(toccs[tie].max())
                winset = tie & (toccs == occmax)
                wincol = int(coccs[lo:hi][winset].min())
            else:
                # The identity tiebreak (fit()'s default): the first candidate,
                # the lowest column of every minimum-score tuple; occmax -1
                # disables the occurrence condition of the equivalence pass.
                occmax = -1
                winset = tie
                wincol = int(canys[lo:hi][winset].min())
            out[ni] = {"winner": wincol, "equiv": None}
            winners.append(ni)
            if need_equiv[ni]:
                if defer_equiv[ni]:
                    out[ni]["equiv_spec"] = (tkeys[winset].copy(), occmax)
                else:
                    equiv_jobs.append((ni, tkeys[winset], occmax))

    if winners:
        # The winners' packed columns in one gather: the tree then skips its
        # per-level column fetch for these nodes.
        bits = front.columns([out[ni]["winner"] for ni in winners])
        for j, ni in enumerate(winners):
            out[ni]["winner_bits"] = bits[:, j].copy()
    if equiv_jobs:
        sets = _resolve_equiv(front, equiv_jobs)
        for (ni, _, _), cols in zip(equiv_jobs, sets):
            out[ni]["equiv"] = cols


def _resolve_equiv(front, jobs):
    """Equivalence sets of ``jobs`` (node, winning tuple keys, occmax): per
    node the ascending columns whose tuple is a winning one, at the largest
    occurrence (any occurrence where occmax is -1): the reference's
    equivalent-rule set."""
    idx = [ni for ni, _, _ in jobs]
    dev = front.device
    bitmap = torch.from_numpy(key_bitmap([tk for _, tk, _ in jobs])).to(dev)
    occmax = torch.tensor([om for _, _, om in jobs], dtype=torch.int32,
                          device=dev)
    starts, cols, _, _ = front.select(idx, "gini", "equiv", occmax=occmax,
                                      bitmap=bitmap)
    return [cols[starts[j]:starts[j + 1]] for j in range(len(jobs))]


def _run_gather_regime(out, g_idx, front, thresh, crit, classes):
    sel = torch.as_tensor(g_idx, device=front.device)
    starts, cols, left, occ = front.select(
        g_idx, crit, "gather", thresh=thresh[sel].contiguous())
    for j, ni in enumerate(g_idx):
        lo, hi = starts[j], starts[j + 1]
        if lo == hi:
            continue
        out[ni] = {"cols": cols[lo:hi],
                   "left": {cl: left[cj, lo:hi]
                            for cj, cl in enumerate(classes)},
                   "occ": occ[lo:hi]}


def resolve_equiv_specs(bit_matrix, node_example_sets, train_example_idx,
                        specs, excl=None, mesh=None):
    """Resolve deferred equivalence specs for the finally-selected master.

    The hyperparameter search grows dozens of master trees but only the
    winning one's equivalence sets are ever consumed
    (experiment_cart.py:636-638), so with ``defer_equiv`` the per-level
    compaction is skipped and this one pass runs at the end.

    ``node_example_sets``: per-node {class: idx}; ``train_example_idx``:
    per-node training-set index arrays; ``specs``: per-node (winning tuple
    keys, occmax) as returned in ``equiv_spec`` payloads. Returns a list of
    ascending int64 rule-column arrays.
    """
    n = len(node_example_sets)
    if n == 0:
        return []
    classes = sorted(node_example_sets[0])
    dummy = {cl: 1.0 for cl in classes}
    masks, n_node, priors, totals = _frontier_masks(
        bit_matrix, node_example_sets, dummy, dummy)
    front = _Frontier(bit_matrix, masks, n_node, priors, totals,
                      _train_masks(bit_matrix, train_example_idx,
                                   masks.shape[2]), excl, mesh)
    return _resolve_equiv(front, [
        (i, np.asarray(spec[0], np.int64), int(spec[1]))
        for i, spec in enumerate(specs)])
