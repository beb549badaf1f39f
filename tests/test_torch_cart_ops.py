"""The port's CART frontier scorer (the plain PyTorch version of the
``cart_sweep`` kernel, on the CPU) against ``grm_tpu``'s: the per-node XLA
scorer (``sweep="xla"``) and the Pallas frontier kernel in interpret mode
(``sweep="pallas_interpret"``). Inputs come from numpy seeds. Winning
columns and ``(None, inf)`` must be equal; scores agree to ``rtol=1e-5``,
the tolerance ``tests/test_cart.py`` uses between those two, because XLA on
the CPU may contract ``p_t * p_t - sq`` into a fused multiply-add and sums
three classes in its own order."""

import numpy as np
import pytest
import torch

from grm_tpu.ops.popcount import BitMatrix as JaxBitMatrix
from grm_tpu.parallel.cart_device import (
    cart_best_split_device as jax_best_split,
    cart_frontier_splits_device as jax_frontier,
)

from grm_tpu_torch.ops import cart_sweep as cs
from grm_tpu_torch.ops.popcount import BitMatrix, masks_to_tensor
from grm_tpu_torch.parallel.cart_device import (
    _frontier_masks,
    cart_best_split_device,
    cart_frontier_splits_device,
)

CRITERIA = ["gini", "cross-entropy"]
SWEEPS = ["xla", "pallas_interpret"]


def _matrices(dense):
    return JaxBitMatrix.from_dense(dense), BitMatrix.from_dense(dense,
                                                                device="cpu")


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, ((gi, gs), (wi, ws)) in enumerate(zip(got, want)):
        assert gi == wi, (i, (gi, gs), (wi, ws))
        if wi is None:
            assert gs == np.inf and ws == np.inf
        else:
            assert np.isclose(gs, ws, rtol=1e-5), (i, gs, ws)


def _three_class_case(seed=0):
    """tests/test_cart.py:193: three classes, a node with an empty class;
    plus a node that no rule can split (one example)."""
    rng = np.random.RandomState(seed)
    n, k = 90, 700
    dense = (rng.rand(n, k) > 0.55).astype(np.uint8)
    y = rng.randint(0, 3, size=n)
    idx = np.arange(n)
    frontier = [
        {c: idx[(y == c) & (idx < 60)] for c in range(3)},
        {c: idx[(y == c) & (idx >= 30)] for c in range(3)},
        {c: idx[(y == c) & (idx % 2 == 0)] for c in range(3)},
        {0: idx[y == 0], 1: np.array([], np.int64), 2: idx[y == 2]},
        {0: idx[y == 0][:1], 1: np.array([], np.int64),
         2: np.array([], np.int64)},
    ]
    priors = {0: 0.5, 1: 0.3, 2: 0.2}
    totals = {c: int((y == c).sum()) for c in range(3)}
    return dense, frontier, priors, totals


@pytest.mark.parametrize("sweep", SWEEPS)
@pytest.mark.parametrize("criterion", CRITERIA)
def test_three_classes_with_an_empty_class(criterion, sweep):
    dense, frontier, priors, totals = _three_class_case()
    jax_bm, bm = _matrices(dense)
    want = jax_frontier(jax_bm, frontier, priors, totals, criterion,
                        sweep=sweep)
    # K = 700 is ragged against the port's block of 256 columns here.
    got = cart_frontier_splits_device(bm, frontier, priors, totals, criterion,
                                      block=256)
    _assert_same(got, want)
    assert want[-1] == (None, np.inf)
    assert all(w[0] is not None for w in want[:-1])
    # One block over all columns gives the same answer.
    _assert_same(cart_frontier_splits_device(bm, frontier, priors, totals,
                                             criterion), want)


def _per_node_case():
    """tests/test_cart.py:271: per-node priors and totals."""
    rng = np.random.RandomState(1)
    n, k = 80, 600
    dense = (rng.rand(n, k) > 0.5).astype(np.uint8)
    y = rng.randint(0, 2, size=n)
    idx = np.arange(n)
    nodes = [
        {c: idx[(y == c) & (idx < 50)] for c in range(2)},
        {c: idx[(y == c) & (idx >= 20)] for c in range(2)},
        {c: idx[(y == c) & (idx % 3 == 0)] for c in range(2)},
    ]
    priors = [{0: 0.5, 1: 0.5}, {0: 0.8, 1: 0.2}, {0: 0.3, 1: 0.7}]
    totals = [{0: 40.0, 1: 40.0}, {0: 30.0, 1: 50.0}, {0: 25.0, 1: 55.0}]
    return dense, nodes, priors, totals


@pytest.mark.parametrize("sweep", SWEEPS)
@pytest.mark.parametrize("criterion", CRITERIA)
def test_per_node_priors(criterion, sweep):
    dense, nodes, priors, totals = _per_node_case()
    jax_bm, bm = _matrices(dense)
    want = jax_frontier(jax_bm, nodes, priors, totals, criterion, sweep=sweep)
    got = cart_frontier_splits_device(bm, nodes, priors, totals, criterion,
                                      block=128)
    _assert_same(got, want)
    # One batched call == separate calls, each with its own priors.
    for i in range(3):
        one = cart_best_split_device(bm, nodes[i], priors[i], totals[i],
                                     criterion)
        assert one == got[i]
        _assert_same([one], [jax_best_split(jax_bm, nodes[i], priors[i],
                                            totals[i], criterion)])


@pytest.mark.parametrize("criterion", CRITERIA)
def test_blacklist_against_the_xla_scorer(criterion):
    """Excluded columns, among them every node's unrestricted winner. The
    matrix is 512 columns wide, grm_tpu's padded width, which its exclusion
    mask must match."""
    rng = np.random.RandomState(2)
    n, k = 70, 512
    dense = (rng.rand(n, k) > 0.5).astype(np.uint8)
    y = rng.randint(0, 2, size=n)
    idx = np.arange(n)
    nodes = [{c: idx[(y == c) & (idx % 4 != j)] for c in range(2)}
             for j in range(4)]
    priors = {0: 0.4, 1: 0.6}
    totals = {c: float((y == c).sum()) for c in range(2)}
    jax_bm, bm = _matrices(dense)
    free = cart_frontier_splits_device(bm, nodes, priors, totals, criterion)
    excl = rng.rand(k) < 0.3
    excl[[col for col, _ in free]] = True
    want = jax_frontier(jax_bm, nodes, priors, totals, criterion,
                        sweep="xla", excl=excl)
    got = cart_frontier_splits_device(bm, nodes, priors, totals, criterion,
                                      block=100, excl=excl)
    _assert_same(got, want)
    assert all(not excl[col] for col, _ in got)
    assert [c for c, _ in got] != [c for c, _ in free]


@pytest.mark.parametrize("sweep", SWEEPS)
def test_a_frontier_of_more_than_256_nodes(sweep):
    """One call in the port; chunks of at most 256 nodes in grm_tpu's
    Pallas path, one call per node in its XLA path."""
    rng = np.random.RandomState(3)
    n, k = 64, 300
    dense = (rng.rand(n, k) > 0.5).astype(np.uint8)
    y = rng.randint(0, 2, size=n)
    idx = np.arange(n)
    nodes = []
    for _ in range(300):
        pick = rng.rand(n) < 0.6
        nodes.append({c: idx[(y == c) & pick] for c in range(2)})
    priors = {0: 0.5, 1: 0.5}
    totals = {c: float((y == c).sum()) for c in range(2)}
    jax_bm, bm = _matrices(dense)
    want = jax_frontier(jax_bm, nodes, priors, totals, "gini", sweep=sweep)
    got = cart_frontier_splits_device(bm, nodes, priors, totals, "gini",
                                      block=128)
    _assert_same(got, want)


@pytest.mark.parametrize("criterion", CRITERIA)
def test_exact_ties_go_to_the_lowest_column(criterion):
    """Duplicate columns and a count-mirror of the best column: the lowest
    of them wins, as in grm_tpu's XLA scorer."""
    rng = np.random.RandomState(4)
    n, k = 60, 256
    dense = (rng.rand(n, k) > 0.5).astype(np.uint8)
    y = rng.randint(0, 2, size=n)
    marker = y.copy().astype(np.uint8)
    marker[rng.choice(n, 4, replace=False)] ^= 1
    for col in (200, 90, 131):
        dense[:, col] = marker
    dense[:, 40] = 1 - marker
    idx = np.arange(n)
    node = {c: idx[y == c] for c in range(2)}
    priors = {0: 0.5, 1: 0.5}
    totals = {c: float((y == c).sum()) for c in range(2)}
    jax_bm, bm = _matrices(dense)
    got = cart_frontier_splits_device(bm, [node], priors, totals, criterion,
                                      block=64)
    assert got[0][0] == 40
    _assert_same(got, jax_frontier(jax_bm, [node], priors, totals, criterion,
                                   sweep="xla"))


def test_no_node_with_a_valid_split_and_an_empty_frontier():
    dense = np.zeros((40, 50), np.uint8)
    dense[:, 7] = 1  # present everywhere: the right child is empty
    idx = np.arange(40)
    nodes = [{0: idx[:20], 1: idx[20:]}, {0: idx[:3], 1: idx[30:31]}]
    priors, totals = {0: 0.5, 1: 0.5}, {0: 20.0, 1: 20.0}
    jax_bm, bm = _matrices(dense)
    for criterion in CRITERIA:
        got = cart_frontier_splits_device(bm, nodes, priors, totals,
                                          criterion)
        assert got == [(None, np.inf)] * 2
        assert got == jax_frontier(jax_bm, nodes, priors, totals, criterion,
                                   sweep="xla")
    assert cart_frontier_splits_device(bm, [], priors, totals, "gini") == []


@pytest.mark.parametrize("criterion", CRITERIA)
def test_blocks_reduce_to_the_frontier_answer(criterion):
    """cart_sweep_blocks_plain's per-block (score, column) pairs: the
    frontier answer is their least score and then lowest column, a block
    past n_kmers or fully excluded holds (+inf, NO_COLUMN), and the wrapper
    on a CPU tensor is the plain version."""
    dense, frontier, priors, totals = _three_class_case(5)
    _, bm = _matrices(dense)
    masks, n_node, pri, tot = _frontier_masks(bm, frontier, priors, totals)
    masks_t = masks_to_tensor(masks, "cpu")
    n_node_t = torch.from_numpy(n_node)
    scale = torch.from_numpy(pri) / torch.from_numpy(tot)
    excl = torch.zeros(700, dtype=torch.uint8)
    excl[256:384] = 1
    limit = 650
    args = (bm.data, masks_t, n_node_t, scale, criterion, limit, 128, excl)
    score, col = cs.cart_sweep_blocks_plain(*args)
    w_score, w_col = cs.cart_sweep_blocks(*args)
    assert torch.equal(score, w_score) and torch.equal(col, w_col)
    assert score.shape == (6, 5) and col.dtype == torch.int32
    assert torch.isinf(score[2]).all() and (col[2] == cs.NO_COLUMN).all()
    assert torch.isinf(score[:, 4]).all()
    live = col != cs.NO_COLUMN
    blocks = torch.arange(6)[:, None].expand(6, 5)
    assert (col[live] // 128 == blocks[live]).all()
    assert (col[live] < limit).all()
    best_col, best = cs.cart_frontier_scores_plain(
        bm.data, masks_t, n_node_t, torch.from_numpy(pri),
        torch.from_numpy(tot), criterion, limit, block=128, excl=excl)
    for i in range(4):
        assert best[i] == score[:, i].min()
        assert best_col[i] == col[:, i][score[:, i] == best[i]].min()
    assert best_col[4] == cs.NO_COLUMN and torch.isinf(best[4])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    dense, frontier, priors, totals = _three_class_case()
    _, bm = _matrices(dense)
    masks, n_node, pri, tot = _frontier_masks(bm, frontier, priors, totals)
    masks_t = masks_to_tensor(masks, "cpu")
    n_node_t = torch.from_numpy(n_node)
    scale = torch.from_numpy(pri) / torch.from_numpy(tot)
    ok = (bm.data, masks_t, n_node_t, scale, "gini", 700, 128)
    cs.cart_sweep_blocks(*ok)
    bad = [
        (bm.data, masks_t, n_node_t, scale, "entropy", 700, 128),
        (bm.data, masks_t[:, :, :2], n_node_t, scale, "gini", 700, 128),
        (bm.data, masks_t, n_node_t.long(), scale, "gini", 700, 128),
        (bm.data, masks_t, n_node_t, scale[:2], "gini", 700, 128),
        (bm.data.T, masks_t, n_node_t, scale, "gini", 700, 128),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            cs.cart_sweep_blocks(*args)
    with pytest.raises(ValueError):
        cs.cart_sweep_blocks(*ok, torch.zeros(10, dtype=torch.uint8))
