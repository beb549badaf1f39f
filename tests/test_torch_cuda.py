"""Each CUDA kernel of grm_tpu_torch against its plain PyTorch version.

These tests need an NVIDIA GPU and skip without one. This file imports no
JAX, so it also runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX). Every
comparison is exact: the kernels round as the plain versions do. The one
exception is stated where it is made: the cross-entropy scores of
``cart_sweep``, whose ``logf`` and ``torch.log`` come from two toolkits.
"""

import os
import sys

import numpy as np
import pytest
import torch

from grm_tpu_torch.ops import cart_exact as ce
from grm_tpu_torch.ops import cart_sweep as cs
from grm_tpu_torch.ops import popcount as pc
from grm_tpu_torch.ops import scm_sweep as sw
from grm_tpu_torch.utils import pack_binary_bytes_to_ints

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as smoke  # noqa: E402  (the pass-bitmap cases)

pytestmark = pytest.mark.cuda

P_GRID = [0.1, 0.178, 0.316, 0.562, 1.0, 1.778, 3.162, 5.623, 10.0, 999999.0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _words(rng, shape):
    return torch.from_numpy(
        rng.randint(0, 2**32, size=shape, dtype=np.uint64)
        .astype(np.uint32).view(np.int32))


def _fits(rng, f, w, n_genomes, dyadic):
    neg = rng.randint(0, 2**32, size=(f, w), dtype=np.uint64).astype(np.uint32)
    pos = neg ^ np.uint32(0xFFFFFFFF)
    tail = n_genomes - 32 * (w - 1)
    keep = np.uint32((0xFFFFFFFF << (32 - tail)) & 0xFFFFFFFF)
    neg[:, -1] &= keep
    pos[:, -1] &= keep
    popc = lambda a: np.unpackbits(a.view(np.uint8), axis=1).sum(1)
    ps = (np.array([0.5, 1.0, 2.0, 4.0])[np.arange(f) % 4] if dyadic
          else np.array(P_GRID)[np.arange(f) % len(P_GRID)])
    return (torch.from_numpy(neg.view(np.int32)),
            torch.from_numpy(pos.view(np.int32)),
            torch.from_numpy(popc(neg).astype(np.int32)),
            torch.from_numpy(popc(pos).astype(np.int32)),
            torch.from_numpy(ps.astype(np.float32)))


def _same(a, b):
    a, b = a.cpu(), b.cpu()
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), (a - b).abs().max()


@pytest.mark.parametrize("c", [1, 2, 10, 12])
def test_popcount_colsum_kernel(cuda, c):
    rng = np.random.RandomState(c)
    matrix = _words(rng, (11, 100003)).to(cuda)
    masks = _words(rng, (c, 11)).to(cuda)
    _same(pc.popcount_colsum(matrix, masks),
          pc.popcount_colsum_plain(matrix, masks))


def test_popcount_colsum_pairs_kernel(cuda):
    rng = np.random.RandomState(1)
    k, width = 50001, 8192
    matrix = _words(rng, (11, k)).to(cuda)
    offsets = torch.tensor([0, 8192, 40960, 49152, 3, k - 1, k + 5, -100],
                           dtype=torch.int64, device=cuda)
    masks = _words(rng, (len(offsets), 2, 11)).to(cuda)
    _same(pc.popcount_colsum_pairs(matrix, masks, offsets, width),
          pc.popcount_colsum_pairs_plain(matrix, masks, offsets, width))


def _sweep_case(cuda, f, k, dyadic, excl_on, seed):
    rng = np.random.RandomState(seed)
    n_genomes = 342
    w = -(-n_genomes // 32)
    matrix = _words(rng, (w, k))
    matrix[-1] &= torch.tensor(np.uint32(0xFFFFFFFF << 10 & 0xFFFFFFFF)
                               .view(np.int32))
    neg, pos, nn, np_, ps = _fits(rng, f, w, n_genomes, dyadic)
    excl = None
    if excl_on:
        excl = torch.from_numpy((rng.rand(2, k) < 0.3).astype(np.uint8))
    t = [x.to(cuda) for x in (matrix, neg, pos, nn, np_, ps)]
    return t, None if excl is None else excl.to(cuda)


CASES = [(f, k, dyadic, excl_on)
         for f in (100, 128)
         for k in (100003, 3001)
         for dyadic in (False, True)
         for excl_on in (False, True)]


@pytest.mark.parametrize("f,k,dyadic,excl_on", CASES)
def test_scm_sweep_argmax_kernel(cuda, f, k, dyadic, excl_on):
    t, excl = _sweep_case(cuda, f, k, dyadic, excl_on, f + k)
    limit = k - 7
    got = sw.scm_sweep_argmax_blocks(*t, limit, min(4096, k), excl)
    want = sw.scm_sweep_argmax_blocks_plain(*t, limit, min(4096, k), excl)
    _same(got[0], want[0])
    _same(got[1], want[1])
    cpu = [x.cpu() for x in t]
    got = sw.scm_utility_argmax(*t, limit, excl=excl)
    want = sw.scm_utility_argmax(*cpu, limit,
                                 excl=None if excl is None else excl.cpu())
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("f,k,dyadic,excl_on", CASES)
def test_scm_sweep_sbmax_kernel(cuda, f, k, dyadic, excl_on):
    t, excl = _sweep_case(cuda, f, k, dyadic, excl_on, 7 * f + k)
    limit = k - 7
    _same(sw.scm_sweep_sbmax(*t, limit, 8192, excl),
          sw.scm_sweep_sbmax_plain(*t, limit, 8192, excl))


def test_kernels_at_the_largest_genome_count(cuda):
    """5022 genomes (W = 157): masks over several launches, fits over grid
    rows, more than 48 KB of shared memory."""
    rng = np.random.RandomState(5)
    n_genomes, k = 5022, 20001
    w = -(-n_genomes // 32)
    matrix = _words(rng, (w, k)).to(cuda)
    masks = _words(rng, (100, w)).to(cuda)
    _same(pc.popcount_colsum(matrix, masks),
          pc.popcount_colsum_plain(matrix, masks))
    fits = [t.to(cuda) for t in _fits(rng, 128, w, n_genomes, False)]
    excl = torch.from_numpy((rng.rand(2, k) < 0.2).astype(np.uint8)).to(cuda)
    got = sw.scm_sweep_argmax_blocks(matrix, *fits, k, 4096, excl)
    want = sw.scm_sweep_argmax_blocks_plain(matrix, *fits, k, 4096, excl)
    _same(got[0], want[0])
    _same(got[1], want[1])
    _same(sw.scm_sweep_sbmax(matrix, *fits, k, 8192, excl),
          sw.scm_sweep_sbmax_plain(matrix, *fits, k, 8192, excl))


# Fit counts, depths and widths that leave the tensor-core kernel's tiles
# ragged: fits in groups of 4 and passes of 32 groups (256 fits: two
# passes; at W = 157 passes of 8 groups and grid rows), depth in 128-bit steps and chunks of
# 4 steps (W = 1, 12, 13, 157), 16 columns a warp (K = 5001 is a multiple
# of neither 16 nor the block), limit < K, a column that every example has
# and one that none has, and an exclusion mask that bans whole 16-column
# tiles in both rows.
RAGGED_SCM_CASES = [(f, n_genomes, dyadic)
                    for f in (1, 3, 5, 101, 256)
                    for n_genomes in (20, 384, 400, 5022)
                    for dyadic in (False, True)]


@pytest.mark.parametrize("f,n_genomes,dyadic", RAGGED_SCM_CASES)
def test_scm_sweep_kernels_ragged_tiles(cuda, f, n_genomes, dyadic):
    rng = np.random.RandomState(f + n_genomes + dyadic)
    w = -(-n_genomes // 32)
    k = 5001
    matrix = _words(rng, (w, k))
    matrix[:, 7] = -1
    matrix[:, 8] = 0
    fits = [t.to(cuda) for t in _fits(rng, f, w, n_genomes, dyadic)]
    matrix = matrix.to(cuda)
    excl = (rng.rand(2, k) < 0.3).astype(np.uint8)
    excl[:, 32:48] = 1
    excl[:, 4096 + 64:4096 + 96] = 1
    limit = k - 7
    for ex in (None, torch.from_numpy(excl).to(cuda)):
        got = sw.scm_sweep_argmax_blocks(matrix, *fits, limit, 4096, ex)
        want = sw.scm_sweep_argmax_blocks_plain(matrix, *fits, limit, 4096,
                                                ex)
        _same(got[0], want[0])
        _same(got[1], want[1])
        _same(sw.scm_sweep_sbmax(matrix, *fits, limit, 2048, ex),
              sw.scm_sweep_sbmax_plain(matrix, *fits, limit, 2048, ex))


@pytest.mark.parametrize("share", [0.004, 0.2])
@pytest.mark.parametrize("f,n_genomes", [(5, 342), (100, 342), (101, 400)])
def test_scm_sweep_kernels_under_a_kmer_blacklist(cuda, f, n_genomes, share):
    """A k-mer blacklist bans both rules of a k-mer: runs of 64 columns take
    the common case, banned columns read as copies, unless a rule is banned
    alone (some are here) or a 16-column tile is banned whole, which take
    the one-tile path."""
    rng = np.random.RandomState(f + n_genomes + int(share * 1000))
    w = -(-n_genomes // 32)
    k = 20001
    matrix = _words(rng, (w, k)).to(cuda)
    fits = [t.to(cuda) for t in _fits(rng, f, w, n_genomes, False)]
    excl = np.zeros((2, k), np.uint8)
    excl[:, rng.rand(k) < share] = 1
    excl[0, rng.rand(k) < 0.002] = 1
    excl[1, rng.rand(k) < 0.002] = 1
    excl[:, 4096 + 16:4096 + 32] = 1
    ex = torch.from_numpy(excl).to(cuda)
    limit = k - 3
    got = sw.scm_sweep_argmax_blocks(matrix, *fits, limit, 4096, ex)
    want = sw.scm_sweep_argmax_blocks_plain(matrix, *fits, limit, 4096, ex)
    _same(got[0], want[0])
    _same(got[1], want[1])
    _same(sw.scm_sweep_sbmax(matrix, *fits, limit, 8192, ex),
          sw.scm_sweep_sbmax_plain(matrix, *fits, limit, 8192, ex))


def _frontier(rng, n, c, n_genomes, per_node):
    """n nodes over c classes: disjoint class masks of random examples;
    node 0's second class is empty."""
    w = -(-n_genomes // 32)
    masks = np.zeros((n, c, w), np.uint32)
    pick = rng.rand(n, n_genomes) < 0.7
    owner = rng.randint(0, c, size=(n, n_genomes))
    if c > 1:
        owner[0][owner[0] == 1] = 0
    bits = np.uint32(1) << (31 - np.arange(n_genomes) % 32).astype(np.uint32)
    for i in range(n):
        for ci in range(c):
            rows = np.where(pick[i] & (owner[i] == ci))[0]
            np.bitwise_or.at(masks[i, ci], rows // 32, bits[rows])
    n_node = np.unpackbits(masks.view(np.uint8), axis=2).sum(2).astype(np.int32)
    shape = (n, c) if per_node else (c,)
    priors = (rng.rand(*shape) + 0.1).astype(np.float32)
    totals = rng.randint(n_genomes // 2, n_genomes, size=shape).astype(
        np.float32)
    return (torch.from_numpy(masks.view(np.int32)), torch.from_numpy(n_node),
            torch.from_numpy(priors), torch.from_numpy(totals))


def _ulps(a, b):
    """Largest distance in float32 steps between two finite tensors."""
    ia = a.cpu().view(torch.int32).long()
    ib = b.cpu().view(torch.int32).long()
    return int((ia - ib).abs().max()) if ia.numel() else 0


def _cart_case(cuda, n, c, k, criterion, per_node, excl_on, seed,
               n_genomes=342):
    rng = np.random.RandomState(seed)
    w = -(-n_genomes // 32)
    matrix = _words(rng, (w, k)).to(cuda)
    masks, n_node, priors, totals = [
        t.to(cuda) for t in _frontier(rng, n, c, n_genomes, per_node)]
    scale = (priors / totals).expand(n, c).contiguous()
    excl = None
    if excl_on:
        excl = torch.from_numpy((rng.rand(k) < 0.3).astype(np.uint8)).to(cuda)
    limit = k - 7
    block = min(cs.BLOCK_K, k)
    got = cs.cart_sweep_blocks(matrix, masks, n_node, scale, criterion, limit,
                               block, excl)
    want = cs.cart_sweep_blocks_plain(matrix, masks, n_node, scale, criterion,
                                      limit, block, excl)
    _same(got[1], want[1])
    if criterion == "gini":
        _same(got[0], want[0])
    else:
        # logf in the kernel and torch.log on the card are both CUDA's
        # single-precision log, built by two toolkits: at most 2 ulps.
        inf = torch.isinf(want[0])
        assert torch.equal(torch.isinf(got[0]), inf)
        assert _ulps(got[0][~inf], want[0][~inf]) <= 2
    got = cs.cart_frontier_scores(matrix, masks, n_node, priors, totals,
                                  criterion, limit, excl=excl)
    want = cs.cart_frontier_scores_plain(matrix, masks, n_node, priors,
                                         totals, criterion, limit, excl=excl)
    _same(got[0], want[0])
    # The reduced scores too, with (+inf, NO_COLUMN) at the same nodes.
    if criterion == "gini":
        _same(got[1], want[1])
    else:
        inf = torch.isinf(want[1])
        assert torch.equal(torch.isinf(got[1]), inf)
        assert torch.equal(got[0] == cs.NO_COLUMN, inf)
        assert _ulps(got[1][~inf], want[1][~inf]) <= 2


CART_CASES = [(n, c, k, criterion, per_node, excl_on)
              for n, c in ((1, 2), (37, 2), (200, 2), (37, 3), (5, 8),
                           (9, 6))  # 6 classes: the 8-class build, padded
              for k in (100003, 3001)
              for criterion in cs.CRITERIA
              for per_node, excl_on in ((False, False), (True, True))]


@pytest.mark.parametrize("n,c,k,criterion,per_node,excl_on", CART_CASES)
def test_cart_sweep_kernel(cuda, n, c, k, criterion, per_node, excl_on):
    _cart_case(cuda, n, c, k, criterion, per_node, excl_on, n + c + k)


@pytest.mark.parametrize("criterion", cs.CRITERIA)
def test_cart_sweep_kernel_at_the_largest_genome_count(cuda, criterion):
    """5022 genomes (W = 157): 200 nodes x 2 classes of masks pass the
    shared-memory budget, so nodes split over grid rows."""
    _cart_case(cuda, 200, 2, 20001, criterion, True, True, 11,
               n_genomes=5022)


# Frontiers, depths and class counts that leave the kernel's tiles ragged:
# nodes in groups of 4 and passes of a few groups, depth in 128-bit steps (342
# genomes: 11 words, 3 steps with a ragged last; 384: exactly 3; 400: a
# fourth), 16 columns a warp (K = 3001 and 100003 are multiples of neither 8
# nor 16, and the limit K - 7 falls inside a block).
RAGGED_CART_CASES = [(n, c, 3001, criterion, excl_on, n_genomes)
                     for n in (9, 17, 18)
                     for c in (2, 3, 5)
                     for criterion in cs.CRITERIA
                     for excl_on in (False, True)
                     for n_genomes in (342,)] + [
    (n, c, k, criterion, excl_on, n_genomes)
    for n_genomes in (384, 400)
    for n, c, k in ((18, 2, 100003), (9, 3, 3001), (17, 5, 3001))
    for criterion in cs.CRITERIA
    for excl_on in (False, True)]


@pytest.mark.parametrize("n,c,k,criterion,excl_on,n_genomes",
                         RAGGED_CART_CASES)
def test_cart_sweep_kernel_ragged_tiles(cuda, n, c, k, criterion, excl_on,
                                        n_genomes):
    _cart_case(cuda, n, c, k, criterion, True, excl_on, n + c + k + n_genomes,
               n_genomes=n_genomes)


@pytest.mark.parametrize("excl_on", [False, True])
@pytest.mark.parametrize("criterion", cs.CRITERIA)
def test_cart_sweep_kernel_ragged_at_the_largest_genome_count(cuda, criterion,
                                                              excl_on):
    """5022 genomes (W = 157: 40 steps, the last one word deep) x 65 nodes:
    17 groups, the last with one node."""
    _cart_case(cuda, 65, 2, 20001, criterion, True, excl_on, 13,
               n_genomes=5022)


def test_cart_sweep_kernel_without_a_valid_split(cuda):
    matrix = torch.zeros((11, 5000), dtype=torch.int32, device=cuda)
    rng = np.random.RandomState(2)
    masks, n_node, priors, totals = [
        t.to(cuda) for t in _frontier(rng, 9, 2, 342, False)]
    for criterion in cs.CRITERIA:
        col, score = cs.cart_frontier_scores(matrix, masks, n_node, priors,
                                             totals, criterion, 5000)
        assert torch.isinf(score).all() and (col == cs.NO_COLUMN).all()


def test_cart_sweep_kernel_rejects_too_many_classes(cuda):
    rng = np.random.RandomState(3)
    matrix = _words(rng, (11, 1000)).to(cuda)
    masks, n_node, priors, totals = [
        t.to(cuda) for t in _frontier(rng, 2, 9, 342, False)]
    with pytest.raises(ValueError, match="at most 8 classes"):
        cs.cart_frontier_scores(matrix, masks, n_node, priors, totals,
                                "gini", 1000)
    masks, n_node, priors, totals = [
        t.to(cuda) for t in _frontier(rng, 2, 1, 342, False)]
    with pytest.raises(ValueError, match="at least 2"):
        cs.cart_frontier_scores(matrix, masks, n_node, priors, totals,
                                "gini", 1000)


def _exact_frontier(rng, n, c, n_genomes, small=True):
    """n nodes over c classes with their own train masks (nodes of
    different trees): disjoint class masks of random examples. With
    ``small`` every node's count lattice fits the tuple tables (S_MAX);
    the last node then holds one example of each of two classes, so that
    nearly every column falls on one of four keys (the all-hit node)."""
    w = -(-n_genomes // 32)
    bits = np.uint32(1) << (31 - np.arange(n_genomes) % 32).astype(np.uint32)
    per_class = int(ce.S_MAX ** (1.0 / c)) - 1 if small else n_genomes
    masks = np.zeros((n, c, w), np.uint32)
    train = np.zeros((n, w), np.uint32)
    for i in range(n):
        for ci in range(c):
            m = rng.randint(0, min(per_class, n_genomes // c) + 1)
            rows = rng.choice(np.arange(ci, n_genomes, c), m, replace=False)
            np.bitwise_or.at(masks[i, ci], rows // 32, bits[rows])
        rows = np.where(rng.rand(n_genomes) < 0.7)[0]
        np.bitwise_or.at(train[i], rows // 32, bits[rows])
    if small and n > 1:
        masks[-1] = 0
        for ci in range(2):
            masks[-1, ci, 0] = bits[ci]
    n_node = np.unpackbits(masks.view(np.uint8), axis=2).sum(2).astype(np.int32)
    priors = (rng.rand(n, c) + 0.1).astype(np.float32)
    totals = rng.randint(n_genomes // 2, n_genomes, size=(n, c)).astype(
        np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(masks.view(np.int32)), t(train.view(np.int32)), t(n_node),
            t(priors), t(totals))


def _exact_case(cuda, n, c, k, criterion, excl_on, seed, n_genomes=342):
    """Both exact kernels against their plain versions on one frontier, at
    pass 1's thresholds (the engine's own margin) and, for the last node,
    +inf (every valid split passes)."""
    from grm_tpu_torch.parallel.cart_exact import _thresh_from_gmin

    rng = np.random.RandomState(seed)
    w = -(-n_genomes // 32)
    matrix = _words(rng, (w, k)).to(cuda)
    for small in (True, False):
        masks, train, n_node, priors, totals = [
            x.to(cuda) for x in _exact_frontier(rng, n, c, n_genomes, small)]
        scale = (priors / totals).contiguous()
        excl = None
        if excl_on:
            excl = torch.from_numpy((rng.rand(k) < 0.3).astype(np.uint8)
                                    ).to(cuda)
        limit = k - 7
        _, gmin = cs.cart_frontier_scores_plain(matrix, masks, n_node, priors,
                                                totals, criterion, limit,
                                                excl=excl)
        thresh = _thresh_from_gmin(gmin, float(c)).contiguous()
        if small:
            thresh[-1] = float("inf")
            args = (matrix, masks, train, n_node, scale, thresh, criterion,
                    limit, excl)
            got = ce.cart_exact_tuples(*args)
            want = ce.cart_exact_tuples_plain(*args)
            for g, x in zip(got, want):
                _same(g, x)
            assert int((want[0] != 0).sum()) > 0
            rows = [r.cpu().numpy() for r in ce.table_rows(*want)]
            keys = [rows[1][(rows[0] == i) & (np.arange(len(rows[0])) % 2
                                              == 0)] for i in range(n)]
            occmax = torch.tensor([-1 if i % 2 else int(rows[2][rows[0] == i]
                                                        .max(initial=-1))
                                   for i in range(n)], dtype=torch.int32,
                                  device=cuda)
            args = (matrix, masks, train, n_node, scale, "gini", limit,
                    "equiv")
            kw = dict(occmax=occmax, excl=excl, bitmap=torch.from_numpy(
                ce.key_bitmap(keys)).to(cuda))
            got = ce.cart_exact_select(*args, **kw)
            want = ce.cart_exact_select_plain(*args, **kw)
            for g, x in zip(got[:2], want[:2]):
                _same(g, x)
        args = (matrix, masks, train, n_node, scale, criterion, limit,
                "gather")
        got = ce.cart_exact_select(*args, thresh=thresh, excl=excl)
        want = ce.cart_exact_select_plain(*args, thresh=thresh, excl=excl)
        for g, x in zip(got, want):
            _same(g, x)


EXACT_CASES = [(n, c, k, criterion, excl_on)
               for n, c in ((1, 2), (18, 2), (65, 2), (18, 3), (9, 5))
               for k in (100003, 3001)
               for criterion in cs.CRITERIA
               for excl_on in (False, True)]


@pytest.mark.parametrize("n,c,k,criterion,excl_on", EXACT_CASES)
def test_cart_exact_kernels(cuda, n, c, k, criterion, excl_on):
    _exact_case(cuda, n, c, k, criterion, excl_on, n + c + k)


@pytest.mark.parametrize("criterion", cs.CRITERIA)
def test_cart_exact_kernels_at_the_largest_genome_count(cuda, criterion):
    """5022 genomes (W = 157): 40 steps of depth, the last one word deep;
    the nodes' masks pass the shared-memory budget, so they split over grid
    rows."""
    _exact_case(cuda, 65, 2, 20001, criterion, True, 17, n_genomes=5022)


@pytest.mark.parametrize("criterion", cs.CRITERIA)
def test_cart_exact_kernels_at_the_largest_genome_count_three_classes(
        cuda, criterion):
    """5022 genomes (W = 157) with three classes and no exclusion mask: the
    A fragments staged in shared memory, the nodes over grid rows."""
    _exact_case(cuda, 65, 3, 20001, criterion, False, 23, n_genomes=5022)


@pytest.mark.parametrize("criterion", cs.CRITERIA)
@pytest.mark.parametrize("case", range(len(smoke.BITMAP_CASES)))
def test_pass_bitmap_kernel(cuda, case, criterion):
    rng = np.random.RandomState(case)
    n_node, scale, thresh = smoke.bitmap_inputs(
        rng, *smoke.BITMAP_CASES[case], criterion, cuda)
    got = ce.pass_bitmap(n_node, scale, thresh, criterion)
    want = ce.pass_bitmap_plain(n_node, scale, thresh, criterion)
    for g, x in zip(got, want):
        _same(g, x)
    assert bool((want[0] != 0).any())


def _record(name, got, want, what):
    assert smoke.exact_err(got, want) == 0.0, "%s at %s" % (name, what)


@pytest.mark.parametrize("n_genomes", smoke.INGEST_CASE_GENOMES)
@pytest.mark.parametrize("k", smoke.INGEST_CASE_KS)
def test_ingest_kernels(cuda, k, n_genomes):
    """kmer_canon, build_columns, merge_columns and compact_columns at
    phase 3's (k, G) cases: runs of 4s, a contig shorter than k, a length
    that is a multiple of no tile."""
    smoke.ingest_case(cuda, np.random.RandomState(100 * k + n_genomes), k,
                      n_genomes, _record)


def test_ingest_builders(cuda):
    """Both builders on the card against the plain versions on the CPU,
    with and without the singleton filter; the all-T k-mer; a full
    bucket."""
    smoke.ingest_builder_cases(cuda, np.random.RandomState(5), _record)


@pytest.mark.parametrize("k", smoke.HOT_CASE_KS)
def test_ingest_build_columns_over_many_tiles(cuda, k):
    """build_columns over more than 1,000 of its tiles, with one k-mer's
    first matrix word covering several whole tiles."""
    smoke.hot_kmer_case(cuda, np.random.RandomState(k), k, _record)


@pytest.mark.parametrize("k", smoke.MERGE_CASE_KS)
def test_ingest_merge_three_batches(cuda, k):
    """merge_columns on batches with unequal buckets (32, 32 and 6
    genomes; 64 and 6): as built, with no valid row, and with every row
    valid."""
    smoke.merge_cases(cuda, np.random.RandomState(k), k, _record)


@pytest.fixture(scope="module")
def create_inputs(tmp_path_factory):
    """Phase 4's creation inputs: its 40 genomes of 200 kbp as FASTA
    files and as read directories, with their lists and metadata."""
    return smoke.create_inputs(str(tmp_path_factory.mktemp("create")), 0)


@pytest.mark.parametrize("filter_singleton", [False, True])
@pytest.mark.parametrize("mode", ["contigs", "reads"])
@pytest.mark.parametrize("k", smoke.CREATE_CASE_KS)
def test_create_on_the_card(cuda, create_inputs, k, mode, filter_singleton):
    """from_contigs / from_reads into a MemoryArtifact on the card equal
    the same call on the CPU, array for array and attr for attr."""
    assert smoke.create_case(cuda, create_inputs, mode, k,
                             filter_singleton) > 0


@pytest.mark.parametrize("k", smoke.CREATE_CASE_KS)
def test_count_fasta_on_the_card(cuda, create_inputs, k):
    """count_fasta(keep_counts=True) on the card equals the CPU's."""
    assert smoke.count_case(cuda, create_inputs, k) >= 1


def test_chunk_source_uploads(cuda):
    """The chunk source's double-buffered pinned uploads (8 chunks, two
    buffers, the current stream kept busy) against a plain upload of each
    chunk, bit for bit; the hit-superblock upload; StreamingBitMatrix.
    presence_counts on the card against its CPU run."""
    smoke.stream_cases(cuda, np.random.RandomState(12), _record)


def _streamed_pair(cuda, rng, n_genomes=342, n_kmers=40000):
    dense = (rng.rand(n_genomes, n_kmers) > 0.5).astype(np.uint8)
    labels = (rng.rand(n_genomes) > 0.5).astype(np.uint8)
    for c, flips in ((17, 10), (9000, 30), (33333, 30)):
        col = labels.copy()
        col[rng.choice(n_genomes, flips, replace=False)] ^= 1
        dense[:, c] = col
    dense[:, 20001] = dense[:, 17]
    packed = pack_binary_bytes_to_ints(dense, 32)
    return (labels, pc.BitMatrix(packed, n_genomes, device=cuda),
            pc.StreamingBitMatrix(packed, n_genomes, 8192, cuda))


def test_streamed_exact_scm_engine_equals_resident(cuda):
    """The streamed exact SCM engine on the card (5 chunks of 8192) gives
    the resident engine's rules, tie sets and errors."""
    from grm_tpu_torch.parallel.scm_exact import (ExactScmEngine,
                                                  _make_risk_lookup)

    rng = np.random.RandomState(4)
    labels, resident, streamed = _streamed_pair(cuda, rng)
    n, k = len(labels), resident.n_columns
    fits = []
    for model_type in ("conjunction", "disjunction"):
        for p in (0.5, 1.0, 4.0):
            pos = np.where(labels == 1)[0]
            neg = np.where(labels == 0)[0]
            if model_type == "disjunction":
                pos, neg = neg, pos
            fits.append({"pos_mask": resident.row_mask(pos[5:]),
                         "neg_mask": resident.row_mask(neg[5:]),
                         "test_pos_mask": resident.row_mask(pos[:5]),
                         "test_neg_mask": resident.row_mask(neg[:5]),
                         "p": p, "model_type": model_type,
                         "risk_lookup": _make_risk_lookup(
                             rng.rand(k), rng.rand(k), k)})
    want = ExactScmEngine(resident.data, k).run_fits(fits, 5, True)
    got = ExactScmEngine(streamed, k).run_fits(fits, 5, True)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert [[t.tolist() for t in f] for f in got[4]] == \
        [[t.tolist() for t in f] for f in want[4]]
    assert streamed.source.bytes_uploaded > 0


def test_streamed_cart_candidates_equal_resident(cuda):
    """The streamed exact CART engine's frontier payloads on the card equal
    the resident engine's: tuple tables merged across chunks, the winners'
    bits, the equivalence sets."""
    from grm_tpu_torch.parallel.cart_exact import cart_frontier_candidates

    rng = np.random.RandomState(7)
    labels, resident, streamed = _streamed_pair(cuda, rng)
    idx = np.arange(len(labels))
    nodes = [{0: idx[labels == 0], 1: idx[labels == 1]},
             {0: idx[labels == 0][:40], 1: idx[labels == 1][:50]}]
    args = (nodes, {0: 0.5, 1: 0.5}, {0: 171.0, 1: 171.0}, "gini",
            [idx, idx[:200]])
    want = cart_frontier_candidates(resident, *args)
    got = cart_frontier_candidates(streamed, *args)
    for g, w in zip(got, want):
        assert g["winner"] == w["winner"]
        np.testing.assert_array_equal(g["winner_bits"], w["winner_bits"])
        np.testing.assert_array_equal(g["equiv"], w["equiv"])
    assert 17 in want[0]["equiv"] and 20001 in want[0]["equiv"]


def test_deinterleave_kernel(cuda):
    """The artifact's matrix split at phase 3's cases (an odd W64, a ragged
    last chunk, one-column chunks, 32 x odd genomes, widths that are no
    multiple of 4, no k-mer): the chunked split on the card against the
    host split and the plain version, one launch a chunk; the wrapper alone
    at an odd offset; the split behind a busy stream; the default width's
    load under the matrix plus three chunks."""
    smoke.deinterleave_cases(cuda, np.random.RandomState(14), _record)


@pytest.mark.parametrize("n_rows,k,chunk_cols", [
    (342, 200_003, None), (342, 200_003, 65_536), (96, 5001, 1000),
    (5022, 40_000, 8192)])
def test_from_u64_on_the_card_equals_cpu(cuda, monkeypatch, n_rows, k,
                                         chunk_cols):
    """BitMatrix.from_u64 on the card equals its CPU run, and one load
    launches deinterleave_u64 once a chunk (once where one chunk holds
    every column); ``chunk_cols`` makes LOAD_CHUNK_BYTES that small."""
    from grm_tpu_torch.ops import _build

    rng = np.random.RandomState(n_rows + k)
    w64 = -(-n_rows // 64)
    m64 = np.frombuffer(rng.bytes(8 * w64 * k), np.uint64).reshape(w64, k)
    if chunk_cols is not None:
        monkeypatch.setattr(pc, "LOAD_CHUNK_BYTES", 8 * w64 * chunk_cols)
    n0 = _build.launches["deinterleave_u64"]
    got = pc.BitMatrix.from_u64(m64, n_rows, cuda)
    torch.cuda.synchronize()
    n_chunks = -(-k // pc.load_chunk_cols(w64))
    assert _build.launches["deinterleave_u64"] - n0 == n_chunks
    if chunk_cols is None and k * w64 * 8 <= pc.LOAD_CHUNK_BYTES:
        assert n_chunks == 1
    _same(got.data, pc.BitMatrix.from_u64(m64, n_rows, "cpu").data)


def test_from_u64_peak_memory(cuda):
    """A load of 342 x 4,000,001 in the default chunks (three, the last
    ragged) holds at most the matrix plus three staging chunks on the card,
    and gives the host split's words."""
    rng = np.random.RandomState(3)
    k = 4_000_001
    m64 = np.frombuffer(rng.bytes(8 * 6 * k), np.uint64).reshape(6, k)
    bm, peak, bound = smoke.load_peak(
        lambda: pc.BitMatrix.from_u64(m64, 342, cuda), 11, k)
    assert 0 < peak <= bound
    _same(bm.data, torch.from_numpy(
        pc.u64_matrix_to_u32(m64)[:11].view(np.int32)))


# -- the sharded engines on meshes of a repeated card --------------------------

def _card_mesh(rows=1, n=4):
    from grm_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, row_devices=rows,
                     devices=[torch.device("cuda", 0)] * n)


def _sharded_pair(cuda, rng, rows=1, n_kmers=40003):
    """(labels, resident BitMatrix, the same matrix over a mesh of four
    cuda:0): K = 40,003 leaves the last of 4 shards 3 padding columns."""
    from grm_tpu_torch.parallel.mesh import MeshSharding

    labels, resident, _ = _streamed_pair(cuda, rng, n_kmers=n_kmers)
    packed = resident.data.cpu().numpy().view(np.uint32)
    sharded = pc.BitMatrix(packed, resident.n_rows,
                           columns_sharding=MeshSharding(_card_mesh(rows)))
    return labels, resident, sharded


def _cv_fits(resident, labels, with_lookup=False):
    from grm_tpu_torch.parallel.scm_exact import _make_risk_lookup

    rng = np.random.RandomState(3)
    k = resident.n_columns
    fits = []
    for model_type in ("conjunction", "disjunction"):
        for p in (0.5, 1.0, 4.0):
            pos = np.where(labels == 1)[0]
            neg = np.where(labels == 0)[0]
            if model_type == "disjunction":
                pos, neg = neg, pos
            fit = {"pos_mask": resident.row_mask(pos[5:]),
                   "neg_mask": resident.row_mask(neg[5:]),
                   "test_pos_mask": resident.row_mask(pos[:5]),
                   "test_neg_mask": resident.row_mask(neg[:5]),
                   "p": p, "model_type": model_type}
            if with_lookup:
                fit["risk_lookup"] = _make_risk_lookup(rng.rand(k),
                                                       rng.rand(k), k)
            fits.append(fit)
    return fits


def test_sharded_counts_and_load_on_the_card(cuda):
    """Column sums over a (2, 2) mesh of cuda:0 (the row shards' sums
    added) equal the resident sweep; the sharded load from the uint64
    layout equals the CPU's placement, shard for shard."""
    from grm_tpu_torch.parallel.mesh import MeshSharding

    rng = np.random.RandomState(21)
    labels, resident, sharded = _sharded_pair(cuda, rng, rows=2)
    rows = [np.where(labels == 1)[0], np.arange(0, 342, 3)]
    np.testing.assert_array_equal(sharded.presence_counts(rows),
                                  resident.presence_counts(rows))
    m64 = rng.randint(0, 2**63, size=(6, 5003), dtype=np.int64).astype(
        np.uint64)
    for mesh in (_card_mesh(), _card_mesh(2)):
        card = pc.BitMatrix.from_u64(m64, 342, sharding=MeshSharding(mesh))
        host = pc.BitMatrix.from_u64(m64, 342, sharding=MeshSharding(
            type(mesh)([[torch.device("cpu")] * len(r) for r in
                        mesh.devices])))
        for rc, rh in zip(card.data.shards, host.data.shards):
            for a, b in zip(rc, rh):
                _same(a, b)
        cols = np.array([0, 1250, 1251, 5002])
        np.testing.assert_array_equal(card.get_columns_dense(cols),
                                      host.get_columns_dense(cols))


@pytest.mark.parametrize("blacklist", [False, True])
def test_sharded_grid_engine_equals_unsharded_on_the_card(cuda, blacklist):
    from grm_tpu_torch.parallel.scm_grid import (scm_cv_grid_device,
                                                 scm_cv_grid_sharded)

    labels, resident, sharded = _sharded_pair(cuda,
                                              np.random.RandomState(5))
    k = resident.n_columns
    fits = _cv_fits(resident, labels)
    excl = [17, 17 + k, 20001, 39999, 40002 + k] if blacklist else None
    want = scm_cv_grid_device(resident.data, fits, k, 6, excl_rules=excl)
    got = scm_cv_grid_sharded(sharded.data, fits, k, 6,
                              sharded.data.mesh, excl_rules=excl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sharded_scan_engine_equals_grid_on_the_card(cuda):
    """The scan engine on a (2, 2) mesh of cuda:0 gives the unsharded grid
    engine's rules (both pure argmax) and its own unsharded run's risks."""
    from grm_tpu_torch.parallel.scm_device import scm_cv_batch_device
    from grm_tpu_torch.parallel.scm_grid import scm_cv_grid_device

    labels, resident, sharded = _sharded_pair(cuda, np.random.RandomState(6),
                                              rows=2)
    k = resident.n_columns
    fits = _cv_fits(resident, labels)
    got = scm_cv_batch_device(sharded.data, fits, k, 6)
    want = scm_cv_batch_device(resident.data, fits, k, 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        got[0], scm_cv_grid_device(resident.data, fits, k, 6)[0])


def test_sharded_exact_scm_engine_equals_resident_on_the_card(cuda):
    from grm_tpu_torch.parallel.scm_exact import ExactScmEngine

    labels, resident, sharded = _sharded_pair(cuda, np.random.RandomState(4))
    k = resident.n_columns
    fits = _cv_fits(resident, labels, with_lookup=True)
    want = ExactScmEngine(resident.data, k).run_fits(fits, 5, True)
    got = ExactScmEngine(sharded.data, k).run_fits(fits, 5, True)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert [[t.tolist() for t in f] for f in got[4]] == \
        [[t.tolist() for t in f] for f in want[4]]


@pytest.mark.parametrize("criterion", cs.CRITERIA)
def test_sharded_cart_engines_equal_resident_on_the_card(cuda, criterion):
    """The argmax scorer and the exact engine's payloads over four shards
    of cuda:0 equal the resident runs: two classes (tuple tables) and three
    (the root's lattice past 65,536: the gather regime)."""
    from grm_tpu_torch.parallel.cart_device import (
        cart_frontier_splits_device, cart_frontier_splits_sharded)
    from grm_tpu_torch.parallel.cart_exact import cart_frontier_candidates

    labels, resident, sharded = _sharded_pair(cuda, np.random.RandomState(7))
    mesh = sharded.data.mesh
    idx = np.arange(len(labels))
    for classes in (2, 3):
        y = labels if classes == 2 else idx % 3
        nodes = [{c: idx[y == c] for c in range(classes)},
                 {c: idx[y == c][:40] for c in range(classes)}]
        priors = {c: 1.0 / classes for c in range(classes)}
        totals = {c: float((y == c).sum()) for c in range(classes)}
        excl = np.zeros(resident.n_columns, bool)
        excl[[17, 40002]] = True
        for ex in (None, excl):
            assert cart_frontier_splits_sharded(
                resident, nodes, priors, totals, criterion, mesh,
                excl=ex) == cart_frontier_splits_device(
                    resident, nodes, priors, totals, criterion, excl=ex)
        args = (nodes, priors, totals, criterion, [idx, idx[:200]])
        want = cart_frontier_candidates(resident, *args)
        got = cart_frontier_candidates(sharded, *args, mesh=mesh)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in g:
                if isinstance(g[key], dict):
                    for c in g[key]:
                        np.testing.assert_array_equal(g[key][c], w[key][c])
                else:
                    np.testing.assert_array_equal(g[key], w[key])
        if classes == 3:
            assert "cols" in want[0]  # the gather regime ran
