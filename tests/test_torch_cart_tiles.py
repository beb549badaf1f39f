"""What Python holds of the tensor-core ``cart_sweep`` kernel: the layout of
the class masks as the 1-bit tile product's B operand
(``grm_tpu_torch.ops.cart_sweep.pack_mask_tiles``) and the launch plan
(``frontier_plan``). The kernel itself runs only on a GPU
(``tests/test_torch_cuda.py``); here a numpy emulation of
``mma.m16n8k128 ... and.popc``, fragment by fragment as
``csrc/bmma_tile.cuh`` documents it, runs over the packed tiles and must
give ``popcount_colsum_plain``'s counts exactly, for every (node, class,
column) and for frontiers, class counts and depths that leave ragged tiles.

These are checks of layout and plans, not of parity with ``grm_tpu``: they
hold the port against itself. Parity rests on a chain of three: the plain
PyTorch version against ``grm_tpu`` (``tests/test_torch_cart_ops.py``,
``tests/test_torch_learn_cart.py``), the kernel against that plain version
on a GPU (``tests/test_torch_cuda.py``), and this file for what the kernel
is handed.
"""

import numpy as np
import pytest
import torch

from grm_tpu_torch.ops import cart_sweep as cs
from grm_tpu_torch.ops.popcount import popcount_colsum_plain

NODES = [1, 7, 8, 9, 18, 37]
CLASSES = [2, 3, 5]
WORDS = [11, 12, 13]
K = 45  # two whole 16-column warp tiles and a ragged third


def _masks(n, c, w, seed):
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 2**32, size=(n, c, w), dtype=np.uint64)
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


def _unpack_mask_tiles(tiles, n, c, w):
    """The inverse of pack_mask_tiles: (N, C, W) masks, and whether every
    word of the tiles outside them is zero."""
    groups, pairs, steps, lanes = tiles.shape
    assert lanes == cs.TILE_LANES
    padded = (tiles.view(groups, pairs, steps, cs.TILE_NODES, 2,
                         cs.TILE_WORDS)
              .permute(0, 3, 1, 4, 2, 5)
              .reshape(groups * cs.TILE_NODES, 2 * pairs,
                       steps * cs.TILE_WORDS))
    rest = padded.clone()
    rest[:n, :c, :w] = 0
    return padded[:n, :c, :w], bool((rest == 0).all())


def _popc(x):
    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8)
                         .reshape(x.shape + (4,)), axis=-1).sum(-1, dtype=np.int64)


def _mma_and_popc_k128(d, a, b):
    """One warp's mma.sync.m16n8k128.row.col.s32.b1.b1.s32.and.popc on
    fragments: d (32, 4) int accumulators, a (32, 2) and b (32,) uint32
    registers per lane. Lane 4 * g + t holds word t of A's rows g (a0) and
    g + 8 (a1) and of B's column g; d0, d1 are row g, columns 2t, 2t + 1,
    and d2, d3 row g + 8."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    a_rows = np.zeros((16, 4), np.uint32)
    a_rows[g, t] = a[:, 0]
    a_rows[g + 8, t] = a[:, 1]
    b_cols = np.zeros((8, 4), np.uint32)
    b_cols[g, t] = b
    prod = _popc(a_rows[:, None, :] & b_cols[None, :, :]).sum(-1)  # (16, 8)
    out = d.copy()
    for e in range(4):
        out[:, e] += prod[g + 8 * (e // 2), 2 * t + e % 2]
    return out


def _tile_counts(matrix, tiles, n, c):
    """left[n, c, k] as the kernel counts it: per 16-column warp tile, per
    group of 4 nodes and class pair, one tile product per 128-bit step with
    A read from ``matrix`` as fragments (zero past the last word and
    column) and B from ``tiles``; thread (g, t) then holds node t's counts
    for columns g (d0, d1) and g + 8 (d2, d3)."""
    matrix = matrix.numpy().view(np.uint32)
    tiles = tiles.numpy().view(np.uint32)
    w, k = matrix.shape
    groups, pairs, steps, _ = tiles.shape
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    left = np.zeros((groups * cs.TILE_NODES, 2 * pairs, k), np.int64)
    for c0 in range(0, k, 16):
        cols = np.stack([c0 + g, c0 + g + 8], axis=1)  # (32, 2)
        for grp in range(groups):
            for q in range(pairs):
                d = np.zeros((32, 4), np.int64)
                for s in range(steps):
                    word = cs.TILE_WORDS * s + t
                    ok = (word[:, None] < w) & (cols < k)
                    a = np.where(ok, matrix[np.minimum(word, w - 1)[:, None],
                                            np.minimum(cols, k - 1)], 0)
                    d = _mma_and_popc_k128(d, a.astype(np.uint32),
                                           tiles[grp, q, s])
                for h in range(2):
                    live = cols[:, h] < k
                    for e in range(2):
                        left[cs.TILE_NODES * grp + t[live], 2 * q + e,
                             cols[live, h]] = d[live, 2 * h + e]
    return left[:n, :c]


@pytest.mark.parametrize("w", WORDS)
@pytest.mark.parametrize("c", CLASSES)
@pytest.mark.parametrize("n", NODES)
def test_mask_tiles_round_trip(n, c, w):
    masks = _masks(n, c, w, 100 * n + 10 * c + w)
    tiles = cs.pack_mask_tiles(masks)
    groups, pairs, steps = cs.tile_plan(n, c, w)
    assert (groups, pairs, steps) == (-(-n // 4), -(-c // 2), -(-w // 4))
    assert tiles.shape == (groups, pairs, steps, 32)
    assert tiles.dtype == torch.int32 and tiles.is_contiguous()
    back, rest_is_zero = _unpack_mask_tiles(tiles, n, c, w)
    assert torch.equal(back, masks)
    assert rest_is_zero  # empty nodes, the empty class, the depth's padding
    # One word by the documented index: node 4g + j, class 2q + e, word
    # 4s + t sits in lane 4 * (2j + e) + t of tile [g, q, s].
    node, cls, word = n - 1, c - 1, w - 1
    assert tiles[node // 4, cls // 2, word // 4,
                 4 * (2 * (node % 4) + cls % 2) + word % 4] \
        == masks[node, cls, word]


@pytest.mark.parametrize("w", WORDS)
@pytest.mark.parametrize("c", CLASSES)
@pytest.mark.parametrize("n", NODES)
def test_tile_product_equals_popcount_colsum(n, c, w):
    seed = 7 * n + 3 * c + w
    masks = _masks(n, c, w, seed)
    matrix = _masks(1, w, K, seed + 1)[0]  # (W, K) random words
    want = popcount_colsum_plain(matrix, masks.reshape(n * c, w))
    got = _tile_counts(matrix, cs.pack_mask_tiles(masks), n, c)
    assert np.array_equal(got.reshape(n * c, K), want.numpy())


@pytest.mark.parametrize("c,c_inst", [(2, 2), (3, 3), (4, 4), (5, 6), (6, 6),
                                      (7, 8), (8, 8)])
def test_frontier_plan_fills_classes_up_to_an_instantiation(c, c_inst):
    got_c, groups_per_row, smem = cs.frontier_plan(18, c, 11)
    assert got_c == c_inst
    assert groups_per_row == 5  # 18 nodes: 5 groups of 4, one grid row
    assert smem <= 48 << 10


def test_frontier_plan_splits_wide_frontiers_over_grid_rows():
    # The largest published genome count (W = 157) x 200 nodes: the masks
    # pass one block's budget, so the groups split over grid rows.
    c_inst, groups_per_row, smem = cs.frontier_plan(200, 2, 157)
    assert c_inst == 2 and 1 <= groups_per_row < 50
    assert smem <= 64 << 10
    assert cs.frontier_plan(1, 2, 1)[1] == 1


@pytest.mark.parametrize("c", [0, 1, 9])
def test_frontier_plan_rejects_class_counts_the_kernel_lacks(c):
    with pytest.raises(ValueError, match="at least 2 and at most 8"):
        cs.frontier_plan(4, c, 11)


def test_frontier_plan_rejects_masks_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        cs.frontier_plan(4, 8, 4000)


def test_table_plan_keeps_tables_for_two_classes_within_the_budget():
    assert cs.table_plan(18, 2, 11) == (16 * 11 + 1) ** 2
    assert cs.table_plan(18, 3, 11) == 0  # more classes score directly
    assert cs.table_plan(200, 2, 157) == 0  # 200 tables of 2513^2 entries
    assert cs.table_plan(2, 2, 157) == (16 * 157 + 1) ** 2
    # Disjoint class masks over 32 w examples never need more than the cap.
    for n0 in range(0, 32 * 11 + 1, 16):
        assert (n0 + 1) * (32 * 11 - n0 + 1) <= cs.table_plan(1, 2, 11)


@pytest.mark.parametrize("criterion", cs.CRITERIA)
@pytest.mark.parametrize("n", [1, 5, 18])
def test_score_table_lookup_equals_direct_scores(n, criterion):
    """The kernel's two-class path: entry a * (n1 + 1) + b of a node's table
    is child(a, b) + child(n0 - a, n1 - b), +inf at the first and the last
    entry; one look-up at the left counts must give the plain version's
    score of every (node, column), bit for bit."""
    rng = np.random.RandomState(n)
    n_genomes, k = 342, 600
    w = -(-n_genomes // 32)
    matrix = _masks(1, w, k, n + 50)[0]
    masks = np.zeros((n, 2, w), np.uint32)
    owner = rng.randint(0, 3, size=(n, n_genomes))  # class 0, 1 or neither
    if n > 1:
        owner[-1] = 2
        owner[-1, 7] = 0  # one example: no valid split
    bits = np.uint32(1) << (31 - np.arange(n_genomes) % 32).astype(np.uint32)
    for i in range(n):
        for c in range(2):
            rows = np.where(owner[i] == c)[0]
            np.bitwise_or.at(masks[i, c], rows // 32, bits[rows])
    masks = torch.from_numpy(masks.view(np.int32))
    n_node = torch.from_numpy(
        np.stack([(owner == c).sum(1) for c in range(2)], 1).astype(np.int32))
    scale = torch.from_numpy(((rng.rand(n, 2) + 0.1) / 300).astype(np.float32))

    left = popcount_colsum_plain(matrix, masks.reshape(2 * n, w)).view(n, 2, k)
    want, _ = cs.cart_sweep_blocks_plain(matrix, masks, n_node, scale,
                                         criterion, k, 1)  # a block a column
    cap = cs.table_plan(n, 2, w)
    for i in range(n):
        n0, n1 = (int(x) for x in n_node[i])
        assert (n0 + 1) * (n1 + 1) <= cap
        a = torch.arange(n0 + 1).repeat_interleave(n1 + 1)[None, :]
        b = torch.arange(n1 + 1).repeat(n0 + 1)[None, :]
        s0, s1 = scale[i, 0], scale[i, 1]
        table = (cs._child([s0 * a.float(), s1 * b.float()], criterion)
                 + cs._child([s0 * (n0 - a).float(), s1 * (n1 - b).float()],
                             criterion))[0]
        table[0] = table[-1] = torch.inf
        got = table[left[i, 0] * (n1 + 1) + left[i, 1]]
        assert torch.equal(got, want[:, i])
    if n > 1:
        assert torch.isinf(want[:, -1]).all()
