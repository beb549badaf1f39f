"""What Python holds of the tensor-core ``scm_sweep`` kernel: the fits'
masks as the 1-bit tile product's B operand (``grm_tpu_torch.ops.tiles.
pack_mask_tiles`` over the (F, 2, W) stack of neg and pos), the kernel's
re-layout of them in shared memory, its float conversion of the counts, its
epilogues and the launch plan (``scm_sweep.sweep_plan``). The kernel itself
runs only on a GPU (``tests/test_torch_cuda.py``); here a numpy emulation
of ``mma.m16n8k128 ... and.popc``, fragment by fragment as
``csrc/bmma_tile.cuh`` documents it, runs over the packed tiles as
``csrc/scm_sweep.cu`` does and must give ``popcount_colsum_plain``'s counts
exactly, for fit counts and depths that leave ragged tiles, and the
emulated epilogues must give the plain versions' block results bit for bit.

Past 512 genomes the kernel's deep build stages the matrix through a ring
in shared memory: ``_deep_counts`` emulates it, stage by stage as the
producer warp writes them (the swizzled rows, the columns it does not
write left as garbage), the consumer warps' fragment reads and k256
products, their groups, and the grid rows.

These are checks of layout and plans, not of parity with ``grm_tpu``: they
hold the port against itself. Parity rests on a chain of three: the plain
PyTorch version against ``grm_tpu`` (``tests/test_torch_ops.py``,
``tests/test_torch_scm_grid.py``), the kernel against that plain version on
a GPU (``tests/test_torch_cuda.py``), and this file for what the kernel is
handed.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from grm_tpu_torch.ops import scm_sweep as sw
from grm_tpu_torch.ops import tiles
from grm_tpu_torch.ops.popcount import popcount_colsum_plain

FITS = [1, 3, 4, 5, 99, 100, 128]
WORDS = [1, 4, 5, 11, 12, 13, 157]
K = 45  # two whole 16-column warp tiles and a ragged third
MAGIC = 0x4B000000  # the accumulators' start: the bits of 2^23 as a float
CHUNK = 4  # steps of one 16-byte load of B
SOURCE = Path(sw.__file__).resolve().parent.parent / "csrc" / "scm_sweep.cu"
# The deep build's constants (csrc/scm_sweep.cu; test_deep_emulation_
# mirrors_the_source holds them to it).
DEEP_WARPS, WARP_GROUPS = 8, 4
STAGE_TILES, STAGE_WORDS = 4, 32
STAGE_COLS = 16 * STAGE_TILES


def _words(shape, seed):
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 2**32, size=shape, dtype=np.uint64)
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


def _popc(x):
    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8)
                         .reshape(x.shape + (4,)), axis=-1).sum(
                             -1, dtype=np.int64)


def _mma_and_popc_k128(d, a, b):
    """mma.sync.m16n8k128.row.col.s32.b1.b1.s32.and.popc for T warps at
    once: d (T, 32, 4) int64 accumulators, a (T, 32, 2) and b (32,) uint32
    registers per lane. Lane 4 * g + t holds word t of A's rows g (a0) and
    g + 8 (a1) and of B's column g; d0, d1 are row g, columns 2t, 2t + 1,
    and d2, d3 row g + 8."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    n = a.shape[0]
    a_rows = np.zeros((n, 16, 4), np.uint32)
    a_rows[:, g, t] = a[:, :, 0]
    a_rows[:, g + 8, t] = a[:, :, 1]
    b_cols = np.zeros((8, 4), np.uint32)
    b_cols[g, t] = b
    prod = _popc(a_rows[:, :, None, :] & b_cols[None, None]).sum(-1)
    out = d.copy()
    for e in range(4):
        out[:, :, e] += prod[:, g + 8 * (e // 2), 2 * t + e % 2]
    return out


def _mma_and_popc_k256(d, a, b):
    """The k256 form: a (T, 32, 4) holds word t (a0 rows g, a1 rows g + 8)
    and word 4 + t (a2, a3) of the same rows, b (32, 2) words t and 4 + t of
    column g: two k128 steps in one product."""
    d = _mma_and_popc_k128(d, a[:, :, :2], b[:, 0])
    return _mma_and_popc_k128(d, a[:, :, 2:], b[:, 1])


def _shared_b(packed):
    """The kernel's shared-memory copy of the packed tiles: [group][chunk]
    [lane][e] = word e of 4-step chunk ``chunk``, zero on the padding
    steps."""
    groups, pairs, steps, lanes = packed.shape
    assert pairs == 1 and lanes == tiles.TILE_LANES
    chunks = -(-steps // CHUNK)
    s_b = np.zeros((groups, chunks * CHUNK, lanes), np.uint32)
    s_b[:, :steps] = packed[:, 0].numpy().view(np.uint32)
    return s_b.reshape(groups, chunks, CHUNK, lanes).transpose(0, 1, 3, 2)


def _tile_counts(matrix, packed, f, wide=False):
    """(cn, cp) (F, K) as the kernel counts them: per 16-column warp tile
    and group of 4 fits, accumulators that start at MAGIC, one tile product
    per 128-bit step with A read from ``matrix`` as fragments (zero past the
    last word and column) and B from the shared-memory copy; thread (g, t)
    then holds fit t's cn, cp for column g in d0, d1 and for g + 8 in d2,
    d3, and one float subtraction of 2^23 gives each count. ``wide``: the
    common case's chain of two products over 3 or 4 steps (at most 16
    words), a k256 over steps 0 and 1, then a k128 or a k256."""
    matrix = matrix.numpy().view(np.uint32)
    w, k = matrix.shape
    s_b = _shared_b(packed)
    groups, chunks = s_b.shape[:2]
    steps = packed.shape[2]
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    c0 = np.arange(0, k, 16)
    cols = np.stack([c0[:, None] + g, c0[:, None] + g + 8], axis=2)  # T,32,2
    counts = np.zeros((2, groups * tiles.TILE_NODES, k), np.float32)
    fit_of_lane = np.broadcast_to(t, cols.shape[:2])

    def frag(step):  # A fragments of one step, (T, 32, 2)
        word = tiles.TILE_WORDS * step + t
        ok = (word[None, :, None] < w) & (cols < k)
        return np.where(ok, matrix[np.minimum(word, w - 1)[None, :, None],
                                   np.minimum(cols, k - 1)],
                        0).astype(np.uint32)

    for grp in range(groups):
        d = np.full((len(c0), 32, 4), MAGIC, np.int64)
        if wide:
            assert steps <= CHUNK
            chain = (3, 4)[steps > 3]
            for s0 in range(0, chain, 2):
                if s0 + 1 < chain:
                    d = _mma_and_popc_k256(
                        d, np.concatenate([frag(s0), frag(s0 + 1)], 2),
                        s_b[grp, 0, :, s0:s0 + 2])
                else:
                    d = _mma_and_popc_k128(d, frag(s0), s_b[grp, 0, :, s0])
        for step in range(0 if wide else steps):
            d = _mma_and_popc_k128(d, frag(step),
                                   s_b[grp, step // CHUNK, :, step % CHUNK])
        as_float = d.astype(np.uint32).view(np.float32) - np.float32(2**23)
        for h in range(2):
            live = cols[:, :, h] < k
            for e in range(2):  # e = 0: neg (cn), 1: pos (cp)
                counts[e, tiles.TILE_NODES * grp + fit_of_lane[live],
                       cols[:, :, h][live]] = as_float[:, :, 2 * h + e][live]
    return counts[0, :f], counts[1, :f]


@pytest.mark.parametrize("w", WORDS)
@pytest.mark.parametrize("f", FITS)
def test_tile_product_equals_popcount_colsum(f, w):
    seed = 11 * f + w
    neg, pos = _words((f, w), seed), _words((f, w), seed + 1)
    matrix = _words((w, K), seed + 2)
    packed = tiles.pack_mask_tiles(torch.stack([neg, pos], 1))
    groups, pairs, steps = tiles.tile_plan(f, 2, w)
    assert packed.shape == (groups, 1, steps, 32) and pairs == 1
    cn, cp = _tile_counts(matrix, packed, f)
    assert np.array_equal(cn, popcount_colsum_plain(matrix, neg).numpy())
    assert np.array_equal(cp, popcount_colsum_plain(matrix, pos).numpy())


@pytest.mark.parametrize("w", [w for w in WORDS if w <= 16])
@pytest.mark.parametrize("f", FITS)
def test_wide_chain_equals_popcount_colsum(f, w):
    """The common case's chain (k256 + k128 at 3 steps, k256 + k256 at 4;
    fewer steps multiply zero A words) counts what the k128 steps count."""
    seed = 13 * f + w
    neg, pos = _words((f, w), seed), _words((f, w), seed + 1)
    matrix = _words((w, K), seed + 2)
    packed = tiles.pack_mask_tiles(torch.stack([neg, pos], 1))
    cn, cp = _tile_counts(matrix, packed, f, wide=True)
    assert np.array_equal(cn, popcount_colsum_plain(matrix, neg).numpy())
    assert np.array_equal(cp, popcount_colsum_plain(matrix, pos).numpy())


def test_count_as_float_is_exact_below_two_to_the_23():
    n = np.concatenate([np.arange(0, 1 << 16), np.arange(0, 1 << 23, 4099),
                        [(1 << 23) - 1]]).astype(np.int64)
    got = (n + MAGIC).astype(np.uint32).view(np.float32) - np.float32(2**23)
    assert np.array_equal(got, n.astype(np.float32))


def _deep_s_b(packed):
    """The deep build's shared-memory copy of the packed tiles: [group]
    [k256 step][lane][e] = the lane's word of k128 step 2 s + e, zero on
    the half step that pads an odd count."""
    groups, pairs, steps, lanes = packed.shape
    assert pairs == 1 and lanes == tiles.TILE_LANES
    s256 = -(-steps // 2)
    s_b = np.zeros((groups, 2 * s256, lanes), np.uint32)
    s_b[:, :steps] = packed[:, 0].numpy().view(np.uint32)
    return s_b.reshape(groups, s256, 2, lanes).transpose(0, 1, 3, 2)


def _stage(matrix, c0, d, col_hi, rng):
    """Ring stage d of the column tile from c0 on, as the producer warp
    leaves it: word row 32 d + r of column c0 + c at [r, c ^ 8 (r & 3)],
    for the rows below W and the columns below col_hi only; the rest holds
    whatever an earlier stage left (random words here)."""
    w = matrix.shape[0]
    stage = rng.randint(0, 2**32, size=(STAGE_WORDS, STAGE_COLS),
                        dtype=np.uint64).astype(np.uint32)
    rows = np.arange(min(STAGE_WORDS, w - d * STAGE_WORDS))
    cols = np.arange(min(STAGE_COLS, col_hi - c0))
    stage[rows[:, None], cols[None, :] ^ (8 * (rows[:, None] & 3))] = \
        matrix[d * STAGE_WORDS + rows[:, None], c0 + cols[None, :]]
    return stage


def _fragments(stage, s):
    """The A fragments of k256 step s of a stage for the 4 tiles, (4, 32,
    4): lane 4 g + t reads rows 8 s + t (a0, a1) and 8 s + 4 + t (a2, a3)
    at columns (16 u + g) ^ 8 t (a0, a2) and that ^ 8 (a1, a3)."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    col = (16 * np.arange(STAGE_TILES)[:, None] + g[None, :]) ^ (8 * t)
    r0, r1 = 8 * s + t, 8 * s + 4 + t
    return np.stack([stage[r0, col], stage[r0, col ^ 8],
                     stage[r1, col], stage[r1, col ^ 8]], -1)


def _deep_counts(matrix, packed, f, limit, block, seed=0):
    """(cn, cp) (F, K) as the deep build counts them, -1 past each block's
    last live column (padding, never taken): blocks of ``block`` columns,
    the groups spread over grid rows (``sw.sweep_plan``) and each row's
    over its consumer warps (warp w: groups w + 8 i; a warp
    short of 4 repeats its last group's products), the column tiles of 64
    staged 32 word rows at a time, 4 k256 products a stage for each of the
    warp's 16 chains of (tile, group), accumulators from MAGIC."""
    rng = np.random.RandomState(seed)
    matrix = matrix.numpy().view(np.uint32)
    w, k = matrix.shape
    s_b = _deep_s_b(packed)
    groups, s256 = s_b.shape[:2]
    chunks = -(-s256 // (STAGE_WORDS // 8))
    gpr, rows, _ = sw.sweep_plan(f, w)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    counts = np.full((2, groups * tiles.TILE_NODES, k), -1.0, np.float32)
    for blk in range(-(-k // block)):
        col_lo = blk * block
        col_hi = min(col_lo + block, limit, k)
        for row in range(rows):
            grp_lo = row * gpr
            ng = min(gpr, groups - grp_lo)
            assert ng > 0
            for c0 in range(col_lo, col_hi, STAGE_COLS):
                stages = [_stage(matrix, c0, d, col_hi, rng)
                          for d in range(chunks)]
                for warp in range(min(DEEP_WARPS, ng)):
                    gw = -(-(ng - warp) // DEEP_WARPS)
                    mine = [grp_lo + warp + DEEP_WARPS * min(i, gw - 1)
                            for i in range(WARP_GROUPS)]
                    acc = np.full((WARP_GROUPS, STAGE_TILES, 32, 4), MAGIC,
                                  np.int64)
                    for d, stage in enumerate(stages):
                        for s in range(min(STAGE_WORDS // 8,
                                           s256 - d * STAGE_WORDS // 8)):
                            a = _fragments(stage, s)
                            for i, grp in enumerate(mine):
                                acc[i] = _mma_and_popc_k256(
                                    acc[i], a,
                                    s_b[grp, d * STAGE_WORDS // 8 + s])
                    as_float = (acc.astype(np.uint32).view(np.float32)
                                - np.float32(2**23))
                    for i in range(gw):
                        fit = tiles.TILE_NODES * mine[i] + t
                        for u in range(STAGE_TILES):
                            for h in range(2):
                                col = c0 + 16 * u + 8 * h + g
                                live = col < col_hi
                                for e in range(2):
                                    counts[e, fit[live], col[live]] = \
                                        as_float[i, u, live, 2 * h + e]
    return counts[0, :f], counts[1, :f]


def _kernel_blocks(epi, matrix, neg, pos, n_neg, n_pos, ps, limit, block,
                   excl, deep=False):
    """The kernel's epilogue and reductions in numpy float32, over counts
    from the tile emulation (``deep``: the deep build's): per (fit, column)
    the utilities in the kernel's order, a min or max taken only where the
    column is neither padding nor excluded (and, for the argmax epilogue,
    not zero-covering: an integer test on cn + cp), then the extrema of
    each block."""
    f, w = neg.shape
    k = matrix.shape[1]
    packed = tiles.pack_mask_tiles(torch.stack([neg, pos], 1))
    if deep:
        cn, cp = _deep_counts(matrix, packed, f, limit, block)
    else:
        cn, cp = _tile_counts(matrix, packed, f)
    p = ps.numpy()[:, None]
    sum_ = (cn.astype(np.int64) + cp.astype(np.int64))
    pad = np.arange(k)[None, :] >= limit
    ex_p = pad | (excl[0].numpy()[None, :] != 0 if excl is not None else pad)
    ex_a = pad | (excl[1].numpy()[None, :] != 0 if excl is not None else pad)
    u_abs = cn - p * cp
    nb = -(-k // block)
    out = []
    if epi == "argmax":
        total = (n_neg + n_pos).numpy().astype(np.int64)[:, None]
        u_min = np.where((sum_ == total) | ex_p, np.inf, u_abs)
        u_max = np.where((sum_ == 0) | ex_a, -np.inf, u_abs)
        for b in range(nb):
            lo, hi = b * block, min(k, (b + 1) * block)
            out.append((np.minimum(u_min[:, lo:hi].min(1), sw._F32_MAX),
                        np.maximum(u_max[:, lo:hi].max(1), -sw._F32_MAX)))
        return (np.stack([o[0] for o in out]).astype(np.float32),
                np.stack([o[1] for o in out]).astype(np.float32))
    nn = n_neg.numpy().astype(np.float32)[:, None]
    np_ = n_pos.numpy().astype(np.float32)[:, None]
    u_pres = (nn - cn) - p * (np_ - cp)
    both = np.maximum(np.where(ex_p, -np.inf, u_pres),
                      np.where(ex_a, -np.inf, u_abs))
    return np.stack([both[:, b * block:(b + 1) * block].max(1)
                     for b in range(nb)], 1).astype(np.float32)


@pytest.mark.parametrize("excl_on", [False, True])
@pytest.mark.parametrize("grid", ["published", "dyadic"])
@pytest.mark.parametrize("epi", ["argmax", "sbmax"])
@pytest.mark.parametrize("f,w", [(5, 11), (13, 1), (9, 13)])
def test_emulated_epilogues_equal_the_plain_versions(f, w, epi, grid,
                                                     excl_on):
    rng = np.random.RandomState(f + w)
    k, block, limit = 300, 64, 291
    matrix = _words((w, k), f)
    neg = _words((f, w), f + 1)
    pos = torch.from_numpy(~neg.numpy() & _words((f, w), f + 2).numpy())
    if w > 1:  # a fit that covers everything and one that covers nothing
        matrix[:, 7] = -1
        matrix[:, 8] = 0
    count = lambda m: torch.from_numpy(
        _popc(m.numpy().view(np.uint32)).sum(1).astype(np.int32))
    p_values = ([0.1, 0.178, 0.316, 0.562, 1.0, 1.778, 3.162, 5.623, 10.0,
                 999999.0] if grid == "published" else [0.5, 1.0, 2.0, 4.0])
    ps = torch.tensor(p_values, dtype=torch.float32)[torch.arange(f)
                                                      % len(p_values)]
    excl = None
    if excl_on:
        excl = torch.from_numpy((rng.rand(2, k) < 0.3).astype(np.uint8))
        excl[:, 32:48] = 1  # a whole 16-column tile banned in both rows
    args = (matrix, neg, pos, count(neg), count(pos), ps, limit, block, excl)
    got = _kernel_blocks(epi, *args)
    if epi == "argmax":
        want = sw.scm_sweep_argmax_blocks_plain(*args)
        assert np.array_equal(got[0], want[0].numpy())
        assert np.array_equal(got[1], want[1].numpy())
    else:
        assert np.array_equal(got, sw.scm_sweep_sbmax_plain(*args).numpy())


def _as_the_common_case_reads(matrix, excl, limit, block):
    """The matrix and mask as the kernel's common case reads them: each run
    of 64 columns of a block (from the block's first column on) that ends
    before the limit, bans no rule alone and no 16-column tile whole has
    every column banned in both rows replaced by a copy of the run's first
    unbanned column, which is then not banned."""
    matrix, excl = matrix.clone(), excl.clone()
    k = matrix.shape[1]
    for lo in range(0, k, block):
        hi = min(k, lo + block, limit)
        for c0 in range(lo, hi - 63, 64):
            ex = excl[:, c0:c0 + 64].numpy() != 0
            both = ex[0] & ex[1]
            if (ex[0] != ex[1]).any() or both.reshape(4, 16).all(1).any():
                continue
            if both.any():
                src = c0 + int(np.argmin(both))
                cols = c0 + np.nonzero(both)[0]
                matrix[:, cols] = matrix[:, src:src + 1]
                excl[:, cols] = 0
    return matrix, excl


@pytest.mark.parametrize("block", [300, 512])
@pytest.mark.parametrize("share", [0.01, 0.3])
@pytest.mark.parametrize("epi", ["argmax", "sbmax"])
def test_banned_columns_read_as_copies_leave_the_blocks_unchanged(epi, share,
                                                                  block):
    """Under a k-mer blacklist the common case counts a column banned in
    both rows as a copy of an unbanned column of its run: min and max take
    that column twice, so the block results are the plain version's."""
    rng = np.random.RandomState(int(share * 100) + block)
    f, w, k, limit = 9, 11, 1500, 1493
    matrix = _words((w, k), 3)
    neg = _words((f, w), 4)
    pos = torch.from_numpy(~neg.numpy() & _words((f, w), 5).numpy())
    count = lambda m: torch.from_numpy(
        _popc(m.numpy().view(np.uint32)).sum(1).astype(np.int32))
    ps = torch.tensor([0.1, 0.178, 1.0, 999999.0, 0.5, 2.0, 3.162, 10.0, 4.0],
                      dtype=torch.float32)
    banned = rng.rand(k) < share
    excl = torch.from_numpy(np.stack([banned, banned]).astype(np.uint8))
    excl[0, 700] = 1 - excl[1, 700]  # a rule banned alone: one-tile path
    excl[:, 1040:1056] = 1  # a tile banned whole: one-tile path
    seen, seen_excl = _as_the_common_case_reads(matrix, excl, limit, block)
    assert not torch.equal(seen, matrix)
    args = (neg, pos, count(neg), count(pos), ps, limit, block)
    got = _kernel_blocks(epi, seen, *args, seen_excl)
    if epi == "argmax":
        want = sw.scm_sweep_argmax_blocks_plain(matrix, *args, excl)
        assert np.array_equal(got[0], want[0].numpy())
        assert np.array_equal(got[1], want[1].numpy())
    else:
        want = sw.scm_sweep_sbmax_plain(matrix, *args, excl)
        assert np.array_equal(got, want.numpy())


def test_sweep_plan_at_the_main_paths_shapes():
    # 100 and 120 fits over 342 genomes: one grid row, one pass.
    assert sw.sweep_plan(100, 11) == (25, 1, 25 * (512 + 64) + 32 * 256)
    assert sw.sweep_plan(120, 11) == (30, 1, 30 * (512 + 64) + 32 * 256)
    # A few fits: one row, the pass's 32 slots mostly empty.
    assert sw.sweep_plan(1, 1) == (1, 1, 1 * (512 + 64) + 32 * 256)
    assert sw.sweep_plan(40, 11)[:2] == (10, 1)
    # 256 fits: one row of 64 groups, two passes of 32.
    assert sw.sweep_plan(256, 11)[:2] == (64, 1)


def test_sweep_plan_splits_deep_masks_over_grid_rows():
    # The largest published genome count (W = 157: 20 k256 steps, 5,120
    # bytes of B a group) x 120 fits, the exact engine's launch: all 30
    # groups in one block beside a ring of 8 stages of 8 KB, one grid row:
    # the matrix is read once a launch.
    gpr, rows, smem = sw.sweep_plan(120, 157)
    assert (gpr, rows) == (30, 1)
    assert smem == 30 * (20 * 256 + 64) + 8 * (8192 + 16)
    assert smem == sw._smem_bytes(157, 30) <= sw._SMEM_MAX
    # 256 fits (64 groups) pass the 32 a block keeps: two grid rows.
    assert sw.sweep_plan(256, 157)[:2] == (32, 2)
    # 10,000 genomes (W = 313: 10,304 bytes a group): 120 fits over 2 rows
    # of 15 groups, 200 fits over 3 of 17; the ring keeps at least two
    # stages.
    assert sw.sweep_plan(120, 313)[:2] == (15, 2)
    assert sw.sweep_plan(200, 313)[:2] == (17, 3)
    assert sw._deep_group_bytes(313) == 10304
    ring = sw._smem_bytes(313, 17) - 17 * sw._deep_group_bytes(313)
    assert ring >= sw._MIN_STAGES * sw._STAGE_BYTES
    # Past 512 genomes (16 words) the deep build; a block keeps at most 32
    # groups, 4 a consumer warp, as a shallow pass keeps in registers.
    assert not sw._deep(16) and sw._deep(17)
    assert sw.sweep_plan(4, 16) == (1, 1, 512 + 64 + 32 * 256)
    assert sw.sweep_plan(4, 17) == (1, 1, 3 * 256 + 64 + 8 * (8192 + 16))
    # One group a block at 5,000 words: a grid row each.
    assert sw.sweep_plan(4 * 2000, 5000)[:2] == (1, 2000)


@pytest.mark.parametrize("w", [17, 32, 33, 157, 313])
@pytest.mark.parametrize("f", [1, 5, 120, 200])
def test_deep_staging_equals_popcount_colsum(f, w):
    """The deep build's counts, from the ring's swizzled stages (garbage
    where the producer writes nothing), equal the plain counts over every
    live column, at depths that leave a partial stage or half a k256 step,
    and fit counts that fill a block, several grid rows or neither."""
    seed = 7 * f + w
    k, block = 150, 128  # a full and a partial block; a partial tile each
    neg, pos = _words((f, w), seed), _words((f, w), seed + 1)
    matrix = _words((w, k), seed + 2)
    packed = tiles.pack_mask_tiles(torch.stack([neg, pos], 1))
    cn, cp = _deep_counts(matrix, packed, f, k, block, seed)
    assert np.array_equal(cn, popcount_colsum_plain(matrix, neg).numpy())
    assert np.array_equal(cp, popcount_colsum_plain(matrix, pos).numpy())


@pytest.mark.parametrize("excl_on", [False, True])
@pytest.mark.parametrize("epi", ["argmax", "sbmax"])
@pytest.mark.parametrize("f,w,block", [(5, 17, 256), (9, 33, 64),
                                       (37, 20, 96)])
def test_deep_epilogues_equal_the_plain_versions(f, w, block, epi, excl_on):
    """The deep build's blocks, with the limit inside a tile and a k-mer
    blacklist that bans rules alone and whole tiles, equal the plain
    versions bit for bit."""
    rng = np.random.RandomState(f + w + block)
    k, limit = 300, 291
    matrix = _words((w, k), f)
    neg = _words((f, w), f + 1)
    pos = torch.from_numpy(~neg.numpy() & _words((f, w), f + 2).numpy())
    matrix[:, 7] = -1
    matrix[:, 8] = 0
    count = lambda m: torch.from_numpy(
        _popc(m.numpy().view(np.uint32)).sum(1).astype(np.int32))
    ps = torch.tensor([0.1, 0.178, 1.0, 999999.0, 0.5],
                      dtype=torch.float32)[torch.arange(f) % 5]
    excl = None
    if excl_on:
        excl = torch.from_numpy((rng.rand(2, k) < 0.3).astype(np.uint8))
        excl[:, 64:80] = 1
    args = (matrix, neg, pos, count(neg), count(pos), ps, limit, block, excl)
    got = _kernel_blocks(epi, *args, deep=True)
    if epi == "argmax":
        want = sw.scm_sweep_argmax_blocks_plain(*args)
        assert np.array_equal(got[0], want[0].numpy())
        assert np.array_equal(got[1], want[1].numpy())
    else:
        assert np.array_equal(got, sw.scm_sweep_sbmax_plain(*args).numpy())


def test_deep_stage_accesses_hit_32_banks():
    """Every warp-wide shared-memory access of the ring hits 32 distinct
    banks: the consumers' A fragment loads (each of a0..a3, each tile and
    step of a stage) and the producer's writes of a row's 32 columns."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for s in range(STAGE_WORDS // 8):
        for u in range(STAGE_TILES):
            col = (16 * u + g) ^ (8 * t)
            for row in (8 * s + t, 8 * s + 4 + t):
                for c in (col, col ^ 8):
                    assert len(set((row * STAGE_COLS + c) % 32)) == 32
    for r in range(STAGE_WORDS):
        for h in range(STAGE_COLS // 32):
            addr = r * STAGE_COLS + ((32 * h + lane) ^ (8 * (r & 3)))
            assert len(set(addr % 32)) == 32
    # 16-byte copies: lane 16 h + q writes columns 4 q .. 4 q + 3 of row
    # r0 + h, one aligned run of the row whatever the row (the swizzle
    # moves runs of 4 whole), and each quarter warp's 8 runs cover 32 banks.
    q, h = lane % 16, lane // 16
    for r0 in range(0, STAGE_WORDS, 2):
        r = r0 + h
        base = (4 * q) ^ (8 * (r & 3))
        for j in range(4):
            assert np.array_equal((4 * q + j) ^ (8 * (r & 3)), base + j)
        addr = r * STAGE_COLS + base
        assert np.all(addr % 4 == 0)
        for quarter in range(4):
            runs = addr[8 * quarter:8 * quarter + 8]
            assert len(set((runs // 4) % 8)) == 8


def test_deep_emulation_mirrors_the_source():
    """The deep build's constants and layouts above are csrc/scm_sweep.cu's,
    and ops/scm_sweep.py's plan uses the same."""
    src = SOURCE.read_text()
    for line in ("constexpr int kDeepWarps = %d;" % DEEP_WARPS,
                 "constexpr int kWarpGroups = %d;" % WARP_GROUPS,
                 "constexpr int kStageTiles = %d;" % STAGE_TILES,
                 "constexpr int kStageWords = %d;" % STAGE_WORDS,
                 "constexpr int kMaxStages = %d;" % sw._MAX_STAGES,
                 "constexpr int kMinStages = %d;" % sw._MIN_STAGES,
                 "constexpr int kSmemMax = 227 * 1024;",
                 "const int col = (u * kWarpCols + g) ^ (8 * t);",
                 "((h * 32 + lane) ^ (8 * (r & 3)))",
                 "((4 * q) ^ (8 * (r & 3)))",
                 "const int q = lane & 15;", "const int r0 = lane >> 4;",
                 "b_warp[i] = s_b + (size_t)(warp + kDeepWarps * min(i, gw - 1))"):
        assert line in src, line
    assert sw._DEEP_GROUPS == DEEP_WARPS * WARP_GROUPS
    assert sw._STAGE_BYTES == STAGE_WORDS * STAGE_COLS * 4 + 2 * 8
    assert re.search(r"mbar_init\(s_empty \+ s, n_active \* bmma::kLanes\)",
                     src)


def test_sweep_plan_rejects_masks_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        sw.sweep_plan(4, 20000)


def test_cart_names_still_import_from_cart_sweep():
    from grm_tpu_torch.ops import cart_sweep as cs

    assert cs.pack_mask_tiles is tiles.pack_mask_tiles
    assert cs.tile_plan is tiles.tile_plan
    assert (cs.TILE_NODES, cs.TILE_WORDS, cs.TILE_LANES) == (4, 4, 32)
