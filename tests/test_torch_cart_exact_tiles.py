"""What Python holds of the redesigned exact CART kernels
(``grm_tpu_torch/csrc/cart_exact.cu``): the pass bitmaps that replace a
score per (node, column) by a look-up, the launch layout (bitmap offsets,
private tables, shared-memory bytes), and the hit-bit compaction. The
kernels themselves run only on a GPU (``tests/test_torch_cuda.py``); here:

- the plain pass bitmap (``pass_bitmap_plain``) against ``grm_tpu``'s
  float32 scores (``grm_tpu.parallel.cart_exact._scores_f32``) and
  thresholds (``_thresh_from_gmin``) over every key of each lattice;
- a look-up of each column's key in the bitmap against the per-column
  filter of the plain versions (``ops/cart_exact._passing``), exactly;
- the plan and layout functions against a mirror of the source's
  ``layout()``;
- a numpy emulation of the compaction the two select launches make
  (ballots -> 16-bit halves -> per-block counts -> offsets -> positions from
  the words' popcount prefixes) against ``cart_exact_select_plain``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from grm_tpu.parallel.cart_exact import _scores_f32, _thresh_from_gmin

from grm_tpu_torch.ops import cart_exact as ce
from grm_tpu_torch.ops.popcount import BitMatrix

CRITERIA = ["gini", "cross-entropy"]
MAX_ULPS = 2  # JAX on the CPU contracts the scores into FMAs; the port not


def _lattice_lefts(n_node_row):
    """(C, S) int64 left counts of every key of one node's lattice."""
    size = int(np.prod(np.asarray(n_node_row, np.int64) + 1))
    return np.stack(ce.decode_keys(np.arange(size), n_node_row))


def _bits_of(words, size):
    """(S,) bool from a node's int32 bitmap words."""
    w = np.asarray(words, np.int64) & 0xFFFFFFFF
    bits = (w[:, None] >> np.arange(32)) & 1
    return bits.reshape(-1)[:size].astype(bool)


def _ulps(a, b):
    a = np.float32(a).view(np.int32).astype(np.int64)
    b = np.float32(b).view(np.int32).astype(np.int64)
    return abs(a - b)


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("criterion", CRITERIA)
def test_pass_bitmap_equals_jax_scores_under_jax_thresholds(c, criterion):
    """Every key of each node's lattice: in the plain bitmap exactly where
    ``grm_tpu`` scores it at most ``_thresh_from_gmin`` of a minimum. A key
    may differ only with a float32 score within MAX_ULPS of its threshold;
    how many did is printed (0 expected)."""
    rng = np.random.RandomState(c)
    rows = ([[9, 14], [30, 2], [1, 1], [0, 5], [40, 41]] if c == 2 else
            [[5, 7, 3], [9, 0, 4], [1, 1, 1], [12, 10, 11]])
    n_node = np.asarray(rows, np.int32)
    n = len(n_node)
    priors = (rng.rand(n, c) + 0.1).astype(np.float32)
    totals = rng.randint(50, 90, size=(n, c)).astype(np.float32)
    jax_scores = []
    for i in range(n):
        left = _lattice_lefts(n_node[i]).astype(np.int32)[None]
        jax_scores.append(np.asarray(_scores_f32(
            jnp.asarray(left), jnp.asarray(n_node[i:i + 1]),
            jnp.asarray(priors[i:i + 1]), jnp.asarray(totals[i:i + 1]),
            criterion))[0])
    scale = torch.from_numpy(priors) / torch.from_numpy(totals)
    near = 0
    for how in ("min", "quantile"):
        gmin = np.array([s[np.isfinite(s)].min() if how == "min" else
                         np.quantile(s[np.isfinite(s)], 0.3)
                         for s in jax_scores], np.float32)
        thresh = np.asarray(_thresh_from_gmin(jnp.asarray(gmin),
                                              float(c))).astype(np.float32)
        bits, off = ce.pass_bitmap_plain(
            torch.from_numpy(n_node), scale, torch.from_numpy(thresh),
            criterion)
        bits, off = bits.numpy(), off.numpy()
        for i in range(n):
            score = jax_scores[i]
            want = np.isfinite(score) & (score <= thresh[i])
            got = _bits_of(bits[off[i]:off[i + 1]], len(score))
            assert want.any()
            for key in np.where(got != want)[0]:
                assert _ulps(score[key], thresh[i]) <= MAX_ULPS, (i, key)
                near += 1
    print("keys within %d ulps of their threshold that differ: %d"
          % (MAX_ULPS, near))


def _lookup_case(rng, rows, thresh_kind, criterion, n_genomes=520, k=700):
    """Class masks of examples drawn to the counts ``rows``, a random
    matrix, thresholds: a score quantile, -inf or +inf per node."""
    n_node = np.asarray(rows, np.int32)
    n, c = n_node.shape
    dense = (rng.rand(n_genomes, k) < rng.rand(k)).astype(np.uint8)
    bm = BitMatrix.from_dense(dense, device="cpu")
    w = bm.n_words
    from grm_tpu_torch.parallel.scm_device import build_packed_mask
    masks = np.zeros((n, c, w), np.uint32)
    for i in range(n):
        ex = rng.permutation(n_genomes)
        lo = 0
        for ci in range(c):
            idx = ex[lo:lo + n_node[i, ci]]
            lo += n_node[i, ci]
            masks[i, ci] = build_packed_mask(idx, n_genomes, w)
    train = np.stack([build_packed_mask(np.where(rng.rand(n_genomes) < 0.6)[0],
                                        n_genomes, w) for _ in range(n)])
    scale = torch.from_numpy((rng.rand(n, c) + 0.1).astype(np.float32))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    masks, train, n_node = t(masks), t(train), torch.from_numpy(n_node)
    _, left, _, _ = next(ce._counted_chunks(bm.data, masks, train, k, None))
    score, ok = ce._split_scores(left, n_node, scale, criterion)
    thresh = torch.empty(n)
    for i, kind in enumerate(thresh_kind):
        thresh[i] = (float(kind) if kind in ("inf", "-inf") else
                     float(torch.quantile(score[i][ok[i]].double(), kind)))
    return n_node, scale, thresh, left


@pytest.mark.parametrize("criterion", CRITERIA)
@pytest.mark.parametrize("rows,kinds", [
    # a lattice of exactly S_MAX, a -inf and a +inf threshold
    ([[255, 255], [20, 30], [7, 9], [3, 4]], [0.2, 0.5, "-inf", "inf"]),
    # three classes, one of them empty
    ([[12, 0, 9], [6, 5, 4], [1, 1, 0]], [0.3, 0.4, "inf"]),
])
def test_bitmap_lookup_equals_the_per_column_filter(rows, kinds, criterion):
    rng = np.random.RandomState(len(rows))
    n_node, scale, thresh, left = _lookup_case(rng, rows, kinds, criterion)
    assert int(ce.lattice_sizes(n_node).max()) <= ce.S_MAX
    bits, off = ce.pass_bitmap(n_node, scale, thresh, criterion)
    np.testing.assert_array_equal(
        off.numpy(), ce.bitmap_offsets(ce.lattice_sizes(n_node).numpy()))
    key = ce.mixed_radix_keys(left, n_node)
    word = bits[off[:-1, None] + (key >> 5)].long() & 0xFFFFFFFF
    looked_up = ((word >> (key & 31)) & 1).bool()
    want = ce._passing(left, n_node, scale, thresh, criterion)
    assert torch.equal(looked_up, want)
    assert bool(want.any(1)[thresh > -np.inf].all())
    assert not bool(want[thresh == -np.inf].any())


# -- the launch layout --------------------------------------------------------

def _layout_mirror(mode, w, groups, c, bit_words, priv_entries):
    """The fields of csrc/cart_exact.cu's Layout, in its order."""
    nodes, steps = 4 * groups, -(-w // 4)
    o = groups * ((c + 2) // 2) * steps * 32 * 4  # mask tiles
    for field in (nodes * c, nodes * c, nodes, nodes, nodes, nodes):
        o += 4 * field  # nn, scale, thresh, aux, boff, poff
    o += 4 * bit_words
    o = -(-o // 8) * 8
    o += 8 * priv_entries + 4 * priv_entries
    if mode != "tuples":
        o += nodes * (4096 // 32) * 4  # the hit words
    o = -(-o // 16) * 16
    if steps > 4:
        o += 8 * steps * 32 * 8  # the warps' slabs of A fragments
    return o


@pytest.mark.parametrize("mode", ["tuples", "gather", "equiv"])
@pytest.mark.parametrize("w", [1, 11, 16, 17, 157])
@pytest.mark.parametrize("c", [2, 3, 8])
def test_smem_bytes_mirror_the_source_layout(mode, w, c):
    for groups, bit_words, priv in ((1, 0, 0), (5, 4925, 1032),
                                    (3, 17, 3), (17, 0, 2048)):
        assert ce._smem_bytes(mode, w, groups, c, bit_words, priv) == \
            _layout_mirror(mode, w, groups, c, bit_words, priv)


def test_exact_layout_plans_bitmaps_and_private_tables():
    # The main path's largest frontier: 18 two-class nodes, small and large.
    rng = np.random.RandomState(5)
    sizes = np.concatenate([[4, 12, 600, 1024, 1025],
                            rng.randint(2000, 30000, 13)])
    lay = ce.exact_layout("tuples", sizes, 2, 11)
    np.testing.assert_array_equal(
        lay.bit_off, np.concatenate([[0], np.cumsum(-(-sizes // 32))]))
    rows = 4 * lay.gpb
    assert lay.gpb == 5 and lay.bit_words == lay.bit_off[-1]  # one row
    assert list(lay.priv_off[:5]) == [0, 4, 16, 616, -1]
    assert lay.priv_entries == 616 + 1024 and (lay.priv_off[5:] == -1).all()
    assert lay.smem == ce._smem_bytes("tuples", 11, lay.gpb, 2,
                                      lay.bit_words, lay.priv_entries)
    # Bitmaps past the budget are read from global memory; no private
    # tables outside tuples mode; no bitmaps in gather mode.
    big = np.full(40, ce.S_MAX)
    assert ce.exact_layout("tuples", big, 2, 11).bit_words == 0
    eq = ce.exact_layout("equiv", sizes, 2, 11)
    assert eq.priv_entries == 0 and (eq.priv_off == -1).all()
    assert eq.bit_words == lay.bit_words
    ga = ce.exact_layout("gather", sizes, 3, 11)
    assert ga.bit_words == 0 and not ga.bit_off.any()
    # 5022 genomes (W = 157): the A slabs, nodes over grid rows, every row's
    # bitmaps and private tables within its budgets and the block's limit.
    wide = np.concatenate([[4] * 30, rng.randint(100, 3000, 35)])
    for mode in ("tuples", "equiv"):
        lay = ce.exact_layout(mode, wide, 2, 157)
        rows = 4 * lay.gpb
        assert -(-65 // rows) > 1
        assert lay.smem <= 227 << 10
        assert lay.smem == ce._smem_bytes(mode, 157, lay.gpb, 2,
                                          lay.bit_words, lay.priv_entries)
        assert ce._stage_bytes(157) == 8 * 40 * 32 * 8
        assert ce._stage_bytes(11) == ce._stage_bytes(16) == 0
        for lo in range(0, 65, rows):
            hi = min(65, lo + rows)
            if lay.bit_words:
                assert lay.bit_off[hi] - lay.bit_off[lo] <= lay.bit_words
            priv = lay.priv_off[lo:hi]
            used = wide[lo:hi][priv >= 0]
            assert used.sum() <= lay.priv_entries <= 2048
            assert (used <= ce.PRIV_LATTICE).all()
            ends = priv[priv >= 0] + used
            assert (ends <= lay.priv_entries).all()


def test_pass_bitmap_rejects_what_the_kernel_does_not_take():
    n_node = torch.tensor([[3, 4], [2, 2]], dtype=torch.int32)
    scale = torch.ones(2, 2)
    with pytest.raises(ValueError, match="criterion"):
        ce.pass_bitmap(n_node, scale, torch.zeros(2), "entropy")
    with pytest.raises(ValueError, match="thresh"):
        ce.pass_bitmap(n_node, scale, torch.zeros(3), "gini")
    with pytest.raises(ValueError, match="S_MAX"):
        ce.pass_bitmap(torch.tensor([[256, 255]], dtype=torch.int32),
                       torch.ones(1, 2), torch.zeros(1), "gini")
    with pytest.raises(ValueError, match="classes"):
        ce.pass_bitmap(torch.ones((1, 9), dtype=torch.int32),
                       torch.ones(1, 9), torch.zeros(1), "gini")


# -- the hit-bit compaction ----------------------------------------------------

def _every_fourth_bit(x):
    """csrc/cart_exact.cu's every_fourth_bit: bits 0, 4, ..., 28 -> 0..7."""
    x = x & np.uint32(0x11111111)
    x = (x | (x >> np.uint32(3))) & np.uint32(0x03030303)
    x = (x | (x >> np.uint32(6))) & np.uint32(0x000F000F)
    return (x | (x >> np.uint32(12))) & np.uint32(0xFF)


def _emulated_compaction(hit):
    """The two select launches on an (N, K) hit mask, in numpy: per warp
    tile of 16 columns and group of 4 nodes two ballots (lane 4g + t holds
    node t's columns g and g + 8), each node's 16-bit half from them, the
    halves into 128 words per (column block, node) and their popcounts into
    counts; offsets by the wrapper's scan; then per (block, node) with hits
    a scan of the words' popcounts over 4 warps of 32 lanes and each set
    bit at its offset plus the popcount below it. Returns (starts, cols)."""
    n, k = hit.shape
    nb = -(-k // ce.BLOCK_K)
    groups = -(-n // 4)
    pad = np.zeros((groups * 4, nb * ce.BLOCK_K), bool)
    pad[:n, :k] = hit
    tiles = pad.reshape(groups, 4, nb * ce.BLOCK_K // 16, 2, 8)
    lane = (4 * np.arange(8)[:, None] + np.arange(4)[None, :]).astype(
        np.uint32)  # (g, t)
    halves = np.zeros((groups * 4, nb * ce.BLOCK_K // 16), np.uint32)
    for h in range(2):
        # (groups, tiles, g, t): node t of the group, column g (+ 8 h)
        bits = tiles[:, :, :, h, :].transpose(0, 2, 3, 1).astype(np.uint32)
        ballot = (bits << lane).sum((2, 3), dtype=np.uint64).astype(
            np.uint32)  # (groups, tiles)
        for t in range(4):
            halves[t::4] |= (_every_fourth_bit(ballot >> np.uint32(t))
                             << np.uint32(8 * h))
    halves = halves[:n]
    words = (halves[:, 0::2] | (halves[:, 1::2] << np.uint32(16))).reshape(
        n, nb, ce.HIT_WORDS)
    popc = np.unpackbits(words.view(np.uint8), axis=2).reshape(
        n, nb, ce.HIT_WORDS, 32).sum(3).astype(np.int64)
    counts = popc.sum(2)  # (n, nb)
    ends = np.cumsum(counts, 1)
    starts = np.concatenate([[0], np.cumsum(ends[:, -1])])
    offsets = starts[:-1, None] + ends - counts
    out = np.full(starts[-1], -1, np.int64)
    for b in range(nb):
        for node in range(n):
            if counts[node, b] == 0:
                continue
            wv = words[node, b].astype(np.int64)
            pw = popc[node, b]
            warp_tot = pw.reshape(4, 32).sum(1)
            warp_base = np.concatenate([[0], np.cumsum(warp_tot)[:-1]])
            lane_excl = (np.cumsum(pw.reshape(4, 32), 1)
                         - pw.reshape(4, 32)).reshape(-1)
            for i in np.where(wv != 0)[0]:
                for bit in range(32):
                    if (wv[i] >> bit) & 1:
                        below = bin(int(wv[i]) & ((1 << bit) - 1)).count("1")
                        pos = (offsets[node, b] + warp_base[i // 32]
                               + lane_excl[i] + below)
                        out[pos] = b * ce.BLOCK_K + 32 * i + bit
    return starts, out


@pytest.mark.parametrize("n", [1, 3, 18, 65])
def test_hit_bit_compaction_emulation_equals_the_plain_select(n):
    """Gather mode at a quantile threshold (every node of the last four
    gets +inf: whole runs of hits), ragged K with the limit inside it and
    an exclusion mask."""
    rng = np.random.RandomState(n)
    k, limit, c = 2 * ce.BLOCK_K + 1234, 2 * ce.BLOCK_K + 1200, 2
    n_genomes = 90
    dense = (rng.rand(n_genomes, k) < 0.4).astype(np.uint8)
    matrix = BitMatrix.from_dense(dense, device="cpu").data
    w = matrix.shape[0]
    from grm_tpu_torch.parallel.scm_device import build_packed_mask
    masks = np.zeros((n, c, w), np.uint32)
    for i in range(n):
        owner = rng.randint(0, c + 1, n_genomes)
        for ci in range(c):
            masks[i, ci] = build_packed_mask(np.where(owner == ci)[0],
                                             n_genomes, w)
    train = np.stack([build_packed_mask(np.where(rng.rand(n_genomes) < 0.7)
                                        [0], n_genomes, w)
                      for _ in range(n)])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    masks, train = t(masks), t(train)
    n_node = torch.from_numpy(np.unpackbits(
        masks.numpy().view(np.uint8), axis=2).sum(2).astype(np.int32))
    scale = torch.from_numpy((rng.rand(n, c) + 0.1).astype(np.float32))
    excl = torch.from_numpy((rng.rand(k) < 0.15).astype(np.uint8))
    hit = []
    for cols, left, occ, valid in ce._counted_chunks(matrix, masks, train,
                                                     limit, excl):
        score, ok = ce._split_scores(left, n_node, scale, "gini")
        hit.append((valid, score, ok))
    valid = torch.cat([v for v, _, _ in hit], 1)
    score = torch.cat([s for _, s, _ in hit], 1)
    ok = torch.cat([o for _, _, o in hit], 1)
    thresh = torch.tensor([float(torch.quantile(score[i][ok[i]], 0.2))
                           for i in range(n)], dtype=torch.float32)
    thresh[-4:] = float("inf")
    mask = (valid & ok & (score <= thresh[:, None])).numpy()
    starts, cols, _, _ = ce.cart_exact_select_plain(
        matrix, masks, train, n_node, scale, "gini", limit, "gather",
        thresh=thresh, excl=excl)
    e_starts, e_cols = _emulated_compaction(mask)
    np.testing.assert_array_equal(e_starts, starts.numpy())
    np.testing.assert_array_equal(e_cols, cols.numpy())
    assert len(e_cols) > 0 and (e_cols >= 0).all()
