"""What Python holds of the one-pass ``merge_columns`` and ``compact_columns``
kernels (``grm_tpu_torch/csrc/device_build.cu``,
``merge_columns_tile_kernel`` and ``compact_columns_tile_kernel``). The
kernels run only on a GPU (``tests/test_torch_cuda.py``); here numpy
emulations of their decompositions are held exactly against the plain
versions (``merge_ranks_plain`` then ``scatter_batch_columns_plain`` per
batch; ``compact_columns_plain``) and against ``grm_tpu``'s
``_merge_ranks`` with ``_scatter_batch_columns``, and
``_compact_singletons``:

- tiles of ``warps * 32 * R`` merge rows (``R`` by key planes), a warp a
  chunk, lane l its rows 32 i + l, or of ``warps * 32`` columns, one a
  thread; the tile constants parsed from the source, and tiny tiles (32,
  64 and 96 rows or columns) so that boundaries are dense;
- a merge row's "first of a valid k-mer" against the row before it, taken
  where the kernel takes it: the lane below, lane 31 of the step before,
  or the row before the chunk;
- the ballots, the warps' counts, the tile's count and the decoupled
  look-back (``lookback`` of ``tests/test_torch_build_tiles.py``), the
  tiles advancing in a random order from a seed;
- the padding tiles: a merge tile whose first row is invalid (a filter
  tile wholly past the live columns) exits and publishes nothing; the live
  tiles are a prefix of the tile ids, so none waits on a padding tile;
  exactly one tile writes the count, or tile 0 writes 0;
- a row's batch by the kernel's binary search of the row starts, with
  unequal buckets; the tile's rows binned by batch: each batch's least
  batch column (taken by the lowest lane of a warp step's rows of it) and
  count, each row's slot, the slots a permutation because a batch's rows
  in a tile have consecutive batch columns; the words read and written
  slot by slot, every store's address written once in the launch, so the
  result does not depend on the order in which the tiles run;
- a k-mer present in every batch whose run of rows crosses a tile edge;
  the valid/invalid edge on a tile edge; no valid row; every row valid (a
  full bucket); ``k_budget`` below the union; k = 9, 31, 32, 33 and 64.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grm_tpu.parallel import device_build as jdb
from grm_tpu_torch.ops import device_build as db
from grm_tpu_torch.ops import kmer as tk
from grm_tpu_torch.parallel import device_build as tdb
from test_torch_build_tiles import lookback

SOURCE = Path(db.__file__).resolve().parent.parent / "csrc" / "device_build.cu"
THREADS = 256  # csrc/device_build.cu kMergeThreads
COMPACT_THREADS = 512  # kCompactThreads: one column a thread
KEY_INVALID = np.int64(2**63 - 1)
KS = [9, 31, 32, 33, 64]
SPLIT = (0, 32, 64, 70)  # three batches, the last one smaller
LENGTH = 200
TINY = [(1, 1), (2, 1), (1, 3)]  # (warps, R): tiles of 32, 64, 96 rows
COMPACT_TILES = [COMPACT_THREADS // 32, 1, 2, 3]  # warps a filter tile


def rows(n_pairs):
    """csrc/device_build.cu merge_rows."""
    return 8 if n_pairs == 1 else (4 if n_pairs == 2 else 2)


def _popc(words):
    u = words.astype(np.int64) & 0xFFFFFFFF
    return sum((u >> b) & 1 for b in range(32))


def merge_emulate(keys, perm, valid, batches, nw, k_budget, w_total, warps,
                  r_len, seed):
    """The kernel's (final (w_total, k_budget) int32, union (k_budget, nw)
    int32, count) for sorted numpy ``keys`` (P, n), ``perm`` (n,),
    ``valid`` (n,) bool or None and ``batches`` [(matrix (wb, bucket)
    int32, w_off)]; also each row's merged column (-1 where invalid) and
    the tile size."""
    n_pairs, n = keys.shape
    tile = warps * 32 * r_len
    n_tiles = -(-n // tile)
    keyed = valid is None
    ok_row = keys[0] != KEY_INVALID if keyed else valid.astype(bool)

    # Thread 0: the tile's first row, and the row after the tile.
    t = np.arange(n_tiles)
    first_ok = ok_row[t * tile]
    after_ok = np.array([e < n and ok_row[e] for e in (t + 1) * tile])
    state = np.where(first_ok, np.where(after_ok, 1, 2), 0)
    live = int((state > 0).sum())
    assert (state[:live] > 0).all() and not state[live:].any()
    assert (state == 2).sum() == (1 if ok_row.any() else 0)

    # Row c0 + 32 i + lane of warp w's chunk, c0 = tile T + w 32 R.
    row = (t[:, None, None, None] * tile
           + np.arange(warps)[None, :, None, None] * 32 * r_len
           + 32 * np.arange(r_len)[None, None, :, None]
           + np.arange(32)[None, None, None, :])
    clamped = np.minimum(row, n - 1)
    key = keys[:, clamped]  # (P, tiles, warps, R, 32)
    ok = ok_row[clamped] & (row < n)
    if keyed:
        ok &= key[0] != KEY_INVALID
    c0 = row[:, :, 0, 0]
    before = np.where(c0 > 0, keys[:, np.clip(c0, 1, n) - 1], KEY_INVALID)
    up = np.concatenate([key[..., :1], key[..., :-1]], -1)  # lane - 1
    step = np.concatenate([before[..., None], key[..., :-1, 31]], -1)
    up[..., 0] = step  # lane 0: lane 31 of the step before, or before
    is_new = (row == 0) | (up != key).any(0)
    first = ok & is_new

    counts = first.sum((2, 3))  # (tiles, warps)
    tile_count = counts.sum(1)
    warp_base = np.cumsum(counts, 1) - counts
    rng = np.random.RandomState(seed)
    prefix = np.zeros(n_tiles, np.int64)
    if live:
        prefix[:live] = lookback(tile_count[:live], rng,
                                 resident=rng.randint(1, 9))
    flat = first.reshape(n_tiles, warps, -1)  # (i, lane) order
    col = (prefix[:, None, None] + warp_base[..., None] - 1
           + np.cumsum(flat, -1)).reshape(row.shape)
    if live:
        last = int(np.nonzero(state == 2)[0][0])
        count = int(prefix[last] + tile_count[last])
    else:
        count = 0  # written by tile 0, itself a padding tile
    cols = np.full(n, -1, np.int64)
    alive = state[:, None, None, None] > 0
    cols[row[ok & alive]] = col[ok & alive]
    assert (cols[ok_row] >= 0).all()

    # The bins: each valid row's batch by the kernel's binary search of
    # the row starts, its batch column j; per (tile, batch) the least j,
    # taken by the lowest lane of each warp step's rows of that batch, and
    # the number of rows; a row's slot is its batch's first slot plus j
    # less the least j.
    row0 = np.cumsum([0] + [m.shape[1] for m, _ in batches])[:-1]
    valid_rows = row[ok & alive]
    tile_of = valid_rows // tile
    p = perm[valid_rows] & 0xFFFFFFFF
    lo = np.zeros(len(p), np.int64)
    hi = np.full(len(p), len(batches) - 1)
    while (lo < hi).any():
        mid = (lo + hi + 1) >> 1
        go = lo < hi
        up_ = go & (row0[mid] <= p)
        lo = np.where(up_, mid, lo)
        hi = np.where(go & ~up_, mid - 1, hi)
    j = p - row0[lo]
    step_of = valid_rows // 32  # (tile, warp, step) groups of 32 lanes
    slot = np.zeros(len(p), np.int64)
    final = np.zeros(w_total * k_budget, np.int64)
    addrs = []
    for t_ in np.unique(tile_of):
        in_t = np.nonzero(tile_of == t_)[0]
        size = np.bincount(lo[in_t], minlength=len(batches))
        jmin = np.full(len(batches), 2**32 - 1)
        for g in np.unique(step_of[in_t]):
            grp = in_t[step_of[in_t] == g]
            for b in np.unique(lo[grp]):
                peers = grp[lo[grp] == b]
                leader = peers[np.argmin(valid_rows[peers])]
                assert j[leader] == j[peers].min()
                jmin[b] = min(jmin[b], j[leader])
        off = np.cumsum(size) - size
        slot[in_t] = off[lo[in_t]] + j[in_t] - jmin[lo[in_t]]
        # A batch's rows in a tile have consecutive batch columns, so the
        # slots are a permutation of [0, valid rows in the tile).
        np.testing.assert_array_equal(np.sort(slot[in_t]),
                                      np.arange(len(in_t)))
        bat = np.zeros(len(in_t), np.int64)
        bat[slot[in_t]] = lo[in_t]
        col_at = np.zeros(len(in_t), np.int64)
        col_at[slot[in_t]] = np.minimum(cols[valid_rows[in_t]], k_budget)
        for e in range(len(in_t)):  # the write pass, slot by slot
            b = bat[e]
            if col_at[e] >= k_budget:
                continue
            matrix, w_off = batches[b]
            jj = jmin[b] + e - off[b]
            for w in range(matrix.shape[0]):
                addr = (w_off + w) * k_budget + col_at[e]
                final[addr] = matrix[w, jj]
                addrs.append(addr)
    # Every store's address is written once in the launch, and each row's
    # word lands at its own merged column.
    assert len(set(addrs)) == len(addrs)
    for (matrix, w_off), b in zip(batches, range(len(batches))):
        at = (lo == b) & (cols[valid_rows] < k_budget)
        np.testing.assert_array_equal(
            final[w_off * k_budget + cols[valid_rows[at]]], matrix[0, j[at]])
    first_row = np.zeros(n, bool)
    first_row[row[first & alive]] = True
    firsts = np.nonzero(first_row & (cols >= 0) & (cols < k_budget))[0]
    assert len(np.unique(cols[firsts])) == len(firsts)
    union = np.zeros((k_budget, nw), np.int64)
    u = keys[:, firsts].view(np.uint64) ^ np.uint64(1 << 63)
    pairs = np.stack([u >> np.uint64(32), u & np.uint64(0xFFFFFFFF)], 1)
    union[cols[firsts]] = pairs.reshape(2 * n_pairs, -1).T[:, :nw]
    as_i32 = lambda a: a.astype(np.uint32).view(np.int32)
    return (as_i32(final).reshape(w_total, k_budget), as_i32(union), count,
            cols, tile)


def compact_emulate(matrix, union, n_kmers, warps, seed):
    """The kernel's (matrix (W, K), union (K, nw), count) for numpy
    inputs, with tiles of ``warps * 32`` columns, one a thread."""
    n_words, k = matrix.shape
    live = min(max(n_kmers, 0), k)
    tile = warps * 32
    n_tiles = -(-k // tile)
    t = np.arange(n_tiles)
    state = np.where(t * tile < live,
                     np.where((t + 1) * tile >= live, 2, 1), 0)
    n_live = int((state > 0).sum())
    assert (state == 2).sum() == (1 if live else 0)
    col = (t[:, None, None] * tile + np.arange(warps)[None, :, None] * 32
           + np.arange(32)[None, None, :])
    genomes = _popc(matrix[:, np.minimum(col, max(live - 1, 0))]).sum(0)
    keep = (col < live) & (genomes != 1) & (state[:, None, None] > 0)
    counts = keep.sum(2)  # a warp's ballot
    tile_count = counts.sum(1)
    warp_base = np.cumsum(counts, 1) - counts
    rng = np.random.RandomState(seed)
    prefix = np.zeros(n_tiles, np.int64)
    if n_live:
        prefix[:n_live] = lookback(tile_count[:n_live], rng,
                                   resident=rng.randint(1, 9))
    pos = (prefix[:, None, None] + warp_base[..., None]
           + np.cumsum(keep, -1) - keep)
    src, dst = col[keep], pos[keep]
    assert len(np.unique(dst)) == len(dst)
    out = np.zeros_like(matrix)
    out[:, dst] = matrix[:, src]
    union_out = np.zeros_like(union)
    union_out[dst] = union[src]
    if n_live:
        last = int(np.nonzero(state == 2)[0][0])
        count = int(prefix[last] + tile_count[last])
    else:
        count = 0
    return out, union_out, count


def _codes(rng, g, length):
    """(g, length) int8 codes sharing a random half, with runs of 4s."""
    codes = rng.randint(0, 4, (g, length)).astype(np.int8)
    codes[:, :length // 2] = codes[0, :length // 2]
    for row in codes:
        at = rng.randint(0, length)
        row[at:at + rng.randint(1, 6)] = 4
    return codes


def _parts(k, seed, split=SPLIT):
    """The batches of ``split``, each built by the plain builder with a
    bucket sized as the batched builder sizes it without a batch budget:
    (matrix (wb, bucket), union (bucket, nw), count, w_off)."""
    codes = _codes(np.random.RandomState(seed), split[-1], LENGTH)
    parts = []
    for lo, hi in zip(split, split[1:]):
        bucket = 1 << max(10, ((hi - lo) * LENGTH - 1).bit_length())
        m, u, c = tdb._build(torch.from_numpy(codes[lo:hi]), k, bucket, False)
        parts.append((m.numpy(), u.numpy(), int(c[0]), lo // 32))
    return parts


def _cut(parts, counts):
    """The parts with their counts replaced (rows past a count invalid)."""
    return [(m, u, c, w) for (m, u, _, w), c in zip(parts, counts)]


def _sorted(parts, k):
    words = torch.from_numpy(np.concatenate([p[1] for p in parts]))
    valids = torch.cat([torch.arange(p[1].shape[0]) < p[2] for p in parts])
    keys, perm, valid = tk.sort_keys(
        tk.pair_keys(words.T, valids),
        None if k <= tk.MAX_SINGLE_KEY_K else valids)
    return keys, perm, valid


def _jax_merge(parts, k_budget, w_total):
    words = np.concatenate([p[1] for p in parts]).view(np.uint32)
    valids = np.concatenate([np.arange(p[1].shape[0]) < p[2] for p in parts])
    dest, union, n = jdb._merge_ranks(words, valids, words.shape[1],
                                      k_budget)
    final = jnp.zeros((w_total, k_budget + 1), jnp.uint32)
    off = 0
    for m, _, _, w_off in parts:
        final = jdb._scatter_batch_columns(
            final, m.view(np.uint32), dest[off:off + m.shape[1]], w_off,
            k_budget)
        off += m.shape[1]
    return (np.asarray(final)[:, :k_budget].view(np.int32),
            np.asarray(union).view(np.int32), int(n))


def _check_merge(parts, k, budgets, tiles, seed, jax_too=True):
    """The emulation at every tile shape and budget against the plain
    version and grm_tpu's merge; returns [(tile, cols)]."""
    nw = tk.n_words_for_k(k)
    w_total = -(-SPLIT[-1] // 32)
    keys, perm, valid = _sorted(parts, k)
    batches = [(p[0], p[3]) for p in parts]
    t_batches = [(torch.from_numpy(m), w) for m, w in batches]
    out = []
    for budget in budgets:
        plain = [x.numpy() for x in db.merge_columns_plain(
            keys, perm, valid, t_batches, nw, budget, w_total)]
        dest = db.merge_ranks_plain(keys, perm, valid, nw, budget)[0]
        if jax_too:
            want = _jax_merge(parts, budget, w_total)
            np.testing.assert_array_equal(plain[0], want[0])
            np.testing.assert_array_equal(plain[1], want[1])
            assert int(plain[2][0]) == want[2]
        for i, (warps, r_len) in enumerate(tiles):
            final, union, count, cols, tile = merge_emulate(
                keys.numpy(), perm.numpy(),
                None if valid is None else valid.numpy(), batches, nw,
                budget, w_total, warps, r_len, seed + i)
            np.testing.assert_array_equal(final, plain[0])
            np.testing.assert_array_equal(union, plain[1])
            assert count == int(plain[2][0])
            got = np.full(len(cols), db.TRASH, np.int64)
            got[perm.numpy()] = np.where(cols >= 0, cols, db.TRASH)
            np.testing.assert_array_equal(got, dest.numpy())
            out.append((tile, cols))
    return out


def _source_tile(k):
    return THREADS // 32, rows(-(-tk.n_words_for_k(k) // 2))


@pytest.mark.parametrize("k", KS)
def test_merge_emulation_is_exact(k):
    """Three batches with unequal buckets, merged with a budget the union
    fits and one it overflows, at the source's tile and at tiles of 32,
    64 and 96 rows; a k-mer present in every batch has its run of rows
    across a tile edge."""
    parts = _parts(k, k)
    assert len({p[0].shape[1] for p in parts}) > 1  # unequal buckets
    n_merged = int(db.merge_ranks_plain(
        *_sorted(parts, k), tk.n_words_for_k(k), 1)[2][0])
    crossed = False
    for tile, cols in _check_merge(
            parts, k, (sum(p[0].shape[1] for p in parts), n_merged // 3),
            [_source_tile(k)] + TINY, 3 * k):
        valid_cols = cols[cols >= 0]
        at = np.arange(len(cols))[cols >= 0]
        starts = np.r_[True, valid_cols[1:] != valid_cols[:-1]]
        run = np.diff(np.r_[np.nonzero(starts)[0], len(valid_cols)])
        begin = at[starts]
        end = begin + run - 1
        crossed |= bool(((run == len(parts))
                         & (begin // tile != end // tile)).any())
    assert crossed


@pytest.mark.parametrize("k", [31, 33])
def test_merge_batch_of_two_word_rows(k):
    """A batch of 64 genomes (two word rows a column) beside one of 6: the
    write pass copies both word rows of each slot."""
    parts = _parts(k, k + 5, split=(0, 64, 70))
    assert [p[0].shape[0] for p in parts] == [2, 1]
    _check_merge(parts, k, (sum(p[0].shape[1] for p in parts), 150),
                 [_source_tile(k)] + TINY, 5 * k)


@pytest.mark.parametrize("k", KS)
def test_merge_without_a_valid_row(k):
    """Every batch's count 0: every tile is a padding tile, tile 0 writes
    a count of 0 and nothing else is written."""
    parts = _cut(_parts(k, k + 1), [0, 0, 0])
    _check_merge(parts, k, (sum(p[0].shape[1] for p in parts),),
                 [_source_tile(k)] + TINY, k)


@pytest.mark.parametrize("k", KS)
def test_merge_with_every_row_valid(k):
    """Each batch cut to its count, so that every bucket is exactly full:
    no padding tile, and the last tile writes the count."""
    parts = [(m[:, :c].copy(), u[:c].copy(), c, w)
             for m, u, c, w in _parts(k, k + 2)]
    _check_merge(parts, k, (sum(p[2] for p in parts), 100),
                 [_source_tile(k)] + TINY, 2 * k)


@pytest.mark.parametrize("k", KS)
def test_merge_valid_edge_on_a_tile_edge(k):
    """The last valid row ends a tile: that tile writes the count, the
    next one is the first padding tile."""
    parts = _parts(k, k + 3)
    for shape in [_source_tile(k)] + TINY:
        tile = shape[0] * 32 * shape[1]
        counts = [p[2] for p in parts]
        cut = sum(counts) % tile
        for b in reversed(range(len(counts))):
            take = min(cut, counts[b])
            counts[b] -= take
            cut -= take
        assert sum(counts) % tile == 0 and sum(counts) > 0
        _check_merge(_cut(parts, counts), k, (1 << 13,), [shape], k,
                     jax_too=shape == TINY[0])


@pytest.mark.parametrize("k", KS)
def test_compact_emulation_is_exact(k):
    """The filter on a merged matrix, with the merged count, a count past
    the budget (every column live) and a count of 0, at the source's tile
    and at tiles of 32, 64 and 96 columns, against compact_columns_plain
    and grm_tpu's _compact_singletons."""
    parts = _parts(k, k + 4)
    keys, perm, valid = _sorted(parts, k)
    nw = tk.n_words_for_k(k)
    w_total = -(-SPLIT[-1] // 32)
    budget = sum(p[0].shape[1] for p in parts)
    final, union, n = db.merge_columns_plain(
        keys, perm, valid, [(torch.from_numpy(p[0]), p[3]) for p in parts],
        nw, budget, w_total)
    for n_kmers in (int(n[0]), budget + 5, 0, int(n[0]) // 2):
        count = torch.tensor([n_kmers], dtype=torch.int32)
        plain = [x.numpy() for x in db.compact_columns_plain(final, union,
                                                            count)]
        m, u, c = jdb._compact_singletons(
            np.concatenate([final.numpy(), np.zeros((w_total, 1), np.int32)],
                           1).view(np.uint32),
            union.numpy().view(np.uint32), n_kmers, budget)
        np.testing.assert_array_equal(plain[0],
                                      np.asarray(m)[:, :budget].view(np.int32))
        np.testing.assert_array_equal(plain[1], np.asarray(u).view(np.int32))
        assert int(plain[2][0]) == int(c)
        for i, warps in enumerate(COMPACT_TILES):
            out, union_out, kept = compact_emulate(
                final.numpy(), union.numpy(), n_kmers, warps, k + i)
            np.testing.assert_array_equal(out, plain[0])
            np.testing.assert_array_equal(union_out, plain[1])
            assert kept == int(plain[2][0])


@pytest.mark.parametrize("n_words,k_cols,n_kmers", [
    (1, 2, 2), (1, 31, 31), (3, 96, 64), (3, 97, 96), (2, 1100, 1024),
    (5, 2051, 2049)])
def test_compact_edges(n_words, k_cols, n_kmers):
    """Random words with many singletons and empty columns: fewer columns
    than a tile, the live columns ending on a tile edge and one past it."""
    rng = np.random.RandomState(k_cols)
    kind = rng.permutation(np.arange(k_cols) % 3)  # empty, one, many
    matrix = np.zeros((n_words, k_cols), np.uint32)
    dense = rng.randint(0, 2**32, (n_words, k_cols), dtype=np.uint64)
    matrix[:, kind == 2] = dense[:, kind == 2].astype(np.uint32)
    single = np.nonzero(kind == 1)[0]
    matrix[rng.randint(0, n_words, len(single)), single] = (
        np.uint32(1) << rng.randint(0, 32, len(single)).astype(np.uint32))
    matrix = matrix.view(np.int32)
    union = rng.randint(-2**31, 2**31, (k_cols, 2)).astype(np.int32)
    count = torch.tensor([n_kmers], dtype=torch.int32)
    plain = [x.numpy() for x in db.compact_columns_plain(
        torch.from_numpy(matrix), torch.from_numpy(union), count)]
    assert 0 < int(plain[2][0]) < n_kmers
    for i, warps in enumerate(COMPACT_TILES):
        out, union_out, kept = compact_emulate(matrix, union, n_kmers, warps,
                                               i)
        np.testing.assert_array_equal(out, plain[0])
        np.testing.assert_array_equal(union_out, plain[1])
        assert kept == int(plain[2][0])


def test_emulation_mirrors_the_source():
    """The constants above are csrc/device_build.cu's, a lane's rows and
    columns are 32 apart, a row's batch comes from the binary search of
    the row starts, and MAX_MERGE_BATCHES is the kernel's limit."""
    src = SOURCE.read_text()
    assert "constexpr int kMergeThreads = %d;" % THREADS in src
    assert "constexpr int kCompactThreads = %d;" % COMPACT_THREADS in src
    merge_rows = src[src.index("constexpr int merge_rows(int P) {"):]
    assert merge_rows.split("}")[0].split("{")[1].strip() == \
        "return P == 1 ? 8 : (P == 2 ? 4 : 2);"
    assert "constexpr int kMaxMergeBatches = %d;" % db.MAX_MERGE_BATCHES \
        in src
    body = src[src.index("merge_columns_tile_kernel("):
               src.index("int launch_merge_columns")]
    assert "const long long r = min(c0 + 32 * i + lane, n - 1);" in body
    assert "const long long c0 = tile * kTile + (long long)warp * 32 * R;" \
        in body
    assert "if (b >= 0 && lane == __ffs(peers) - 1) {" in body
    assert "atomicMin(s_jmin + b, at[i] - s_row0[b]);" in body
    assert "at[i] = s_off[b] + (at[i] - s_row0[b]) - s_jmin[b];" in body
    assert "s_word[e] = __ldg(src + s_jmin[b] + (e - s_off[b]));" in body
    assert "s_col[at[i]] = (uint32_t)min(col, k_budget);" in body
    assert "const long long col = base + __popc(firsts[i] & upto);" in body
    assert "if (row0[mid] <= p) {" in src
    body = src[src.index("compact_columns_tile_kernel("):]
    assert "const long long c = tile * kCompactThreads + threadIdx.x;" in body
    assert "const int32_t* at = matrix + min(c, live - 1);" in body
    assert "__ballot_sync(kFull, c < live && genomes != 1);" in body
