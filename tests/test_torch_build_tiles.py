"""What Python holds of the one-pass ``build_columns`` kernel
(``grm_tpu_torch/csrc/device_build.cu``, ``build_columns_tile_kernel``).
The kernel runs only on a GPU (``tests/test_torch_cuda.py``); here a numpy
emulation of its decomposition is held exactly against
``build_columns_plain`` and against ``grm_tpu``'s ``_build`` (no filter):

- tiles of ``warps * 32 * R`` sorted rows, ``R`` consecutive rows a
  thread, the tile constants parsed from the source, and tiny tiles (32,
  64 and 96 rows) so that boundaries are dense;
- each thread's walk over its rows: the first-of-a-k-mer and
  segment-start bits (the row before a thread's first is the previous
  thread's last, or for thread 0 the row before the tile), and the OR of
  its trailing segment;
- the warp's count of firsts below each lane, the trailing segments ORed
  from lane to lane by a segmented shuffle scan, the counts of the warps
  and the tile, and the decoupled look-back over the tiles' status words,
  with the tiles advancing in a random order from a seed;
- a row's genome by the multiply with a magic number
  (``ops/device_build._divisor_magic``), checked at every boundary
  ``g * n_cols - 1``, ``g * n_cols`` and at the largest ``perm`` below 2^31;
- which segments store and which take ``atomicOr``: every plain store's
  address is written once in the whole launch, so the result does not
  depend on the order in which the tiles run; at most two atomics a warp;
- each tile's columns lie in [its prefix - 1, its prefix + its count - 1];
  the staged tile's slots (a slot of padding after each thread's rows) are
  a bijection, each thread's walk reads distinct banks, and the stage fits
  48 KB of static shared memory.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from grm_tpu.parallel import device_build as jdb
from grm_tpu_torch.ops import device_build as db
from grm_tpu_torch.ops import kmer as tk

SOURCE = Path(db.__file__).resolve().parent.parent / "csrc" / "device_build.cu"
THREADS = 256  # csrc/device_build.cu kBuildThreads
KEY_INVALID = np.int64(2**63 - 1)
NO_GENOME = np.uint64(0xFFFFFFFF)
SIGN = np.uint64(1 << 63)
KS = [9, 31, 33, 64]
GENOMES = [1, 31, 32, 33, 64]
TINY = [(1, 1), (2, 1), (1, 3)]  # (warps, R): tiles of 32, 64, 96 rows


def rows(n_pairs):
    """csrc/device_build.cu build_rows."""
    return 8 if n_pairs == 1 else (4 if n_pairs == 2 else 2)


def source_tile(n_pairs):
    return THREADS // 32, rows(n_pairs)


def lookback(counts, rng, resident):
    """Each tile's exclusive prefix by the kernel's look-back, with up to
    ``resident`` tiles in flight advanced in a random order: a tile takes
    the next id when its block starts, publishes (1, its count) (tile 0:
    (2, its count)), looks back one read of 32 status words at a time, and
    publishes (2, its inclusive count). A read adds the counts down to the
    nearest inclusive one, or, while a nearer tile reads 0, the counts
    before that tile, and waits on it alone."""
    n = len(counts)
    status = [(0, 0)] * n
    prefix = [None] * n
    active = {}  # tile -> [window, sum] once its count is published
    started = 0
    while started < n or active:
        if started < n and (not active or len(active) < resident
                            and rng.rand() < 0.5):
            active[started] = None
            started += 1
            continue
        t = list(active)[rng.randint(len(active))]
        if active[t] is None:  # publish the count
            if t == 0:
                prefix[0] = 0
                status[0] = (2, counts[0])
                del active[0]
            else:
                status[t] = (1, counts[t])
                active[t] = [t - 1, 0]
            continue
        window, total = active[t]
        seen = [status[w] if w >= 0 else (2, 0)
                for w in range(window, window - 32, -1)]
        wait = next((i for i, (f, _) in enumerate(seen) if f == 0), 32)
        near = next((i for i, (f, _) in enumerate(seen) if f == 2), 32)
        assert wait == 32 or window - wait < started  # a started tile
        if near < wait:
            prefix[t] = total + sum(v for _, v in seen[:near + 1])
            status[t] = (2, prefix[t] + counts[t])
            del active[t]
        else:
            active[t] = [window - wait, total + sum(v for _, v in seen[:wait])]
    return np.array(prefix, dtype=np.int64)


def _bit(g, n_words):
    """csrc/device_build.cu genome_bit."""
    ok = (g != NO_GENOME) & ((g >> np.uint64(5)) < np.uint64(n_words))
    return np.where(ok, np.uint64(1) << (np.uint64(31) - (g & np.uint64(31))),
                    np.uint64(0))


def emulate(keys, perm, valid, nw, n_cols, k_budget, warps, r_len, seed):
    """The kernel's (matrix (W, k_budget) int32, union (k_budget, nw)
    int32, count) for sorted numpy ``keys`` (P, n), ``perm`` (n,), ``valid``
    (n,) bool or None; also its matrix stores: a list per warp of
    (address, bits, atomic)."""
    n_pairs, n = keys.shape
    n_words = -(-(n // n_cols) // 32) if n else 0
    magic, shift = db._divisor_magic(n_cols)
    tile = warps * 32 * r_len
    n_tiles = -(-n // tile)
    n_warps = n_tiles * warps
    pad = n_tiles * tile - n
    ok = valid if valid is not None else keys[0] != KEY_INVALID
    gid = (perm.astype(np.uint64) & np.uint64(0xFFFFFFFF)) * np.uint64(magic)
    gid = np.where(ok, gid >> np.uint64(shift), NO_GENOME)
    key = np.concatenate([keys, np.full((n_pairs, pad), KEY_INVALID)], 1)
    gid = np.concatenate([gid, np.full(pad, NO_GENOME)])
    # The row before each row: the previous thread's last from the stage,
    # for thread 0 the row before the tile from device memory.
    key_before = np.concatenate([np.full((n_pairs, 1), KEY_INVALID),
                                 key[:, :-1]], 1)
    gid_before = np.concatenate([[NO_GENOME], gid[:-1]])
    shape = (n_warps, 32, r_len)  # rows by (warp, lane, i)
    row = np.arange(n_tiles * tile).reshape(shape)
    new = (row == 0) | (key != key_before).any(0).reshape(shape)
    g = gid.reshape(shape)
    g_before = gid_before.reshape(shape)
    good = g != NO_GENOME
    first = good & new
    start = (~good | (g_before == NO_GENOME) | new
             | ((g >> np.uint64(5)) != (g_before >> np.uint64(5))))
    bit = _bit(g, n_words)
    trail = np.zeros((n_warps, 32), np.uint64)
    for i in range(r_len):
        trail = np.where(start[..., i], bit[..., i], trail | bit[..., i])

    # The warp: firsts below each lane, trailing segments ORed lane to lane.
    lane = np.arange(32)
    with_start = start.any(2)
    row0_start = start[..., 0]
    from_lane = np.maximum.accumulate(np.where(with_start, lane, 0), axis=1)
    below = first.sum(2)
    upto = trail.copy()
    for d in (1, 2, 4, 8, 16):  # __shfl_up_sync: lanes below d keep theirs
        c = np.concatenate([below[:, :d], below[:, :-d]], 1)
        o = np.concatenate([upto[:, :d], upto[:, :-d]], 1)
        below = below + np.where(lane >= d, c, 0)
        upto = upto | np.where(lane - d >= from_lane, o, np.uint64(0))
    carry = np.concatenate([np.zeros((n_warps, 1), np.uint64), upto[:, :-1]],
                           1)
    counts = below[:, 31].reshape(n_tiles, warps)
    below = below - first.sum(2)
    tile_count = counts.sum(1)
    warp_base = np.cumsum(counts, 1) - counts
    rng = np.random.RandomState(seed)
    prefix = lookback(tile_count, rng, resident=rng.randint(1, 9))

    stores = [[] for _ in range(n_warps)]

    def write(mask, word, col, bits, atomic):
        mask = mask & (bits != 0) & (col >= 0) & (col < k_budget)
        for w, l in zip(*np.nonzero(mask)):
            stores[w].append((int(word[w, l]) * k_budget + int(col[w, l]),
                              int(bits[w, l]), bool(atomic[w, l])))

    # The walk: flush a segment at each start, the trailing one at the end.
    col = ((prefix[:, None] + warp_base).reshape(-1)[:, None] + below - 1)
    seg_col = col.copy()
    seg_word = (g[..., 0] >> np.uint64(5)).astype(np.int64)
    is_open = np.ones((n_warps, 32), bool)
    acc = np.zeros((n_warps, 32), np.uint64)
    lower_start = np.cumsum(with_start, 1) - with_start > 0  # a lane below
    union = np.zeros((k_budget, nw), np.uint64)
    written = np.zeros(k_budget, np.int64)
    cols = []
    for i in range(r_len):
        s_i = start[..., i]
        if i > 0:
            write(s_i, seg_word, seg_col,
                  np.where(is_open, acc | carry, acc), is_open & ~lower_start)
        is_open &= ~s_i
        acc = np.where(s_i, np.uint64(0), acc)
        seg_word = np.where(s_i, (g[..., i] >> np.uint64(5)).astype(np.int64),
                            seg_word)
        seg_col = np.where(s_i, col + first[..., i], seg_col)
        col = col + first[..., i]
        cols.append(np.where(good[..., i], col, -1))
        for w, l in zip(*np.nonzero(first[..., i] & (col < k_budget))):
            words = key[:, row[w, l, i]].view(np.uint64) ^ SIGN
            pairs = np.stack([words >> np.uint64(32),
                              words & np.uint64(0xFFFFFFFF)])
            union[col[w, l]] = pairs.T.reshape(-1)[:nw]
            written[col[w, l]] += 1
        acc = acc | bit[..., i]
    next_start = np.concatenate([row0_start[:, 1:],
                                 np.zeros((n_warps, 1), bool)], 1)
    last = np.broadcast_to(lane == 31, (n_warps, 32))
    write(last | next_start, seg_word, seg_col, upto, last | ~with_start
          & ~lower_start)

    # Every plain store's address is written once in the launch, so any
    # order of the tiles gives this matrix.
    plain = [a for s in stores for a, _, atomic in s if not atomic]
    atomic = [a for s in stores for a, _, is_atomic in s if is_atomic]
    assert len(set(plain)) == len(plain)
    assert not set(plain) & set(atomic)
    assert all(sum(x[2] for x in s) <= 2 for s in stores)
    assert written.max(initial=0) <= 1
    matrix = np.zeros(n_words * k_budget, np.uint64)
    for s in stores:
        for addr, bits, is_atomic in s:
            matrix[addr] = (matrix[addr] | np.uint64(bits) if is_atomic
                            else np.uint64(bits))
    # Each tile's columns lie in [prefix - 1, prefix + count - 1].
    cols = np.stack(cols, -1).reshape(n_tiles, -1)
    for t in range(n_tiles):
        mine = cols[t][cols[t] >= 0]
        assert ((mine >= prefix[t] - 1)
                & (mine <= prefix[t] + tile_count[t] - 1)).all()
    count = int(prefix[-1] + tile_count[-1]) if n_tiles else 0
    as_i32 = lambda a: a.astype(np.uint32).view(np.int32)
    return (as_i32(matrix).reshape(n_words, k_budget), as_i32(union),
            count), stores


def _codes(rng, g, length, hot=0):
    """(g, length) int8 codes: a shared random half, a repeat inside each
    row, runs of 4s, and with ``hot`` a run of that many As in every row
    (one k-mer repeated hot - k + 1 times a genome)."""
    codes = rng.randint(0, 4, (g, length)).astype(np.int8)
    codes[:, :length // 2] = codes[0, :length // 2]
    codes[:, length // 2:length // 2 + 40] = codes[:, :40]
    for row in codes:
        at = rng.randint(0, length)
        row[at:at + rng.randint(1, 12)] = 4
    if hot:
        at = rng.randint(0, length - hot + 1)
        codes[:, at:at + hot] = 0
    return codes


def _sorted(codes, k):
    keys, valid = tk.window_keys(torch.from_numpy(codes), k)
    return tk.sort_keys(keys, valid)


def _check(codes, k, budgets, tiles, seed):
    """The emulation at every tile shape and budget against the plain
    version and grm_tpu's _build; returns the emulations' stores."""
    g, length = codes.shape
    nw = tk.n_words_for_k(k)
    keys, perm, valid = _sorted(codes, k)
    args = (keys.numpy(), perm.numpy(),
            None if valid is None else valid.numpy(), nw, length)
    out = []
    for budget in budgets:
        plain = [x.numpy() for x in db.build_columns_plain(
            keys, perm, valid, nw, length, budget)]
        m, u, n = jdb._build(codes, k, g, budget, False)
        np.testing.assert_array_equal(plain[0],
                                      np.asarray(m).view(np.int32))
        np.testing.assert_array_equal(plain[1],
                                      np.asarray(u).view(np.int32))
        assert int(plain[2][0]) == int(n)
        for i, (warps, r_len) in enumerate(tiles):
            (matrix, union, count), stores = emulate(
                *args, budget, warps, r_len, seed + i)
            np.testing.assert_array_equal(matrix, plain[0])
            np.testing.assert_array_equal(union, plain[1])
            assert count == int(plain[2][0])
            out.append(((warps, r_len), budget, stores))
    return out


@pytest.mark.parametrize("g", GENOMES)
@pytest.mark.parametrize("k", KS)
def test_emulation_is_exact(k, g):
    """A budget the union fits and one it overflows, at the source's tile
    and at tiles of 32, 64 and 96 rows."""
    rng = np.random.RandomState(10 * k + g)
    codes = _codes(rng, g, 211 if g > 1 else 1500)
    n_pairs = -(-tk.n_words_for_k(k) // 2)
    full = g * codes.shape[1]
    _, _, n = db.build_columns_plain(*_sorted(codes, k),
                                     tk.n_words_for_k(k), codes.shape[1],
                                     full)
    _check(codes, k, (full, max(1, int(n) // 3)),
           [source_tile(n_pairs)] + TINY, 7 * k + g)


@pytest.mark.parametrize("k", [31, 33])
def test_hot_kmer_spans_whole_tiles(k):
    """One k-mer repeated more than 4 T times (T the source's tile): its
    word-0 segment covers several whole tiles, every warp inside it takes
    one atomicOr and no plain store, and the matrix is still exact."""
    n_pairs = -(-tk.n_words_for_k(k) // 2)
    warps, r_len = source_tile(n_pairs)
    tile = warps * 32 * r_len
    rng = np.random.RandomState(k)
    hot = 4 * tile // 32 + 3 * tile // 32 + k
    codes = _codes(rng, 33, hot + 300, hot=hot)
    per_genome = hot - k + 1
    assert 33 * per_genome > 4 * tile
    for shape, _, stores in _check(
            codes, k, (33 * codes.shape[1], 400), [(warps, r_len)] + TINY,
            k):
        # The all-A k-mer has the smallest key: column 0, its word 0 the
        # first 32 * per_genome rows.
        whole = 32 * per_genome // (32 * shape[1])
        assert whole * 32 * shape[1] > 3 * tile
        for c in range(whole):
            assert [(a, atomic) for a, _, atomic in stores[c]] == [(0, True)]


@pytest.mark.parametrize("case", ["one-row", "one-tile", "ragged"])
def test_edge_sizes(case):
    """n = 1, n < T, and n a multiple of no tile."""
    rng = np.random.RandomState(["one-row", "one-tile", "ragged"].index(case))
    k, g, length = {"one-row": (1, 1, 1), "one-tile": (9, 1, 100),
                    "ragged": (9, 3, 4173)}[case]
    codes = rng.randint(0, 4, (g, length)).astype(np.int8)
    keys, perm, valid = _sorted(codes, k)
    plain = [x.numpy() for x in db.build_columns_plain(
        keys, perm, valid, 1, length, g * length)]
    for i, (warps, r_len) in enumerate([source_tile(1)] + TINY):
        (matrix, union, count), _ = emulate(
            keys.numpy(), perm.numpy(),
            None if valid is None else valid.numpy(), 1, length,
            g * length, warps, r_len, i)
        np.testing.assert_array_equal(matrix, plain[0])
        np.testing.assert_array_equal(union, plain[1])
        assert count == int(plain[2][0])
    if length >= 16:  # _extract_canon needs 16 codes
        m, _, n = jdb._build(codes, k, g, g * length, False)
        np.testing.assert_array_equal(plain[0], np.asarray(m).view(np.int32))
        assert count == int(n)


@pytest.mark.parametrize("seed", range(4))
def test_lookback_in_any_order(seed):
    """The look-back gives every tile the sum of the counts before it,
    whatever order the tiles advance in and however many are in flight; a
    tile only ever waits on a tile that has started."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, 50, 300)
    counts[rng.rand(300) < 0.3] = 0
    for resident in (1, 2, 33, 300):
        got = lookback(counts, rng, resident)
        np.testing.assert_array_equal(got, np.cumsum(counts) - counts)


N_COLS = [1, 2, 3, 5, 7, 31, 33, 300, 4096, 4173, 65_613, 4_403_200,
          2**20 + 7, 2**30 - 1, 2**30, 2**30 + 1, 2**31 - 1, 2**31, 2**40]


@pytest.mark.parametrize("d", N_COLS)
def test_divisor_magic(d):
    """perm // n_cols == (perm * magic) >> shift at every boundary
    g * n_cols - 1 and g * n_cols below 2^31 (a sample of them where there
    are more than 4M), at 2^31 - 1, and magic below 2^32."""
    magic, shift = db._divisor_magic(d)
    assert 0 <= magic < 2**32
    top = (2**31 - 1) // d + 1  # the boundaries g * d below 2^31, and one
    if top <= 1 << 22:
        g = np.arange(top, dtype=np.uint64)
    else:
        g = np.concatenate([
            np.arange(1 << 20), np.arange(top - (1 << 20), top),
            np.random.RandomState(d % 2**32).randint(0, top, 1 << 20)
        ]).astype(np.uint64)
    p = np.concatenate([g * np.uint64(d), g * np.uint64(d) - np.uint64(1),
                        np.array([2**31 - 1], np.uint64)])
    p = p[p < 2**31]
    got = (p * np.uint64(magic)) >> np.uint64(shift)
    np.testing.assert_array_equal(got, p // np.uint64(d))


def test_divisor_magic_bound():
    """The proof's condition, (2^31 - 1) * (magic * d - 2^shift) < 2^shift,
    for every d up to 2^17 and the n_cols above."""
    for d in list(range(1, 1 << 17)) + N_COLS:
        magic, shift = db._divisor_magic(d)
        if magic:
            assert (2**31 - 1) * (magic * d - (1 << shift)) < 1 << shift, d


def _banks_distinct(byte_addrs, width):
    """Whether one warp-wide shared access of ``width``-byte elements at
    ``byte_addrs`` (one per lane) needs one wavefront per 128 bytes: no two
    lanes of a wavefront reach different 4-byte words of one bank."""
    lanes_per_wave = {4: 32, 8: 16}[width]
    addrs = np.asarray(byte_addrs)
    for lo in range(0, len(addrs), lanes_per_wave):
        words = {}
        for a in addrs[lo:lo + lanes_per_wave]:
            for word in range(a // 4, (a + width - 1) // 4 + 1):
                words.setdefault(word % 32, set()).add(word)
        if any(len(s) > 1 for s in words.values()):
            return False
    return True


@pytest.mark.parametrize("n_pairs", [1, 2, 3, 4])
def test_stage_layout(n_pairs):
    """The stage's slots (row i at i + i / R) are distinct and within the
    kSlots of each array; each thread's walk (row i of thread t at slot
    t (R + 1) + i, and the previous thread's last) reads distinct banks for
    the 8-byte keys and the 4-byte genomes; the stage and the counts fit
    48 KB of static shared memory."""
    r_len = rows(n_pairs)
    slots = kslots = THREADS * (r_len + 1)
    i = np.arange(THREADS * r_len)
    slot = i + i // r_len
    assert len(set(slot)) == len(slot) and slot.max() < kslots
    t = np.arange(THREADS)
    np.testing.assert_array_equal(slot.reshape(THREADS, r_len)[:, 0],
                                  t * (r_len + 1))
    for warp in range(THREADS // 32):
        lanes = t[32 * warp:32 * warp + 32]
        for at in [lanes * (r_len + 1) + k for k in range(r_len)] + [
                lanes[lanes > 0] * (r_len + 1) - 2]:
            assert _banks_distinct(8 * at, 8)
            assert _banks_distinct(4 * at, 4)
    shared = 8 * n_pairs * slots + 4 * slots + 8 + 4 * (THREADS // 32) + 4
    assert shared <= 48 * 1024


def test_emulation_mirrors_the_source():
    """The constants above are csrc/device_build.cu's, and the kernel's
    shared memory is the stage, the tile id, the warps' counts and the
    prefix."""
    src = SOURCE.read_text()
    assert "constexpr int kBuildThreads = %d;" % THREADS in src
    assert "return P == 1 ? 8 : (P == 2 ? 4 : 2);" in src
    assert "constexpr int kSlots = kBuildThreads * (R + 1);" in src
    assert "s_gid[i + i / R] = g;" in src
    assert "const int slot0 = threadIdx.x * (R + 1);" in src
    body = src[src.index("build_columns_tile_kernel("):
               src.index("int launch_build_columns")]
    shared = re.findall(r"__shared__ [\w ]+? (\w+)(?:\[\w+\])*;", body)
    assert shared == ["s_key", "s_gid", "s_tile", "s_count", "s_prefix"]
