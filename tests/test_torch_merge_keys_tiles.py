"""What Python holds of the stable multiway merge (``merge_keys`` of
``grm_tpu_torch/csrc/sort.cu``, the wrapper
:func:`grm_tpu_torch.ops.kmer.merge_keys`) that takes the union merge's
sorted batches. The kernels run only on a GPU (``tests/test_torch_cuda.py``);
here a numpy emulation of their decomposition is held exactly (keys,
permutation, validity) against ``merge_keys_plain``, and its order against
``grm_tpu``'s ``_merge_ranks`` (its ``_lex_sort`` of the concatenation with
the position last, ``grm_tpu/parallel/device_build.py:182``) on the same
inputs:

- the segment table: each segment's first row, its valid rows (the count
  clipped to its rows) and its first valid row among the valid rows;
- the co-rank of every tile edge o (one warp an edge): the smallest and the
  largest valid key and the first bit where they differ, then bit by bit
  the candidate y = x | bit, each segment's lower bound of y inside its
  window, the window's low end moved up where the counts reach at most o,
  its high end down otherwise; the rest of o taken from the rows equal to
  the o-th key in segment order; checked against the brute-force co-ranks;
- each tile (``merge_tile`` valid rows, tiny here so that tile edges fall
  everywhere): every segment's share loaded in segment order, the
  ceil(log2 S) rounds of pairwise merges, each thread's E outputs from its
  first output's merge-path co-rank in its pair (the last pair starting at
  or before it), ties to the lower run;
- the invalid rows' tail, written after the valid rows in input order.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grm_tpu.ops import kmer as jk
from grm_tpu.parallel import device_build as jdb
from grm_tpu_torch.ops import _build
from grm_tpu_torch.ops import kmer as tk

SOURCE = Path(tk.__file__).resolve().parent.parent / "csrc" / "sort.cu"
SIGN = np.uint64(1 << 63)
KEY_INVALID = np.int64(2**63 - 1)


def _const(name):
    return int(re.search(r"constexpr int %s = (\d+);" % name,
                         SOURCE.read_text()).group(1))


MAX_SEGMENTS = _const("kMaxSegments")
MERGE_THREADS = _const("kMergeThreads")
TINY = [(8, 2), (16, 4), (32, 4)]  # (valid rows a tile, threads)


def merge_tile(n_pairs):
    """csrc/sort.cu merge_tile."""
    return 4096 if n_pairs == 1 else (1024 if n_pairs == 4 else 2048)


def less(x, y):
    """key_less over rows: x, y (P,) uint64 tuples, lexicographic."""
    for a, b in zip(x, y):
        if a != b:
            return a < b
    return False


def segment_table(segments):
    rows = np.array([int(r) for r, _ in segments], np.int64)
    pstart = np.concatenate([[0], np.cumsum(rows)])
    v = np.clip(np.array([int(c) for _, c in segments], np.int64), 0, rows)
    return pstart, v, np.concatenate([[0], np.cumsum(v)])


def corank(u, pstart, v, o):
    """merge_corank_kernel's warp for edge o: each segment's rows among the
    first o valid rows of the merge."""
    S = len(v)
    n_pairs = u.shape[0]
    total = int(v.sum())
    if o == 0 or o == total:
        return np.zeros(S, np.int64) if o == 0 else v.copy()
    key = lambda s, i: tuple(int(u[p, pstart[s] + i]) for p in range(n_pairs))
    firsts = [key(s, 0) for s in range(S) if v[s]]
    lasts = [key(s, v[s] - 1) for s in range(S) if v[s]]
    kmin, kmax = min(firsts), max(lasts)
    b = -1
    for p in range(n_pairs - 1, -1, -1):
        x = kmin[p] ^ kmax[p]
        if x:
            b = 64 * (n_pairs - 1 - p) + x.bit_length() - 1
    x = []
    for p in range(n_pairs):
        low = 64 * (n_pairs - 1 - p)
        x.append(kmin[p] if b < low else 0 if b >= low + 63
                 else kmin[p] & ~((2 << (b - low)) - 1))
    lo, hi = np.zeros(S, np.int64), v.copy()
    for bit in range(b, -1, -1):
        y = list(x)
        y[n_pairs - 1 - (bit >> 6)] |= 1 << (bit & 63)
        y = tuple(y)
        mid = lo.copy()
        for s in range(S):  # seg_lower_bound
            a, c = lo[s], hi[s]
            while a < c:
                m = (a + c) >> 1
                if less(key(s, m), y):
                    a = m + 1
                else:
                    c = m
            mid[s] = a
        if mid.sum() <= o:
            x = list(y)
            lo = mid
        else:
            hi = mid
    eq = hi - lo
    rem = o - lo.sum()
    before = np.cumsum(eq) - eq
    return lo + np.clip(rem - before, 0, eq)


def brute_corank(u, pstart, v, o):
    """The co-ranks from the stable order of the valid rows."""
    n_pairs = u.shape[0]
    rows = [(tuple(int(u[p, pstart[s] + i]) for p in range(n_pairs)), s, i)
            for s in range(len(v)) for i in range(v[s])]
    rows.sort()
    got = np.zeros(len(v), np.int64)
    for _, s, _ in rows[:o]:
        got[s] += 1
    return got


def merge_tile_rounds(keys, rows, off, threads):
    """merge_tile_kernel's rounds over one tile: keys (n, P) tuples and
    their source rows in segment order, off the segments' offsets (S + 1);
    returns them merged."""
    S = len(off) - 1
    total = len(rows)
    tm = -(-max(total, 1) // threads) * threads
    e = tm // threads
    r = 0
    while (1 << r) < S:
        half, span = 1 << r, 2 << r
        n_pairs = -(-S // span)
        k_out, r_out = [None] * total, [None] * total
        for t in range(threads):
            pos, end = t * e, min(t * e + e, total)
            while pos < end:
                k = max(k for k in range(n_pairs) if off[k * span] <= pos)
                a0 = off[k * span]
                a1 = off[min(k * span + half, S)]
                b1 = off[min(k * span + span, S)]
                la, lb, d = a1 - a0, b1 - a1, pos - a0
                i, ih = max(d - lb, 0), min(d, la)
                while i < ih:  # merge path
                    im = (i + ih) >> 1
                    if not less(keys[a1 + d - 1 - im], keys[a0 + im]):
                        i = im + 1
                    else:
                        ih = im
                jb = d - i
                stop = min(end, b1)
                while pos < stop:
                    from_a = i < la and (jb >= lb or not less(keys[a1 + jb],
                                                              keys[a0 + i]))
                    at = a0 + i if from_a else a1 + jb
                    i, jb = (i + 1, jb) if from_a else (i, jb + 1)
                    k_out[pos], r_out[pos] = keys[at], rows[at]
                    pos += 1
        keys, rows = k_out, r_out
        r += 1
    return keys, rows


def emulate_merge(keys, segments, tile=None, threads=None):
    """The kernels' (sorted keys, perm, validity) for numpy keys (P, n)."""
    n_pairs, n = keys.shape
    tile = merge_tile(n_pairs) if tile is None else tile
    threads = MERGE_THREADS if threads is None else threads
    u = keys.view(np.uint64) ^ SIGN
    pstart, v, vstart = segment_table(segments)
    total = int(vstart[-1])
    S = len(segments)
    n_edges = -(-n // tile) + 1
    edges = [corank(u, pstart, v, min(j * tile, total))
             for j in range(n_edges)]
    out = (np.zeros((n_pairs, n), np.int64), np.full(n, -1, np.int64),
           np.zeros(n, bool))
    for j in range(n_edges - 1):
        o0 = j * tile
        if o0 >= total:
            continue
        c0, c1 = edges[j], edges[j + 1]
        lens = c1 - c0
        off = np.concatenate([[0], np.cumsum(lens)])
        assert off[-1] == min(tile, total - o0)
        rows = [pstart[s] + c0[s] + i for s in range(S)
                for i in range(lens[s])]
        ks = [tuple(int(u[p, r]) for p in range(n_pairs)) for r in rows]
        ks, rows = merge_tile_rounds(ks, rows, list(off), threads)
        for i, (k, r) in enumerate(zip(ks, rows)):
            out[0][:, o0 + i] = (np.array(k, np.uint64) ^ SIGN).view(np.int64)
            out[1][o0 + i] = r
            out[2][o0 + i] = True
    for r in range(n):  # the tail
        s = np.searchsorted(pstart[:-1], r, side="right") - 1
        if r - pstart[s] < v[s]:
            continue
        o = total + r - vstart[s] - v[s]
        out[0][:, o] = KEY_INVALID
        out[1][o] = r
        out[2][o] = False
    assert (out[1] >= 0).all()
    return out, (u, pstart, v, edges, tile)


def merge_rows(rng, k, buckets, counts, pool_size=400):
    """The union merge's rows: each batch a bucket whose first ``count``
    rows are its sorted distinct k-mers (drawn from one pool, so that
    batches share k-mers) and the rest KEY_INVALID."""
    nw = tk.n_words_for_k(k)
    pool = np.unique(rng.randint(0, 2**32, size=(pool_size, nw),
                                 dtype=np.uint64).astype(np.uint32), axis=0)
    if 2 * k % 32:
        pool[:, -1] &= np.uint32((0xFFFFFFFF << (32 - 2 * k % 32))
                                 & 0xFFFFFFFF)
    pool = np.unique(pool, axis=0)
    words, valids = [], []
    for bucket, count in zip(buckets, counts):
        c = min(max(count, 0), bucket)
        pick = np.sort(rng.choice(len(pool), c, replace=False))
        w = np.zeros((bucket, nw), np.uint32)
        w[:c] = pool[pick]
        words.append(w)
        valids.append(np.arange(bucket) < count)
    words = np.concatenate(words)
    valids = np.concatenate(valids)
    keys = tk.pair_keys(torch.from_numpy(words.view(np.int32)).T,
                        torch.from_numpy(valids)).numpy().copy()
    return keys, words, valids


def plain(keys, segments):
    got = tk.merge_keys_plain(torch.from_numpy(keys), segments)
    return tuple(x.numpy() for x in got)


def merge_ranks_order(words, valids):
    """grm_tpu's sort at device_build.py:182: the valid rows' positions in
    _lex_sort order of [words (invalid: all ones)..., position]."""
    r = words.shape[0]
    pos = np.where(valids, np.arange(r), 0xFFFFFFFF).astype(np.uint32)
    ops = [jnp.asarray(np.where(valids, words[:, j], np.uint32(0xFFFFFFFF)))
           for j in range(words.shape[1])]
    s = np.asarray(jk._lex_sort(ops + [jnp.asarray(pos)])[-1])
    return s[s != 0xFFFFFFFF].astype(np.int64)


def check(keys, segments, tile=None, threads=None, words=None, valids=None):
    got, (u, pstart, v, edges, tm) = emulate_merge(keys, segments, tile,
                                                   threads)
    want = plain(keys, segments)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    for j, c in enumerate(edges):
        o = min(j * tm, int(v.sum()))
        assert np.array_equal(c, brute_corank(u, pstart, v, o))
    if words is not None and valids.any():
        order = merge_ranks_order(words, valids)
        assert np.array_equal(got[1][:len(order)], order)
        dest, _, n_merged = jdb._merge_ranks(
            jnp.asarray(words), jnp.asarray(valids), words.shape[1],
            max(len(order), 1))
        dest = np.asarray(dest)[order]
        new = np.ones(len(order), bool)
        new[1:] = (got[0][:, 1:len(order)] != got[0][:, :len(order) - 1]) \
            .any(0)
        assert np.array_equal(dest, np.cumsum(new) - 1)
        assert int(n_merged) == int(new.sum())
    return got


def test_emulation_mirrors_the_source():
    src = SOURCE.read_text()
    assert MAX_SEGMENTS == tk.MAX_SORT_SEGMENTS == 1024
    assert MERGE_THREADS == 512
    assert "return P == 1 ? 4096 : (P == 4 ? 1024 : 2048);" in src
    for line in (
            "v = (uint32_t)(got < 0 ? 0 : (got < rows ? got : rows));",
            "if (x) b = 64 * (P - 1 - p) + 63 - __clzll(x);",
            ": kmin[p] & ~((2ull << (b - low)) - 1ull);",
            "y[p] = x[p] | (P - 1 - p == (b >> 6) ? 1ull << (b & 63) : 0ull);",
            "const bool take = cnt <= o;  // the o-th key is at or above y",
            "out[s] = lo[s] + (rem > before ? (rem - before < eq ? rem - before : eq)",
            "const long long o = (long long)V + r - s_vstart[s] - v;",
            "for (int r = 0; (1 << r) < S; ++r) {",
            "if (s_off[km * span] <= pos) {",
            "if (!key_less<P>(kb, ka)) {",
            "from_a = !key_less<P>(kb, ka);",
            "const uint32_t row = s_first[s] + (i - s_off[s]);",
    ):
        assert line in src, line


@pytest.mark.parametrize("k", [9, 31, 32, 33, 64])
@pytest.mark.parametrize("buckets,counts", [
    ((64, 64, 32), (50, 64, 7)),      # unequal, one full
    ((96, 40, 200), (0, 41, 130)),    # an empty one, a count past its rows
    ((64, 64), (0, 0)),               # no valid row
    ((33, 1, 95, 7), (33, 1, 90, 3)),
])
def test_merge_segments(k, buckets, counts):
    """The batches' sorted unions merged, ties in segment order, the
    invalid tails after them in input order; tile edges at every few
    rows."""
    rng = np.random.RandomState(k + sum(counts))
    keys, words, valids = merge_rows(rng, k, buckets, counts)
    segments = list(zip(buckets, counts))
    check(keys, segments, *TINY[k % 3], words=words, valids=valids)


@pytest.mark.parametrize("tiny", TINY)
def test_corank_at_tile_edges(tiny):
    """Tile edges inside runs of equal keys and at segment ends: every
    edge's co-ranks equal the brute-force ones."""
    rng = np.random.RandomState(tiny[0])
    keys, words, valids = merge_rows(rng, 31, (40, 40, 40, 40),
                                     (40, 23, 40, 17), pool_size=60)
    check(keys, [(40, 40), (40, 23), (40, 40), (40, 17)], *tiny,
          words=words, valids=valids)


@pytest.mark.parametrize("n_pairs", [1, 2])
def test_equal_keys_in_many_segments(n_pairs):
    """Each key in most of 12 segments, repeated inside a segment too:
    ties go by segment, then by position."""
    rng = np.random.RandomState(n_pairs)
    base = np.sort(rng.randint(-2**62, 2**62, size=(6, n_pairs)), axis=0)
    parts, segments = [], []
    for s in range(12):
        c = rng.randint(0, 9)
        pick = np.sort(rng.randint(0, 6, c))
        part = np.full((10, n_pairs), KEY_INVALID)
        part[:c] = base[pick]
        parts.append(part)
        segments.append((10, c))
    keys = np.concatenate(parts).T.copy()
    check(keys, segments, 8, 2)
    check(keys, segments, 16, 4)


@pytest.mark.parametrize("k", [31, 33])
def test_empty_segments(k):
    """Segments of no row and segments of no valid row among full ones."""
    rng = np.random.RandomState(k)
    buckets, counts = (0, 30, 0, 25, 10, 0), (0, 30, 0, 0, 10, 0)
    keys, words, valids = merge_rows(rng, k, buckets, counts)
    check(keys, list(zip(buckets, counts)), 8, 2, words=words,
          valids=valids)


@pytest.mark.parametrize("k", [31, 64])
def test_one_segment(k):
    """S = 1: no merge round, the tile copied."""
    rng = np.random.RandomState(k)
    keys, words, valids = merge_rows(rng, k, (50,), (37,))
    check(keys, [(50, 37)], 16, 4, words=words, valids=valids)


@pytest.mark.parametrize("k", [21, 33])
def test_the_most_segments(k):
    """S = MAX_SORT_SEGMENTS, most of them empty or of one row: ten rounds
    a tile."""
    rng = np.random.RandomState(k)
    counts = np.where(rng.rand(MAX_SEGMENTS) < 0.05,
                      rng.randint(1, 4, MAX_SEGMENTS), 0)
    buckets = counts + rng.randint(0, 2, MAX_SEGMENTS)
    keys, words, valids = merge_rows(rng, k, buckets, counts, pool_size=300)
    check(keys, list(zip(buckets.tolist(), counts.tolist())), 16, 4,
          words=words, valids=valids)


def test_the_source_tile():
    """The source's tile and threads on a merge past one tile."""
    rng = np.random.RandomState(9)
    keys, words, valids = merge_rows(rng, 31, (3000, 3000), (2500, 2000),
                                     pool_size=6000)
    check(keys, [(3000, 2500), (3000, 2000)], words=words, valids=valids)


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    """On a CPU tensor merge_keys runs merge_keys_plain (counts as ints or
    tensors) and launches nothing."""
    rng = np.random.RandomState(1)
    calls = []
    real = tk.merge_keys_plain
    monkeypatch.setattr(tk, "merge_keys_plain",
                        lambda *a: calls.append(1) or real(*a))
    _build.reset_launches()
    keys, _, _ = merge_rows(rng, 31, (64, 32), (40, 32))
    kt = torch.from_numpy(keys)
    segments = [(64, torch.tensor([40], dtype=torch.int32)), (32, 32)]
    got = tk.merge_keys(kt, segments)
    want = tk.sort_keys_plain(kt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2].tolist() == [True] * 72 + [False] * 24
    assert len(calls) == 1
    assert _build.launches["merge_keys"] == 0


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    keys = torch.zeros((1, 10), dtype=torch.int64)
    with pytest.raises(ValueError):
        tk.merge_keys(keys, [(4, 4), (5, 5)])
    with pytest.raises(ValueError):
        tk.merge_keys(keys, [(1, 1)] * 9 + [(1, torch.ones(2))])
    with pytest.raises(ValueError):
        tk.merge_keys(keys, [])
    with pytest.raises(ValueError):
        tk.merge_keys(keys, [(10, 0)] * 0 + [(0, 0)] * 1024 + [(10, 0)])
    with pytest.raises(ValueError):
        tk.merge_keys(torch.zeros((5, 10), dtype=torch.int64), [(10, 0)])


def test_the_plain_version_refuses_unsorted_segments():
    """A segment's valid rows out of order, or a row past the count that is
    not KEY_INVALID: merge_keys_plain raises (the kernel trusts them)."""
    keys = torch.tensor([[5, 3, tk.KEY_INVALID, 1, 2, tk.KEY_INVALID]])
    with pytest.raises(ValueError):
        tk.merge_keys_plain(keys, [(3, 2), (3, 2)])
    keys = torch.tensor([[3, 5, 7, 1, 2, tk.KEY_INVALID]])
    with pytest.raises(ValueError):
        tk.merge_keys_plain(keys, [(3, 2), (3, 2)])
    keys = torch.tensor([[3, 5, tk.KEY_INVALID, 1, 2, tk.KEY_INVALID]])
    assert tk.merge_keys_plain(keys, [(3, 2), (3, 2)])[1].tolist() == \
        [3, 4, 0, 1, 2, 5]
