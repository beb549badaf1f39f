"""What Python holds of the stable radix sort (``grm_tpu_torch/csrc/sort.cu``,
the wrapper :func:`grm_tpu_torch.ops.kmer.sort_keys`). The kernel runs only
on a GPU (``tests/test_torch_cuda.py``); here a numpy emulation of its
decomposition is held exactly (keys and permutation) against
``sort_keys_plain`` and its order against ``grm_tpu``'s ``_lex_sort`` on the
same inputs:

- the composite of 64 P + 1 bits (the invalid flag on top of the key planes
  ^ 2^63), its digits of ``kDigitBits`` aligned from the top, each digit
  taken as ``digit_of`` takes it: a funnel shift of the two 32-bit words
  of the composite that hold it (across planes, with the flag);
- the histograms, each digit's first output row, each group's (valid,
  invalid) OR of the key bits and of their complements, and the plan: a
  digit uniform in both groups skips its pass, the top one always runs,
  the m-th pass that runs reads the input or buffer (m - 1) % 2 and writes
  buffer m % 2 or the outputs;
- a pass's tiles of ``threads * R`` rows, warp w's rows 32 r + lane at step
  r, the stable ranks from each step's peers (the lowest lane adds their
  number to the warp's counter of the digit), one exclusive scan of the
  counters digit-major then warp, each row's slot into a slot map over the
  tile kept in input order, and the write-out slot by slot through the
  map; the tile constants parsed from the source, and tiny tiles (32, 64
  and 96 rows) so that tile edges are dense;
- the look-back, a status word a (tile, digit) shared by every pass and
  told apart by the pass's tag, ``kLookback`` tiles read a step, with the
  tiles advancing in a random order from a seed, checked against
  ``lookback`` of
  ``tests/test_torch_build_tiles.py``;
- the merge's segments: only each segment's valid prefix is sorted (a row's
  segment by binary search of the prefixes' starts), then the tail writes
  the invalid rows in input order; unequal segments, counts past a
  segment's rows, no valid row.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grm_tpu.ops import kmer as jk
from grm_tpu_torch.ops import _build
from grm_tpu_torch.ops import kmer as tk
from test_torch_build_tiles import lookback

SOURCE = Path(tk.__file__).resolve().parent.parent / "csrc" / "sort.cu"
SIGN = np.uint64(1 << 63)
ALL = np.uint64(0xFFFFFFFFFFFFFFFF)
KEY_INVALID = np.int64(2**63 - 1)
TINY = [(1, 1), (2, 1), (1, 3)]  # (warps, R): tiles of 32, 64, 96 rows


def _const(name):
    return int(re.search(r"constexpr int %s = (\d+);" % name,
                         SOURCE.read_text()).group(1))


DIGIT_BITS = _const("kDigitBits")
LOOKBACK = _const("kLookback")
THREADS = _const("kSortThreads")
MAX_SEGMENTS = _const("kMaxSegments")
BINS = 1 << DIGIT_BITS


def sort_items(n_pairs):
    """csrc/sort.cu sort_items."""
    return 16 if n_pairs == 1 else (8 if n_pairs == 2 else 4)


def radix_passes(n_pairs):
    """csrc/sort.cu radix_passes."""
    return -(-(64 * n_pairs + 1) // DIGIT_BITS)


def digit_range(n_pairs, j):
    """csrc/sort.cu digit_range: digit j's (lo, w)."""
    hi = 64 * n_pairs + 1 - DIGIT_BITS * (radix_passes(n_pairs) - 1 - j)
    lo = max(hi - DIGIT_BITS, 0)
    return lo, hi - lo


def word32(u, inv, i):
    """csrc/sort.cu word32 over rows: 32-bit word i of the composite (word
    2 (P - 1 - p) plane p's low half, the next its high half, word 2 P the
    invalid flag), as uint64."""
    n_pairs = u.shape[0]
    if i < 2 * n_pairs:
        plane = u[n_pairs - 1 - i // 2]
        return plane >> np.uint64(32) if i % 2 else plane & \
            np.uint64(0xFFFFFFFF)
    if i == 2 * n_pairs:
        return inv.astype(np.uint64)
    return np.zeros(u.shape[1], np.uint64)


def digit_of(u, inv, lo, w):
    """csrc/sort.cu digit_of over rows: u (P, n) uint64 (key ^ 2^63), inv
    (n,) 0/1; a funnel shift of the two words that hold bits [lo, lo + w)."""
    i = lo >> 5
    pair = (word32(u, inv, i + 1) << np.uint64(32)) | word32(u, inv, i)
    return ((pair >> np.uint64(lo & 31)) & np.uint64((1 << w) - 1)) \
        .astype(np.int64)


def segment_of(start, i):
    """csrc/sort.cu segment_of: the last s in [0, S) with start[s] <= i."""
    return np.searchsorted(start[:-1], i, side="right") - 1


def segment_table(segments):
    """load_segments: each segment's first row, and its first valid row
    among the rows sorted (the counts clipped to the rows)."""
    rows = np.array([int(r) for r, _ in segments], np.int64)
    pstart = np.concatenate([[0], np.cumsum(rows)])
    counts = np.clip(np.array([int(c) for _, c in segments], np.int64), 0,
                     rows)
    return pstart, np.concatenate([[0], np.cumsum(counts)])


def lookback_digits(counts, rng, resident, status, tag):
    """Each (tile, digit)'s exclusive prefix by the kernel's look-back over
    the shared status words (tag, flag, count) a (tile, digit), with up to
    ``resident`` tiles in flight advanced in a random order: a tile takes
    the next id when its block starts, publishes (tag, aggregate, its
    count) (tile 0: inclusive) for every digit, then, a step at a time,
    reads for each open digit the statuses of the LOOKBACK tiles before
    the last one it has read, and adds them in order down to the first
    inclusive one (the digit closes) or the first of another tag (not yet
    published: read again the next step). Then it publishes (tag,
    inclusive, prefix + count). Words of earlier passes stay in ``status``
    (no zeroing between passes)."""
    n_tiles, bins = counts.shape
    s_tag, s_flag, s_count = status
    prefix = np.zeros_like(counts)
    active = {}  # tile -> (back, pre, open) once its counts are published
    started = 0
    while started < n_tiles or active:
        if started < n_tiles and (not active or len(active) < resident
                                  and rng.rand() < 0.5):
            active[started] = None
            started += 1
            continue
        t = list(active)[rng.randint(len(active))]
        if active[t] is None:
            s_tag[t], s_count[t] = tag, counts[t]
            s_flag[t] = 2 if t == 0 else 1
            if t == 0:
                del active[t]
            else:
                active[t] = (np.full(bins, t - 1), np.zeros(bins, np.int64),
                             np.ones(bins, bool))
            continue
        back, pre, open_ = active[t]
        go = open_.copy()
        for _ in range(LOOKBACK):
            d = np.flatnonzero(go)
            at = back[d]
            assert (at >= 0).all()  # tile 0 is inclusive: the walk stops
            here = s_tag[at, d] == tag
            assert (at[~here] < started).all()  # waits on started tiles
            go[d[~here]] = False
            hit = d[here]
            pre[hit] += s_count[back[hit], hit]
            incl = s_flag[back[hit], hit] == 2
            back[hit] -= 1
            open_[hit[incl]] = False
            go[hit[incl]] = False
        if not open_.any():
            prefix[t] = pre
            s_flag[t], s_count[t] = 2, pre + counts[t]
            del active[t]
    return prefix


def emulate_pass(u, pay, j, n_pairs, base, tag, status, warps, r_len, rng):
    """One LSD pass of the kernel over the rows sorted (u (P, n), pay (n,)):
    returns the buffers it writes (slot by slot through each tile's stage)."""
    lo, w = digit_range(n_pairs, j)
    n = u.shape[1]
    tile = warps * 32 * r_len
    n_tiles = -(-n // tile)
    digits = digit_of(u, pay >> np.uint64(31), lo, w)
    counts = np.zeros((n_tiles, BINS), np.int64)
    slots = np.zeros(n, np.int64)
    excl = np.zeros((n_tiles, BINS + 1), np.int64)
    for t in range(n_tiles):
        items = min(tile, n - t * tile)
        cnt = np.zeros((BINS, warps), np.int64)  # s_cnt, digit-major
        rank = np.zeros(tile, np.int64)
        lanes = np.arange(32)
        for wp in range(warps):
            for r in range(r_len):
                i = wp * 32 * r_len + r * 32 + lanes
                ok = i < items
                d = np.where(ok, digits[np.minimum(t * tile + i, n - 1)], -1)
                peers = d[:, None] == d[None, :]
                leader = np.argmax(peers, 1)
                below = (peers & (lanes[None, :] < lanes[:, None])).sum(1)
                old = np.where(ok, cnt[np.maximum(d, 0), wp], 0)[leader]
                rank[i] = old + below
                lead = ok & (leader == lanes)
                cnt[d[lead], wp] += peers[lead].sum(1)
        assert cnt.max() < 2**16
        flat = np.cumsum(cnt.reshape(-1)) - cnt.reshape(-1)  # exclusive
        scan = flat.reshape(BINS, warps)
        assert scan.max() < 2**16
        excl[t, :BINS] = scan[:, 0]
        excl[t, BINS] = items
        counts[t] = excl[t, 1:] - excl[t, :BINS]
        i = np.arange(items)
        wp = i // (32 * r_len)
        slot = scan[digits[t * tile + i], wp] + rank[i]
        assert np.array_equal(np.sort(slot), i)
        slots[t * tile + i] = slot
    counts[:, 1 << w:] = 0
    assert (counts.sum(0)[:1 << w] == np.bincount(digits, minlength=1 << w)
            ).all()
    prefix = lookback_digits(counts[:, :1 << w], rng, rng.randint(1, 9),
                             [x[:, :1 << w] for x in status], tag)
    pick = rng.randint(1 << w)
    assert np.array_equal(prefix[:, pick],
                          np.cumsum(counts[:, pick]) - counts[:, pick])
    assert np.array_equal(prefix[:, pick],
                          lookback(counts[:, pick], rng, rng.randint(1, 9)))
    out_u = np.zeros_like(u)
    out_pay = np.zeros_like(pay)
    for t in range(n_tiles):
        items = min(tile, n - t * tile)
        rows = t * tile + np.arange(items)  # the tile in input order
        inv = np.full(items, -1)
        inv[slots[rows]] = np.arange(items)  # each slot's input row
        assert (inv >= 0).all()
        k = u[:, rows[inv]]
        y = pay[rows[inv]]
        d = digit_of(k, y >> np.uint64(31), lo, w)
        dest = base[d] + prefix[t, d] - excl[t, d] + np.arange(items)
        out_u[:, dest] = k
        out_pay[dest] = y
    return out_u, out_pay


def plan(u, inv, n_pairs, n_rows):
    """The histogram launches and the scan kernel: (each digit's first
    output row (n_pass, BINS), the plan [(ordinal or -1, src, dst)])."""
    n_pass = radix_passes(n_pairs)
    hist = np.zeros((n_pass, BINS), np.int64)
    for j in range(n_pass):
        lo, w = digit_range(n_pairs, j)
        hist[j] = np.bincount(digit_of(u, inv, lo, w), minlength=BINS)
    assert (hist.sum(1) == n_rows).all()
    base = np.cumsum(hist, 1) - hist
    # each group's OR of the key bits and OR of their complements
    bits = np.zeros((2, 2, n_pairs), np.uint64)
    for g in (0, 1):
        sel = inv == g
        for p in range(n_pairs):
            bits[g, 0, p] = np.bitwise_or.reduce(u[p, sel]) if sel.any() \
                else np.uint64(0)
            bits[g, 1, p] = np.bitwise_or.reduce(~u[p, sel]) if sel.any() \
                else np.uint64(0)
    runs = []
    for j in range(n_pass):
        lo, w = digit_range(n_pairs, j)
        uniform = j < n_pass - 1
        for b in range(lo, min(lo + w, 64 * n_pairs)):
            p = n_pairs - 1 - (b >> 6)
            bit = np.uint64(1 << (b & 63))
            for g in (0, 1):
                if bits[g, 0, p] & bits[g, 1, p] & bit:
                    uniform = False
        runs.append(not uniform)
    steps, m, total = [], 0, sum(runs)
    for j in range(n_pass):
        if not runs[j]:
            steps.append((-1, None, None))
            continue
        steps.append((m, "input" if m == 0 else "AB"[(m - 1) & 1],
                      "output" if m == total - 1 else "AB"[m & 1]))
        m += 1
    return base, steps


def emulate_sort(keys, valid=None, segments=None, warps=None, r_len=None,
                 seed=0, status=None):
    """The kernel's (sorted keys (P, n) int64, perm (n,) int64, sorted
    validity or None) for numpy keys (P, n) int64, valid (n,) bool or None
    and segments [(rows, count)] or None; also the plan. ``warps`` and
    ``r_len`` default to the source's tile."""
    n_pairs, n = keys.shape
    warps = THREADS // 32 if warps is None else warps
    r_len = sort_items(n_pairs) if r_len is None else r_len
    rng = np.random.RandomState(seed)
    if segments is not None:
        pstart, vstart = segment_table(segments)
        n_rows = int(vstart[-1])
        i = np.arange(n_rows)
        s = segment_of(vstart, i)
        rows = pstart[s] + i - vstart[s]
        inv = np.zeros(n_rows, np.int64)
    else:
        rows = np.arange(n)
        if valid is not None:
            inv = (~valid).astype(np.int64)
        elif n_pairs == 1:
            inv = (keys[0] == KEY_INVALID).astype(np.int64)
        else:
            inv = np.zeros(n, np.int64)
    u = keys[:, rows].view(np.uint64) ^ SIGN
    pay = rows.astype(np.uint64) | (inv.astype(np.uint64) << np.uint64(31))
    base, steps = plan(u, inv, n_pairs, len(rows))
    n_tiles = -(-max(len(rows), 1) // (warps * 32 * r_len))
    if status is None:
        status = [np.zeros((n_tiles, BINS), np.int64) for _ in range(3)]
    bufs = {"input": (u, pay)}
    for j, (m, src, dst) in enumerate(steps):
        if m < 0 or len(rows) == 0:
            continue
        bufs[dst] = emulate_pass(*bufs[src], j, n_pairs, base[j], m + 1,
                                 status, warps, r_len, rng)
    out_u, out_pay = bufs["output"] if len(rows) else bufs["input"]
    out_keys = np.empty((n_pairs, n), np.int64)
    perm = np.empty(n, np.int64)
    out_valid = np.empty(n, bool)
    k = len(rows)
    out_keys[:, :k] = (out_u ^ SIGN).view(np.int64)
    perm[:k] = (out_pay & np.uint64(0x7FFFFFFF)).astype(np.int64)
    out_valid[:k] = (out_pay >> np.uint64(31)) == 0
    if segments is not None:  # the tail kernel
        r = np.arange(n)
        s = segment_of(pstart, r)
        v = vstart[s + 1] - vstart[s]
        tail = r - pstart[s] >= v
        o = n_rows + r - vstart[s] - v
        out_keys[:, o[tail]] = KEY_INVALID
        perm[o[tail]] = r[tail]
        out_valid[o[tail]] = False
    return (out_keys, perm, None if valid is None else out_valid), steps


def plain(keys, valid=None):
    got = tk.sort_keys_plain(torch.from_numpy(keys),
                             None if valid is None else torch.from_numpy(valid))
    return tuple(None if x is None else x.numpy() for x in got)


def lex_sort_perm(keys, valid=None):
    """grm_tpu's _lex_sort over [invalid, words..., input position]: the
    sorted positions."""
    n_pairs, n = keys.shape
    u = keys.view(np.uint64) ^ SIGN
    if valid is None:
        inv = keys[0] == KEY_INVALID if n_pairs == 1 else np.zeros(n, bool)
    else:
        inv = ~valid
    ops = [jnp.asarray(inv.astype(np.uint32))]
    for p in range(n_pairs):
        ops.append(jnp.asarray((u[p] >> np.uint64(32)).astype(np.uint32)))
        ops.append(jnp.asarray((u[p] & np.uint64(0xFFFFFFFF))
                               .astype(np.uint32)))
    ops.append(jnp.asarray(np.arange(n, dtype=np.uint32)))
    return np.asarray(jk._lex_sort(ops)[-1]).astype(np.int64)


def check(keys, valid=None, segments=None, **tile):
    """The emulation == sort_keys_plain exactly and == _lex_sort's order."""
    got, steps = emulate_sort(keys, valid, segments, **tile)
    want = plain(keys, valid)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    if valid is None:
        assert want[2] is None
    else:
        assert np.array_equal(got[2], want[2])
    if keys.shape[1]:
        assert np.array_equal(got[1], lex_sort_perm(keys, valid))
    return steps


def window_keys(rng, k, n_genomes, length, dup=False):
    """The windows' keys (and validity past k = 31) of random genomes with
    runs of 4s; with ``dup`` every genome is a copy of the first with a
    few changes, so that every k-mer repeats across genomes."""
    codes = rng.randint(0, 4, size=(n_genomes, length)).astype(np.int8)
    if dup:
        codes[:] = codes[0]
        for row in codes[1:]:
            row[rng.randint(0, length, 3)] = rng.randint(0, 4, 3)
    for row in codes:
        at = rng.randint(0, length)
        row[at:at + rng.randint(1, 9)] = 4
    keys, valid = tk.window_keys(torch.from_numpy(codes), k)
    return keys.numpy().copy(), None if valid is None else valid.numpy()


def test_emulation_mirrors_the_source():
    """The constants above are csrc/sort.cu's, and the lines the emulation
    follows are the kernel's."""
    src = SOURCE.read_text()
    assert DIGIT_BITS == 8 and BINS == 256 and THREADS == 256
    assert LOOKBACK == 1
    assert "return P == 1 ? 16 : (P == 2 ? 8 : 4);" in src
    assert MAX_SEGMENTS == tk.MAX_SORT_SEGMENTS
    assert "constexpr int kMaxPlanes = %d;" % tk.MAX_SORT_PAIRS in src
    for line in (
            "return 64 * P + 1 - kDigitBits * (radix_passes(P) - 1 - j);",
            "return digit_hi(P, j) - kDigitBits > 0 ? digit_hi(P, j) - kDigitBits : 0;",
            "return __funnelshift_r(word32<P>(u, inv, i), word32<P>(u, inv, i + 1),",
            "if (i == 2 * (P - 1 - p) + 1) v = (uint32_t)(u[p] >> 32);",

            "const int i = warp * 32 * R + r * 32 + lane;",
            "rank[r] = old + __popc(peers & lt);",
            "*c = (uint16_t)(old + __popc(peers));",
            "if (i < items) s_inv[rank[r] + s_cnt[dig[r] * kSortWarps + warp]] = i;",
            "s_base[d] = (int)(base[d] + pre[q]) - (int)s_excl[d];",
            "const int dest = s_base[digit_of<P>(k, y >> 31, lo, w)] + s;",
            "const int i = s_inv[s];",
            "st[q][k] = fresh ? first[q][k]",
            "const int s = r * kSortThreads + threadIdx.x;",
            "const long long o = n_rows + r - s_vstart[s] - v;",
            "row = (long long)s_pstart[s] + (i - s_vstart[s]);",
            "pl[1] = m == 0 ? kInput : kBufferA + ((m - 1) & 1);",
            "pl[2] = m == runs - 1 ? kInput : kBufferA + (m & 1);",
            "bool uniform = j < n_pass - 1;",
            "if ((v >> kTagShift) != (unsigned long long)(m + 1)) {",
            "if (v & kInclusive) open[q] = go = false;",
            "const int t = back[q] - k;",
            "*inv = a.keyed && u[0] == ~0ull;",
    ):
        assert line in src, line


def live_passes(k):
    """The digits that hold one of a key's 2k live bits or the invalid
    flag: the passes that run."""
    n_pairs = -(-tk.n_words_for_k(k) // 2)
    return sum(digit_range(n_pairs, j)[0] + digit_range(n_pairs, j)[1]
               > 64 * n_pairs - 2 * k for j in range(radix_passes(n_pairs)))


@pytest.mark.parametrize("k,live", [(1, 1), (5, 2), (21, 6), (31, 8),
                                    (32, 9), (33, 9), (63, 16)])
def test_passes_run_only_over_live_bits(k, live):
    """Digits below a valid key's live bits are uniform and skip their
    pass: 2k bits and the invalid flag, in digits of 8 from the top."""
    rng = np.random.RandomState(k)
    keys, valid = window_keys(rng, k, 3, 700)
    steps = check(keys, valid)
    assert sum(m >= 0 for m, _, _ in steps) == live == live_passes(k)
    assert steps[-1][0] >= 0 and steps[-1][2] == "output"


@pytest.mark.parametrize("warps,r_len", [(None, None)] + TINY)
@pytest.mark.parametrize("k", [1, 5, 21, 31, 32, 33, 63])
def test_windows_of_genomes(k, warps, r_len):
    """A batch's windows, genome by genome, runs of 4s in each row."""
    rng = np.random.RandomState(100 * k + (warps or 0))
    keys, valid = window_keys(rng, k, 4, 1500 + 7 * k)
    check(keys, valid, warps=warps, r_len=r_len)


@pytest.mark.parametrize("k", [15, 31, 33])
def test_duplicates_across_genomes_keep_genome_order(k):
    """Every k-mer in every genome: the ties' order is the input's."""
    rng = np.random.RandomState(k)
    keys, valid = window_keys(rng, k, 6, 900, dup=True)
    check(keys, valid, warps=2, r_len=1)
    check(keys, valid)


@pytest.mark.parametrize("n_pairs,with_valid", [(1, False), (1, True),
                                                (2, True), (4, True)])
def test_every_row_invalid(n_pairs, with_valid):
    keys = np.full((n_pairs, 333), KEY_INVALID)
    valid = np.zeros(333, bool) if with_valid else None
    check(keys, valid, warps=1, r_len=3)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 95, 4097])
def test_sizes_around_the_tile(n):
    rng = np.random.RandomState(n)
    keys = (rng.randint(0, 2**62, size=(1, n), dtype=np.int64)
            & ~np.int64((1 << 4) - 1)) ^ np.int64(-2**63)
    keys[0, rng.rand(n) < 0.2] = KEY_INVALID
    check(keys)
    check(keys, warps=1, r_len=1)


@pytest.mark.parametrize("k", [31, 32])
def test_all_t_kmer_against_the_sentinel(k):
    """The all-T k-mer (every live bit set) sorts before the invalid rows:
    at k = 31 its key differs from KEY_INVALID only in bits below the live
    ones; at k = 32 it equals KEY_INVALID and only ``valid`` tells them
    apart. A canonical k-mer is never all T; the sort does not rely on it."""
    rng = np.random.RandomState(k)
    n = 500
    u = rng.randint(0, 2**62, size=n, dtype=np.int64).view(np.uint64) << \
        np.uint64(2)
    u &= ~np.uint64((1 << (64 - 2 * k)) - 1) if k < 32 else ALL
    all_t = ~np.uint64((1 << (64 - 2 * k)) - 1) if k < 32 else ALL
    u[rng.rand(n) < 0.3] = all_t
    keys = (u ^ SIGN).view(np.int64)[None].copy()
    valid = rng.rand(n) > 0.3
    keys[0, ~valid] = KEY_INVALID
    if k <= 31:
        steps = check(keys)
        got = emulate_sort(keys)[0]
        first = int((keys[0] != KEY_INVALID).sum())
        assert (got[0][0, :first] != KEY_INVALID).all()
        assert sum(m >= 0 for m, _, _ in steps) == live_passes(k)
    steps = check(keys, valid)
    got = emulate_sort(keys, valid)[0]
    assert got[2][:valid.sum()].all() and not got[2][valid.sum():].any()


def merge_rows(rng, k, buckets, counts):
    """The union merge's rows: each batch a bucket whose first ``count``
    rows are its sorted distinct k-mers (drawn from one pool, so that
    batches share k-mers) and the rest KEY_INVALID; the validity plane
    past k = 31."""
    nw = tk.n_words_for_k(k)
    pool = np.unique(rng.randint(0, 2**32, size=(400, nw), dtype=np.uint64)
                     .astype(np.uint32), axis=0)
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
    words = torch.from_numpy(np.concatenate(words).view(np.int32))
    valids = torch.from_numpy(np.concatenate(valids))
    keys = tk.pair_keys(words.T, valids).numpy().copy()
    return keys, (None if k <= 31 else valids.numpy())


@pytest.mark.parametrize("k", [9, 31, 32, 33, 64])
@pytest.mark.parametrize("buckets,counts", [
    ((64, 64, 32), (50, 64, 7)),      # unequal, one full
    ((96, 40, 200), (0, 41, 130)),    # an empty one, a count past its rows
    ((64, 64), (0, 0)),               # no valid row
    ((33, 1, 95, 7), (33, 1, 90, 3)),
])
def test_merge_segments(k, buckets, counts):
    """Only each segment's valid prefix is sorted; the invalid tails follow
    in input order, as the whole sort would leave them."""
    rng = np.random.RandomState(k + sum(counts))
    keys, valid = merge_rows(rng, k, buckets, counts)
    segments = list(zip(buckets, counts))
    steps = check(keys, valid, segments)
    check(keys, valid, segments, warps=1, r_len=1)
    if sum(counts) and k <= 31:
        assert sum(m >= 0 for m, _, _ in steps) == live_passes(k)


def test_status_words_are_shared_by_the_passes():
    """One status array for every pass of a sort: a word of an earlier pass
    (another tag) reads as not yet published."""
    rng = np.random.RandomState(3)
    keys, _ = window_keys(rng, 31, 3, 800)
    n_tiles = -(-keys.shape[1] // 64)
    status = [np.zeros((n_tiles, BINS), np.int64) for _ in range(3)]
    got, steps = emulate_sort(keys, warps=2, r_len=1, status=status)
    assert status[0].max() == sum(m >= 0 for m, _, _ in steps)
    want = plain(keys)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    """On a CPU tensor sort_keys runs sort_keys_plain (segments or not),
    launches nothing, and its outputs are the plain version's."""
    rng = np.random.RandomState(1)
    calls = []
    real = tk.sort_keys_plain
    monkeypatch.setattr(tk, "sort_keys_plain",
                        lambda *a: calls.append(1) or real(*a))
    _build.reset_launches()
    for k in (31, 33):
        keys, valid = window_keys(rng, k, 2, 300)
        kt = torch.from_numpy(keys)
        vt = None if valid is None else torch.from_numpy(valid)
        got = tk.sort_keys(kt, vt)
        want = real(kt, vt)
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)
    keys, valid = merge_rows(rng, 31, (64, 32), (40, 32))
    got = tk.sort_keys(torch.from_numpy(keys), None,
                       segments=[(64, torch.tensor([40], dtype=torch.int32)),
                                 (32, 32)])
    want = real(torch.from_numpy(keys))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(calls) == 3
    assert _build.launches["radix_sort"] == 0


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    keys = torch.zeros((1, 10), dtype=torch.int64)
    with pytest.raises(ValueError):
        tk.sort_keys(torch.zeros((5, 10), dtype=torch.int64))
    with pytest.raises(ValueError):
        tk.sort_keys(keys.to(torch.int32))
    with pytest.raises(ValueError):
        tk.sort_keys(keys, torch.ones(9, dtype=torch.bool))
    with pytest.raises(ValueError):
        tk.sort_keys(keys, segments=[(4, 4), (5, 5)])
    with pytest.raises(ValueError):
        tk.sort_keys(keys, segments=[(1, 1)] * 9 + [(1, torch.ones(2))])
