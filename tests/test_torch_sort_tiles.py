"""What Python holds of the stable hybrid radix sort
(``grm_tpu_torch/csrc/sort.cu``, the wrapper
:func:`grm_tpu_torch.ops.kmer.sort_keys`). The kernels run only on a GPU
(``tests/test_torch_cuda.py``); here a numpy emulation of their
decomposition is held exactly (keys and permutation) against
``sort_keys_plain`` and its order against ``grm_tpu``'s ``_lex_sort`` on the
same inputs:

- the composite of 64 P + 1 bits (the invalid flag on top of the key planes
  ^ 2^63), its digits of ``kDigitBits`` aligned from the top, each taken as
  ``digit_of`` takes it (a funnel shift of two 32-bit words of the
  composite); each group's (valid, invalid) OR of the key bits and of their
  complements, and the plan: the top digit always live, a digit below it
  dead where it is uniform in both groups, each level's digit the next
  live one;
- the MSD levels: level 1 over the input in chunks of ``kChunkTiles``
  tiles, each next level over the buckets past the local capacity, each
  bucket's chunks; each chunk's histogram of the level's digit (the count
  kernel), the scan kernel's totals in four quarters, the sub-buckets'
  first rows and each chunk's first output row of each digit, the next
  level's buckets and chunks allocated in whatever order the scan blocks
  run (a random order from a seed); the scatter's tiles in a chunk in
  order, each with the warps' stable ranks (warp w's rows 32 r + lane at
  step r, the peers found by an atomicOr into the warp's mask of the digit,
  the lowest peer adding their number to the warp's counter of the digit),
  one exclusive scan of the counters digit-major then warp, the
  slot map, and the write-out slot by slot; the chunks taken in a random
  order;
- the jobs: the sub-buckets walked in order, those past the capacity to the
  next level (or, with no live digit left, to a copy job), consecutive
  others packed into jobs of at most the capacity (a packed job sorts by
  the level's digit too); the local sort of each job (in a random order):
  its rows in shared memory, LSD passes over the live digits up to its top
  through an index, positions warp-major with ``re = ceil(rows /
  threads)`` steps, the same ranks, counters and scan; a job with no digit
  copied;
- tiny tiles, chunks and capacities so that the CPU reaches several
  levels, oversized buckets, packed jobs, copy jobs and the skewed top
  digit of canonical k-mers; the constants of the source parsed from it.
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

SOURCE = Path(tk.__file__).resolve().parent.parent / "csrc" / "sort.cu"
SIGN = np.uint64(1 << 63)
ALL = np.uint64(0xFFFFFFFFFFFFFFFF)
KEY_INVALID = np.int64(2**63 - 1)


def _const(name):
    return int(re.search(r"constexpr int %s = (\d+);" % name,
                         SOURCE.read_text()).group(1))


DIGIT_BITS = _const("kDigitBits")
SCATTER_THREADS = _const("kScatterThreads")
CHUNK_TILES = _const("kChunkTiles")
LOCAL_THREADS = _const("kLocalThreads")
MAX_PLANES = _const("kMaxPlanes")
BINS = 1 << DIGIT_BITS


def scatter_rows(n_pairs):
    """csrc/sort.cu scatter_rows."""
    return 16 if n_pairs == 1 else (8 if n_pairs == 2 else 4)


def local_steps(n_pairs):
    """csrc/sort.cu local_steps."""
    return {1: 12, 2: 8, 3: 6}.get(n_pairs, 4)


# Tiny configurations: (scatter warps, rows a thread, tiles a chunk, local
# warps, local steps, level 1's chunks a count block): tiles of 32 to 96
# rows, capacities of 64 to 192.
TINY = [(1, 1, 2, 1, 2, 2), (2, 1, 3, 2, 1, 3), (1, 3, 1, 2, 3, 1)]
SMS = 132  # the H100's SMs: level 1's count blocks, about four an SM


def n_digits(n_pairs):
    """csrc/sort.cu n_digits."""
    return -(-(64 * n_pairs + 1) // DIGIT_BITS)


def digit_range(n_pairs, j):
    """csrc/sort.cu digit_lo / digit_hi: digit j's (lo, w)."""
    hi = 64 * n_pairs + 1 - DIGIT_BITS * (n_digits(n_pairs) - 1 - j)
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


def make_plan(u, inv, n_pairs):
    """make_plan over the count kernel's ORs: (live digits, level digits
    from level 1, -1 past the last)."""
    nd = n_digits(n_pairs)
    bits = np.zeros((2, 2, n_pairs), np.uint64)
    for g in (0, 1):
        sel = inv == g
        if sel.any():
            for p in range(n_pairs):
                bits[g, 0, p] = np.bitwise_or.reduce(u[p, sel])
                bits[g, 1, p] = np.bitwise_or.reduce(~u[p, sel])
    live = []
    for j in range(nd):
        lo, w = digit_range(n_pairs, j)
        on = j == nd - 1
        for b in range(lo, min(lo + w, 64 * n_pairs)):
            p = n_pairs - 1 - (b >> 6)
            bit = np.uint64(1 << (b & 63))
            on |= any(bool(bits[g, 0, p] & bits[g, 1, p] & bit)
                      for g in (0, 1))
        live.append(on)
    levels, j = [None, nd - 1], nd - 1
    while len(levels) < nd + 2:
        while j >= 0:
            j -= 1
            if j < 0 or live[j]:
                break
        levels.append(j if j >= 0 else -1)
    return live, levels


def block_slots(digits, warps, steps):
    """The stable slots of a tile's (or a job's) rows by digit, as the
    scatter and local kernels make them: positions warp-major (warp w's
    [32 steps w, 32 steps (w + 1)), position 32 r + lane at step r); per
    step the peers of one digit, the lowest adding their number to the
    warp's counter of it; one exclusive scan of the counters, digit-major
    then warp. Returns (slots, the rows before each digit (BINS + 1,))."""
    items = len(digits)
    cnt = np.zeros((BINS, warps), np.int64)
    rank = np.zeros(items, np.int64)
    lanes = np.arange(32)
    for wp in range(warps):
        for r in range(steps):
            i = wp * 32 * steps + r * 32 + lanes
            ok = i < items
            d = np.where(ok, digits[np.minimum(i, max(items - 1, 0))]
                         if items else -1, -1)
            peers = d[:, None] == d[None, :]
            below = (peers & (lanes[None, :] < lanes[:, None])).sum(1)
            rank[i[ok]] = cnt[d[ok], wp] + below[ok]
            np.add.at(cnt[:, wp], d[ok], 1)
    assert cnt.max(initial=0) < 2**16
    scan = (np.cumsum(cnt.reshape(-1)) - cnt.reshape(-1)).reshape(BINS, warps)
    assert scan.max(initial=0) < 2**16
    i = np.arange(items)
    slots = scan[digits, i // (32 * steps)] + rank if items else rank
    assert np.array_equal(np.sort(slots), i)
    excl = np.append(scan[:, 0], items)
    return slots, excl


class Emulation:
    """The kernels of one sort, step by step; ``stats`` counts what ran."""

    def __init__(self, keys, valid=None, warps=None, steps=None,
                 chunk_tiles=None, local_warps=None, local=None,
                 range_chunks=None, seed=0):
        self.n_pairs, self.n = keys.shape
        self.warps = SCATTER_THREADS // 32 if warps is None else warps
        self.steps = scatter_rows(self.n_pairs) if steps is None else steps
        self.chunk_tiles = CHUNK_TILES if chunk_tiles is None else chunk_tiles
        self.local_warps = LOCAL_THREADS // 32 if local_warps is None \
            else local_warps
        self.local_steps = local_steps(self.n_pairs) if local is None \
            else local
        self.tile = self.warps * 32 * self.steps
        self.chunk = self.chunk_tiles * self.tile
        self.capacity = self.local_warps * 32 * self.local_steps
        n_chunks = -(-keys.shape[1] // self.chunk)
        self.range_chunks = -(-n_chunks // (4 * SMS)) \
            if range_chunks is None else range_chunks
        self.rng = np.random.RandomState(seed)
        n = self.n
        if valid is not None:
            inv = (~valid).astype(np.uint64)
        elif self.n_pairs == 1:
            inv = (keys[0] == KEY_INVALID).astype(np.uint64)
        else:
            inv = np.zeros(n, np.uint64)
        self.u = keys.view(np.uint64) ^ SIGN
        self.pay = np.arange(n, dtype=np.uint64) | (inv << np.uint64(31))
        self.live, self.levels = make_plan(self.u, inv, self.n_pairs)
        self.bufs = [(np.zeros_like(self.u), np.zeros(n, np.uint64))
                     for _ in range(2)]
        self.jobs = []
        self.stats = {"levels": 0, "chunks": 0, "buckets": 0, "packed": 0,
                      "single": 0, "copies": 0, "oversized": 0}

    def flag(self, pay):
        return pay >> np.uint64(31)

    def run(self):
        buckets = [(0, self.n)]  # level 1's
        for level in range(1, n_digits(self.n_pairs) + 1):
            if not buckets:
                continue  # launched, exits at once
            buckets = self.level(level, buckets)
        assert not buckets
        out = (np.zeros((self.n_pairs, self.n), np.int64),
               np.zeros(self.n, np.int64), np.zeros(self.n, bool))
        order = self.rng.permutation(len(self.jobs))
        written = np.zeros(self.n, np.int64)
        for k in order:
            self.local(self.jobs[k], out, written)
        assert (written == 1).all()  # every row written once
        return out

    def level(self, level, buckets):
        jd = self.levels[level]
        lo, w = digit_range(self.n_pairs, jd)
        src = (self.u, self.pay) if level == 1 else self.bufs[level & 1]
        dst = self.bufs[(level - 1) & 1]
        self.stats["levels"] = level
        # The chunks: each bucket's ceil(size / chunk), in allocation order.
        chunks = []
        for b, (start, size) in enumerate(buckets):
            for c in range(-(-size // self.chunk)):
                begin = start + c * self.chunk
                chunks.append((b, begin, min(begin + self.chunk,
                                             start + size)))
        self.stats["chunks"] += len(chunks)
        digits = np.zeros(self.n, np.int64)
        for _, begin, end in chunks:
            digits[begin:end] = digit_of(src[0][:, begin:end],
                                         self.flag(src[1][begin:end]), lo, w)
        counts = np.array([np.bincount(digits[b:e], minlength=BINS)
                           for _, b, e in chunks]).reshape(-1, BINS)
        if level == 1:
            # Count block r takes chunks [r K, (r + 1) K): each chunk's
            # counts become the range's before it, the range's sums apart;
            # the scan's units are the ranges.
            k = self.range_chunks
            units = np.array([counts[r:r + k].sum(0)
                              for r in range(0, len(chunks), k)])
            prefix = np.zeros_like(counts)
            for r in range(0, len(chunks), k):
                part = counts[r:r + k]
                prefix[r:r + k] = np.cumsum(part, 0) - part
            unit_of = [[i for i in range(len(units))]]
        else:
            units, prefix = counts, np.zeros_like(counts)
            unit_of = [[i for i, ch in enumerate(chunks) if ch[0] == b]
                       for b in range(len(buckets))]
        # The scan: per bucket, four quarters of its units, the totals, the
        # sub-buckets' first rows, each unit's first output rows.
        offsets = np.zeros_like(units)
        nxt = []
        order = self.rng.permutation(len(buckets))  # scan blocks' order
        for b in order:
            start, size = buckets[b]
            ids = unit_of[b]
            nu = len(ids)
            quarters = [ids[nu * q // 4:nu * (q + 1) // 4] for q in range(4)]
            part = np.array([units[q].sum(0) if q else np.zeros(BINS, np.int64)
                             for q in quarters])
            total = part.sum(0)
            assert total.sum() == size
            sub = start + np.concatenate([[0], np.cumsum(total)])
            for qi, q in enumerate(quarters):
                run = sub[:BINS] + part[:qi].sum(0)
                for c in q:
                    offsets[c] = run
                    run = run + units[c]
            nxt += self.walk(level, jd, sub)
        if level == 1:
            offsets = offsets[np.arange(len(chunks)) // self.range_chunks] \
                + prefix
        # The scatter: chunks in any order, tiles in order within one.
        for c in self.rng.permutation(len(chunks)):
            _, begin, end = chunks[c]
            base = offsets[c].copy()
            for row0 in range(begin, end, self.tile):
                rows = np.arange(row0, min(row0 + self.tile, end))
                slots, excl = block_slots(digits[rows], self.warps,
                                          self.steps)
                inv = np.empty(len(rows), np.int64)
                inv[slots] = np.arange(len(rows))  # each slot's input row
                at = rows[inv]
                d = digits[at]
                dest = base[d] - excl[d] + np.arange(len(rows))
                dst[0][:, dest] = src[0][:, at]
                dst[1][dest] = src[1][at]
                base += excl[1:] - excl[:BINS]
        return nxt

    def walk(self, level, jd, sub):
        """The scan's walk over one bucket's sub-buckets: the next level's
        buckets, the jobs (packed runs, copies)."""
        nxt, run = [], []
        nd = self.levels[level + 1]
        buf = (level - 1) & 1

        def close():
            if run:
                self.jobs.append((run[0][0], sum(s for _, s in run),
                                  nd if len(run) == 1 else jd, buf))
                self.stats["packed" if len(run) > 1 else "single"] += 1
                run.clear()

        for v in range(BINS):
            start, size = int(sub[v]), int(sub[v + 1] - sub[v])
            if size == 0:
                continue
            if size > self.capacity:
                close()
                self.stats["oversized"] += 1
                if nd >= 0:
                    nxt.append((start, size))
                    self.stats["buckets"] += 1
                else:
                    self.jobs.append((start, size, -1, buf))
                continue
            if sum(s for _, s in run) + size > self.capacity:
                close()
            run.append((start, size))
        close()
        return nxt

    def local(self, job, out, written):
        start, size, jtop, buf = job
        keys, pay = self.bufs[buf]
        rows = np.arange(start, start + size)
        live = [j for j in range(jtop + 1) if self.live[j]]
        idx = np.arange(size)
        if live:
            assert size <= self.capacity
            re_ = -(-size // (self.local_warps * 32))
            assert re_ <= self.local_steps
            for j in live:
                lo, w = digit_range(self.n_pairs, j)
                at = rows[idx]
                digits = digit_of(keys[:, at], self.flag(pay[at]), lo, w)
                slots, _ = block_slots(digits, self.local_warps, re_)
                nidx = np.empty_like(idx)
                nidx[slots] = idx
                idx = nidx
        else:
            self.stats["copies"] += 1
        at = rows[idx]
        out[0][:, rows] = (keys[:, at] ^ SIGN).view(np.int64)
        out[1][rows] = (pay[at] & np.uint64(0x7FFFFFFF)).astype(np.int64)
        out[2][rows] = self.flag(pay[at]) == 0
        written[rows] += 1


def emulate_sort(keys, valid=None, tiny=None, seed=0):
    """The kernels' (sorted keys, perm, sorted validity or None) and the
    emulation; ``tiny`` one of TINY, or None for the source's sizes."""
    cfg = {} if tiny is None else dict(zip(
        ("warps", "steps", "chunk_tiles", "local_warps", "local",
         "range_chunks"), tiny))
    em = Emulation(keys, valid, seed=seed, **cfg)
    if keys.shape[1] == 0:
        got = (keys.copy(), np.zeros(0, np.int64), np.zeros(0, bool))
    else:
        got = em.run()
    return (got[0], got[1], None if valid is None else got[2]), em


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


def check(keys, valid=None, tiny=None, seed=0):
    """The emulation == sort_keys_plain exactly and == _lex_sort's order."""
    got, em = emulate_sort(keys, valid, tiny, seed)
    want = plain(keys, valid)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    if valid is None:
        assert want[2] is None
    else:
        assert np.array_equal(got[2], want[2])
    if keys.shape[1]:
        assert np.array_equal(got[1], lex_sort_perm(keys, valid))
    return em


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
    follows are the kernels'."""
    src = SOURCE.read_text()
    assert DIGIT_BITS == 8 and BINS == 256 and SCATTER_THREADS == 256
    assert CHUNK_TILES == 4 and LOCAL_THREADS == 1024
    assert MAX_PLANES == tk.MAX_SORT_PAIRS
    assert "return P == 1 ? 16 : (P == 2 ? 8 : 4);" in src
    assert "return P == 1 ? 12 : (P == 2 ? 8 : (P == 3 ? 6 : 4));" in src
    for line in (
            "return 64 * P + 1 - kDigitBits * (n_digits(P) - 1 - j);",
            "return digit_hi(P, j) - kDigitBits > 0 ? digit_hi(P, j) - kDigitBits : 0;",
            "return __funnelshift_r(word32<P>(u, inv, i), word32<P>(u, inv, i + 1),",
            "if (i == 2 * (P - 1 - p) + 1) v = (uint32_t)(u[p] >> 32);",
            "bool live = j == nd - 1;",
            "const uint32_t c0 = u0 + (uint32_t)((unsigned long long)nu * q / 4);",
            "a.counts[(long long)c * kBins + threadIdx.x] = kInputSrc ? before : sum;",
            "a.range_chunks = (int)((l1_chunks + 4LL * sms - 1) / (4LL * sms));",
            "(kInputSrc ? (int)a.ranges[(long long)(c / a.range_chunks) * kBins +",
            "a.jobs[k] = Job{run_start, run_size, run_n == 1 ? next : jd, buf};",
            "if (sz > C) {",
            "if (run_size + sz > C) close_run();",
            "a.jobs[k] = Job{s_start[v], sz, -1, buf};",
            "const int i = warp * 32 * R + r * 32 + lane;",
            "rank[r] = old + __popc(peers & lt);",
            "*cp = (uint16_t)(old + __popc(peers));",
            "if (i < items) s_inv[rank[r] + s_cnt[warp * kCntStride + dig[r]]] = i;",
            "s_off[threadIdx.x] = s_base[threadIdx.x] - (int)s_excl[threadIdx.x];",
            "const long long dest = s_off[digit_of<P>(k, y >> 31, lo, w)] + s;",
            "(int)s_excl[threadIdx.x + 1] - (int)s_excl[threadIdx.x];",
            "const int pos = warp * 32 * re + r * 32 + lane;",
            "const int re = (size + kLocalThreads - 1) / kLocalThreads;",
            "to[s_cnt[warp * kCntStride + dig[r]] + rank[r]] = (uint16_t)row[r];",
            "for (int j = 0; j <= job.jtop; ++j) top = s_live[j] ? j : top;",
            "*inv = a.keyed && u[0] == ~0ull;",
            "const int src = L & 1, dst = (L - 1) & 1;",
    ):
        assert line in src, line


def live_digits(k):
    """The digits that hold one of a key's 2k live bits or the invalid
    flag."""
    n_pairs = -(-tk.n_words_for_k(k) // 2)
    return sum(digit_range(n_pairs, j)[0] + digit_range(n_pairs, j)[1]
               > 64 * n_pairs - 2 * k for j in range(n_digits(n_pairs)))


@pytest.mark.parametrize("k,live", [(1, 1), (5, 2), (21, 6), (31, 8),
                                    (32, 9), (33, 9), (63, 16)])
def test_levels_and_passes_take_only_live_digits(k, live):
    """Digits below a valid key's live bits are dead: 2k bits and the
    invalid flag, in digits of 8 from the top; the levels take them from
    the top, the local passes the rest."""
    rng = np.random.RandomState(k)
    keys, valid = window_keys(rng, k, 3, 700)
    em = check(keys, valid, TINY[0])
    assert sum(em.live) == live == live_digits(k)
    assert em.levels[1] == n_digits(em.n_pairs) - 1
    lv = [j for j in em.levels[1:] if j >= 0]
    assert lv == [j for j in reversed(range(n_digits(em.n_pairs)))
                  if em.live[j]]


@pytest.mark.parametrize("tiny", [None] + TINY)
@pytest.mark.parametrize("k", [1, 5, 21, 31, 32, 33, 63])
def test_windows_of_genomes(k, tiny):
    """A batch's windows, genome by genome, runs of 4s in each row."""
    rng = np.random.RandomState(100 * k + (0 if tiny is None else tiny[0]))
    keys, valid = window_keys(rng, k, 4, 1500 + 7 * k)
    check(keys, valid, tiny)


@pytest.mark.parametrize("k", [15, 31, 33])
def test_duplicates_across_genomes_keep_genome_order(k):
    """Every k-mer in every genome: the ties' order is the input's."""
    rng = np.random.RandomState(k)
    keys, valid = window_keys(rng, k, 6, 900, dup=True)
    check(keys, valid, TINY[1])
    check(keys, valid)


@pytest.mark.parametrize("n_pairs,with_valid", [(1, False), (1, True),
                                                (2, True), (4, True)])
def test_every_row_invalid(n_pairs, with_valid):
    """One bucket of equal rows at every level: copied, in input order."""
    keys = np.full((n_pairs, 333), KEY_INVALID)
    valid = np.zeros(333, bool) if with_valid else None
    em = check(keys, valid, TINY[2])
    assert em.stats["copies"] == 1 and len(em.jobs) == 1


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 95, 4097])
def test_sizes_around_the_tile(n):
    rng = np.random.RandomState(n)
    keys = (rng.randint(0, 2**62, size=(1, n), dtype=np.int64)
            & ~np.int64((1 << 4) - 1)) ^ np.int64(-2**63)
    keys[0, rng.rand(n) < 0.2] = KEY_INVALID
    check(keys)
    check(keys, tiny=TINY[0])


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
        em = check(keys, tiny=TINY[1])
        got = emulate_sort(keys)[0]
        first = int((keys[0] != KEY_INVALID).sum())
        assert (got[0][0, :first] != KEY_INVALID).all()
        assert sum(em.live) == live_digits(k)
    check(keys, valid, TINY[1])
    got = emulate_sort(keys, valid)[0]
    assert got[2][:valid.sum()].all() and not got[2][valid.sum():].any()


@pytest.mark.parametrize("tiny", TINY[:2] + [(1, 3, 1, 1, 1, 4)])
@pytest.mark.parametrize("k", [21, 31, 33])
def test_oversized_buckets_go_a_level_deeper(k, tiny):
    """With a capacity of one or two tiles (32 or 64 rows), level 1's
    buckets overflow into level 2 and beyond, each bucket in chunks of its
    own."""
    rng = np.random.RandomState(k + tiny[0])
    keys, valid = window_keys(rng, k, 3, 2000)
    em = check(keys, valid, tiny)
    assert em.stats["levels"] >= 3 and em.stats["buckets"] > 0
    assert em.stats["chunks"] > -(-keys.shape[1] // em.chunk)


@pytest.mark.parametrize("tiny", [None, TINY[1]])
def test_tiny_buckets_are_packed(tiny):
    """One genome's windows spread over many sub-buckets of a few rows:
    consecutive sub-buckets share a job, sorted by the level's digit too."""
    rng = np.random.RandomState(17)
    keys, valid = window_keys(rng, 31, 1, 3000)
    em = check(keys, valid, tiny)
    assert em.stats["packed"] > 0
    assert len(em.jobs) < sum(1 for j in em.jobs if j[1]) + 1
    assert max(j[1] for j in em.jobs if j[2] >= 0) <= em.capacity


@pytest.mark.parametrize("tiny", TINY)
def test_skewed_top_digit(tiny):
    """Canonical k-mers start with A or C more often than G or T: the top
    digit's buckets differ several fold; the large ones go deeper, the
    small ones are packed."""
    rng = np.random.RandomState(23)
    keys, _ = window_keys(rng, 31, 4, 1500)
    u = keys[0].view(np.uint64) ^ SIGN
    first = (u[keys[0] != KEY_INVALID] >> np.uint64(62)).astype(np.int64)
    share = np.bincount(first, minlength=4) / len(first)
    assert share[0] > 2.5 * share[3]  # 7/16 against 1/16
    em = check(keys, None, tiny)
    assert em.stats["oversized"] > 0 and em.stats["packed"] > 0


@pytest.mark.parametrize("n_pairs", [1, 2])
def test_equal_rows_past_the_capacity_are_copied(n_pairs):
    """A bucket of equal valid rows larger than the capacity goes down to
    the last live digit, then is copied as it is (input order)."""
    rng = np.random.RandomState(n_pairs)
    u = rng.randint(0, 2**62, size=(n_pairs, 700), dtype=np.int64) \
        .view(np.uint64) << np.uint64(2)
    u[:, rng.rand(700) < 0.6] = u[:, :1]
    keys = (u ^ SIGN).view(np.int64).copy()
    valid = np.ones(700, bool) if n_pairs > 1 else None
    em = check(keys, valid, TINY[0])
    assert em.stats["copies"] >= 1


def test_chunk_and_job_order_do_not_matter():
    """The scan blocks, chunks and jobs in other random orders: the same
    output."""
    rng = np.random.RandomState(5)
    keys, valid = window_keys(rng, 33, 3, 1200)
    outs = [emulate_sort(keys, valid, TINY[1], seed=s)[0] for s in range(3)]
    for o in outs[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(o, outs[0]))


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    """On a CPU tensor sort_keys runs sort_keys_plain, launches nothing,
    and its outputs are the plain version's."""
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
    assert len(calls) == 2
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
        tk.sort_keys(keys.T)
    with pytest.raises(TypeError):
        tk.sort_keys(keys, segments=[(10, 10)])
