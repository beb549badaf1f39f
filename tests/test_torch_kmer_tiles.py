"""What Python holds of the rolling ``kmer_canon`` kernel
(``grm_tpu_torch/csrc/kmer.cu``). The kernel runs only on a GPU
(``tests/test_torch_cuda.py``); here a numpy emulation of its
decomposition is held exactly against ``kmer_canon_plain`` and against
``grm_tpu``'s ``_extract_canon``:

- tiles of ``THREADS * R`` windows of one row, a run of ``R`` windows a
  thread;
- the codes staged as 4-byte words from 4 bases before the tile (a padding
  slot after every ``R / 4`` words), 4s past the row;
- a run's warm-up on the bases before its first window, rounded down to
  whole words, every word read through one funnel shift;
- the rolling forward and reverse-complement words (shift in one base,
  funnel across words, the last word masked to its top 2r bits), the
  run-length validity, the canonical choice, the key of the words, the
  reverse complement zeroed past ``L - k``;
- the outputs staged by run at a rotated slot and read back by window.

Also: the shared-memory slots of every warp-wide access of the kernel fall
on distinct banks, and each tile fits 48 KB of static shared memory.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from grm_tpu.ops import kmer as jk
from grm_tpu_torch.ops import kmer as tk

SOURCE = Path(tk.__file__).resolve().parent.parent / "csrc" / "kmer.cu"
THREADS = 128  # csrc/kmer.cu kThreads
MAX_K = 128
M32 = np.uint64(0xFFFFFFFF)
SIGN = np.uint64(1 << 63)
KEY_INVALID = np.uint64((1 << 63) - 1)
KEY_KS = [1, 15, 16, 17, 30, 31]
WORD_KS = [1, 16, 17, 31, 32, 33, 64, 128]
CASES = ["shorter", "equal", "ragged", "ragged-one-row"]


def run_length(nw):
    """csrc/kmer.cu run_length."""
    return 32 if nw <= 2 else (16 if nw <= 4 else 8)


def tile(nw, key):
    """(R, T, PW, code slots, shared bytes) of csrc/kmer.cu's Tile."""
    r = run_length(nw)
    t = THREADS * r
    pw = r // 4
    code_words = (t + MAX_K + 3) // 4 + 1
    slots = code_words + code_words // pw + 1
    out = 8 * t if key else (4 * nw + 1) * t
    return r, t, pw, slots, 4 * slots + out


def code_slot(w, pw):
    return w + w // pw


def out_slot(i, q, r):
    return i * r + ((q + (i * r) // 32) & (r - 1))


def _u(x):
    return np.asarray(x, np.uint64)


def emulate(codes, k, key):
    """The kernel's outputs for (G, L) int8 ``codes``: the (G, L) int64 key,
    or ((nw, G, L) int32 words, (G, L) bool validity)."""
    g, n = codes.shape
    nw = tk.n_words_for_k(k)
    r_len, t_len, pw, n_slots, _ = tile(nw, key)
    n_tiles = -(-n // t_len)
    t0 = np.arange(n_tiles, dtype=np.int64) * t_len

    # 1. Stage: logical word w holds bytes [t0 - 4 + 4w, t0 + 4w).
    n_words = (t_len + k + 3) // 4 + 1
    pos = t0[:, None] - 4 + np.arange(4 * n_words)[None]
    byte = np.where(((pos >= 0) & (pos < n))[None],
                    codes.view(np.uint8)[:, np.clip(pos, 0, n - 1)], 4)
    byte = _u(byte).reshape(g, n_tiles, n_words, 4)
    words = np.bitwise_or.reduce(byte << _u(8 * np.arange(4)), axis=-1)
    image = np.zeros((g, n_tiles, n_slots), np.uint64)
    image[..., code_slot(np.arange(n_words), pw)] = words

    # 2. Roll: one lane per (row, tile, thread).
    i = np.arange(THREADS)
    base = i * r_len
    r_last = k - 16 * (nw - 1)
    ins = _u(32 - 2 * r_last)
    last_mask = _u((0xFFFFFFFF << (32 - 2 * r_last)) & 0xFFFFFFFF)
    wu = (k + 2) // 4
    first = 4 + base + k - 1 - 4 * wu
    sh = _u(8 * (first[0] & 3))  # the same for every thread
    assert (8 * (first & 3) == sh).all()
    word_at = first >> 2
    f = [np.zeros((g, n_tiles, THREADS), np.uint64) for _ in range(nw)]
    r = [np.zeros_like(f[0]) for _ in range(nw)]
    run = np.zeros((g, n_tiles, THREADS), np.int64)
    tail_from = n - k + 1 - t0[:, None] - base[None]  # (tiles, threads)
    if key:
        out = np.zeros((g, n_tiles, t_len), np.uint64)
    else:
        out_words = np.zeros((nw, g, n_tiles, t_len), np.uint64)
        out_valid = np.zeros((g, n_tiles, t_len), bool)

    lo = image[..., code_slot(word_at, pw)]
    for step in range(wu + r_len // 4):
        hi = image[..., code_slot(word_at + step + 1, pw)]
        w = ((hi << _u(32)) | lo) >> sh & M32  # __funnelshift_r(lo, hi, sh)
        lo = hi
        for b in range(4):
            c = (w >> _u(8 * b) & _u(0xFF)).astype(np.uint8).view(np.int8)
            run = np.where(c >= 4, 0, run + 1)
            base_bits = _u(c.astype(np.int64) & 3)
            for j in range(nw - 1):  # __funnelshift_l(f[j + 1], f[j], 2)
                f[j] = (f[j] << _u(2) | f[j + 1] >> _u(30)) & M32
            f[nw - 1] = (f[nw - 1] << _u(2) | base_bits << ins) & M32
            for j in range(nw - 1, 0, -1):  # __funnelshift_r(r[j], r[j-1], 2)
                r[j] = (r[j] >> _u(2) | r[j - 1] << _u(30)) & M32
            r[0] = (r[0] >> _u(2) | (_u(3) - base_bits) << _u(30)) & M32
            r[nw - 1] = r[nw - 1] & last_mask
            if step < wu:
                continue
            q = 4 * (step - wu) + b
            slot = out_slot(i, q, r_len)
            ok = run >= k
            if key:
                fw = f[0] << _u(32) | (f[1] if nw > 1 else _u(0))
                rw = r[0] << _u(32) | (r[1] if nw > 1 else _u(0))
                canon = np.minimum(fw, rw)
                out[..., slot] = np.where(ok, canon ^ SIGN, KEY_INVALID)
            else:
                tail = (q >= tail_from)[None]
                rr = [np.where(tail, _u(0), rj) for rj in r]
                use_rc = np.zeros(ok.shape, bool)
                for j in reversed(range(nw)):
                    use_rc = (rr[j] < f[j]) | ((rr[j] == f[j]) & use_rc)
                for j in range(nw):
                    out_words[j][..., slot] = np.where(use_rc, rr[j], f[j])
                out_valid[..., slot] = ok

    # 3. Read the tiles back by window.
    win = np.arange(t_len)
    back = out_slot(win // r_len, win % r_len, r_len)
    if key:
        return out[..., back].reshape(g, -1)[:, :n].view(np.int64)
    got = out_words[..., back].reshape(nw, g, -1)[..., :n]
    return (got.astype(np.uint32).view(np.int32),
            out_valid[..., back].reshape(g, -1)[:, :n])


def _case(name, k, nw, seed):
    """(G, L) int8 codes of one edge case: a row shorter than k, 33 rows of
    exactly k, and rows of a length that ends mid-run and mid-tile with 4s
    planted at a run's first base, its last window, its last base, inside
    its warm-up and at a tile boundary, and a few codes past 4 and below 0:
    33 such rows, one of them all 4s, or one row whose second tile is all
    4s."""
    rng = np.random.RandomState(seed)
    r_len, t_len = tile(nw, False)[:2]
    g, n = {"shorter": (1, max(k - 1, 1)), "equal": (33, k),
            "ragged": (33, t_len + 5 * r_len + r_len // 2 + 3),
            "ragged-one-row": (1, t_len + 5 * r_len + r_len // 2 + 3)}[name]
    codes = rng.choice(5, (g, n), p=[0.24] * 4 + [0.04]).astype(np.int8)
    if name.startswith("ragged"):
        for at in (3 * r_len, 5 * r_len + r_len - 1,
                   9 * r_len + r_len + k - 2, 7 * r_len + (k - 1) // 2,
                   t_len - 1, t_len, n - 1):
            codes[0, min(at, n - 1)] = 4
        codes[-1, 11 * r_len + (k - 1) // 2] = 4
        codes[g // 2, 2 * r_len:2 * r_len + 3] = [5, -1, 100]  # odd codes
        if g > 1:
            codes[1] = 4
        else:
            codes[0, t_len:] = 4
    return codes


def _jax_words(codes, k):
    """grm_tpu's _extract_canon row by row: ((nw, G, L) int32, (G, L))."""
    rows = [jk._extract_canon(row, k) for row in codes]
    words = np.stack([np.stack([np.asarray(w) for w in ws])
                      for ws, _ in rows], 1)
    return words.view(np.int32), np.stack([np.asarray(v) for _, v in rows])


def _pair_key(words, valid):
    u = words.astype(np.int64) & 0xFFFFFFFF
    lo = u[1] if words.shape[0] > 1 else 0
    return np.where(valid, ((u[0] << 32) | lo) ^ np.int64(-2**63),
                    np.int64(2**63 - 1))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", KEY_KS)
def test_emulated_key_entry_is_exact(k, case):
    codes = _case(case, k, tk.n_words_for_k(k), 10 * k + CASES.index(case))
    got = emulate(codes, k, key=True)
    want = tk.kmer_canon_plain(torch.from_numpy(codes), k, key=True).numpy()
    np.testing.assert_array_equal(got, want)
    if codes.shape[1] >= 16:  # _extract_canon needs 16 codes
        np.testing.assert_array_equal(got, _pair_key(*_jax_words(codes, k)))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", WORD_KS)
def test_emulated_words_entry_is_exact(k, case):
    """Every window's words, those of invalid windows included."""
    codes = _case(case, k, tk.n_words_for_k(k), 20 * k + CASES.index(case))
    words, valid = emulate(codes, k, key=False)
    want_words, want_valid = tk.kmer_canon_plain(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(words, want_words.numpy())
    np.testing.assert_array_equal(valid, want_valid.numpy())
    if codes.shape[1] >= 16:
        jax_words, jax_valid = _jax_words(codes, k)
        np.testing.assert_array_equal(words, jax_words)
        np.testing.assert_array_equal(valid, jax_valid)


def _banks_distinct(byte_addrs, width):
    """Whether one warp-wide shared access of ``width``-byte elements at
    ``byte_addrs`` (one per lane) needs one wavefront per 128 bytes: no two
    lanes of a wavefront reach different 4-byte words of one bank."""
    lanes_per_wave = {1: 32, 4: 32, 8: 16}[width]
    addrs = np.asarray(byte_addrs)
    for lo in range(0, len(addrs), lanes_per_wave):
        words = {}
        for a in addrs[lo:lo + lanes_per_wave]:
            for word in range(a // 4, (a + width - 1) // 4 + 1):
                words.setdefault(word % 32, set()).add(word)
        if any(len(s) > 1 for s in words.values()):
            return False
    return True


@pytest.mark.parametrize("nw,key", [(1, True), (2, True)]
                         + [(nw, False) for nw in range(1, 9)])
def test_shared_memory_layout(nw, key):
    """Every tile fits 48 KB of static shared memory; the output slots are
    a bijection of the tile; and each warp-wide access of the roll (code
    reads at every k, output stores at every window of a run) and of the
    write-out reaches distinct banks."""
    r_len, t_len, pw, _, shared = tile(nw, key)
    assert shared <= 48 * 1024
    i = np.arange(THREADS)
    slots = np.concatenate([out_slot(i, q, r_len) for q in range(r_len)])
    assert np.array_equal(np.sort(slots), np.arange(t_len))
    ks = [k for k in range(16 * nw - 15, 16 * nw + 1) if not key or k <= 31]
    for warp in range(THREADS // 32):
        lanes = i[32 * warp:32 * warp + 32]
        for k in ks:
            first = 4 + lanes * r_len + k - 1 - 4 * ((k + 2) // 4)
            for step in range((k + 2) // 4 + r_len // 4 + 1):
                at = 4 * code_slot((first >> 2) + step, pw)
                assert _banks_distinct(at, 4), (k, step)
        for q in range(r_len):
            slot = out_slot(lanes, q, r_len)
            if key:
                assert _banks_distinct(8 * slot, 8), q
            else:
                assert _banks_distinct(4 * slot, 4), q
                assert _banks_distinct(4 * nw * t_len + slot, 1), q
        for m in range(r_len):  # the write-out: window w = thread + m THREADS
            w = lanes + m * THREADS
            slot = out_slot(w // r_len, w % r_len, r_len)
            assert _banks_distinct(8 * slot if key else 4 * slot,
                                   8 if key else 4), m


def test_emulation_mirrors_the_source():
    """The constants above are csrc/kmer.cu's."""
    src = SOURCE.read_text()
    assert re.search(r"constexpr int kThreads = %d;" % THREADS, src)
    assert re.search(r"constexpr int kMaxK = %d;" % MAX_K, src)
    assert "return nw <= 2 ? 32 : (nw <= 4 ? 16 : 8);" in src
    assert "return i * R + ((q + (i * R) / 32) & (R - 1));" in src
    assert "return w + w / PW;" in src
