"""Canonical k-mer extraction on the device.

Port of ``grm_tpu/ops/kmer.py``, under the same names:

1. the host encodes FASTA contigs to 2-bit codes (A=0 C=1 G=2 T=3; 4 =
   invalid, used both for non-ACGT bases and as a contig separator so that
   no window spans two contigs);
2. :func:`kmer_canon` (the CUDA kernel ``csrc/kmer.cu`` on a CUDA tensor,
   :func:`kmer_canon_plain` on a CPU one) gives, for every window start,
   the canonical words (the lexicographic minimum of the forward window and
   its reverse complement, A<C<G<T) and the window's validity;
3. :func:`sort_keys` (the stable hybrid radix sort ``csrc/sort.cu`` on a
   CUDA tensor, :func:`sort_keys_plain`'s ``torch.sort`` on a CPU one)
   orders the windows, and run flags give the distinct k-mers and their
   counts; :func:`merge_keys` (the stable multiway merge of the same
   source) orders rows that come as sorted segments, the union merge's
   batches.

k-mers are (n, n_words) words, big-endian word order, bases packed
MSB-first and the last word left-aligned, so numeric order of the unsigned
words is DNA lexicographic order for a fixed k. Words travel as int32 bit
patterns on the device and as uint32 on the host, as ``grm_tpu``'s do. k
is at most 128 (8 words).

The sort keys. The sort orders int64 as signed, so a pair of words
``(hi, lo)`` becomes the int64 ``((hi << 32) | lo) ^ 2**63``
(:func:`pair_keys`), and an invalid window gets ``KEY_INVALID``
(``2**63 - 1``). For k <= 31 a k-mer uses at most 62 bits of its pair, so
no valid k-mer reaches ``KEY_INVALID`` and one sort of one key orders
[invalid, words]; ``kmer_canon`` writes that key itself. For other k the
rows sort by [invalid, pairs...] (:func:`sort_keys`). Every sort is
stable, so rows that tie keep their input order: with the rows laid out
genome by genome, that is the genome order ``grm_tpu``'s last sort key
gives.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from . import _build

__all__ = [
    "KEY_INVALID",
    "MAX_K",
    "n_words_for_k",
    "encode_sequence",
    "encode_contigs",
    "kmer_canon",
    "kmer_canon_plain",
    "pair_keys",
    "run_flags",
    "sort_keys",
    "sort_keys_plain",
    "merge_keys",
    "merge_keys_plain",
    "window_keys",
    "unpack_keys",
    "extract_sorted_kmers",
    "sorted_kmers_np",
    "canonical_kmers_brute",
    "decode_kmers_bytes",
    "decode_kmers",
    "encode_kmer_strings",
]

MAX_K = 128
MAX_SINGLE_KEY_K = 31  # the largest k whose words fit one key below KEY_INVALID
KEY_INVALID = torch.iinfo(torch.int64).max
_SIGN = -(2**63)
_CODE = np.full(256, 4, dtype=np.int8)
for i, b in enumerate("ACGT"):
    _CODE[ord(b)] = i
    _CODE[ord(b.lower())] = i
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "grm_kmer_canon": ([_P, _I, _L, _I, _P, _P, _P, _P], _I),
}
_SORT_SIGNATURES = {
    "grm_radix_sort_scratch_words": ([_I, _L], _L),
    "grm_radix_sort_work_bytes": ([_I, _L], _L),
    "grm_radix_sort": ([_P, _I, _L, _P, _P, _P, _P, _P, _P, _P], _I),
    "grm_merge_keys_scratch_words": ([_I, _L, _I], _L),
    "grm_merge_keys": ([_P, _I, _L, _P, _P, _I, _P, _P, _P, _P, _P], _I),
}
MAX_SORT_PAIRS = 4  # csrc/sort.cu kMaxPlanes
MAX_SORT_SEGMENTS = 1024  # csrc/sort.cu kMaxSegments


def n_words_for_k(k):
    if not 1 <= k <= MAX_K:
        raise ValueError("k must be in [1, %d]" % MAX_K)
    return -(-k // 16)


def encode_sequence(seq):
    """Encode one DNA string to int8 codes (0..3, 4=invalid)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _CODE[raw]


def encode_contigs(contigs):
    """Encode a list of contig strings into one code array, joined with a
    single invalid (4) separator so that no window spans two contigs."""
    if not contigs:
        return np.zeros(0, dtype=np.int8)
    parts = []
    for i, c in enumerate(contigs):
        if i:
            parts.append(np.array([4], dtype=np.int8))
        parts.append(encode_sequence(c))
    return np.concatenate(parts)


def _check_codes(codes, k):
    if codes.dtype != torch.int8 or codes.dim() != 2:
        raise ValueError("codes must be a 2-D int8 tensor (genomes, length)")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    n_words_for_k(k)


def kmer_canon_plain(codes, k, key=False):
    """Plain PyTorch version of :func:`kmer_canon` (any device)."""
    _check_codes(codes, k)
    if key and k > MAX_SINGLE_KEY_K:
        raise ValueError("a single sort key holds k <= %d" % MAX_SINGLE_KEY_K)
    nw = n_words_for_k(k)
    g, n = codes.shape
    c = torch.cat([codes.to(torch.int64),
                   torch.full((g, k), 4, dtype=torch.int64,
                              device=codes.device)], 1)
    bad = torch.cumsum((c >= 4).to(torch.int64), 1)
    bad = torch.cat([torch.zeros((g, 1), dtype=torch.int64,
                                 device=codes.device), bad], 1)
    ok = (bad[:, k:k + n] - bad[:, :n]) == 0
    b = c & 3
    tail = torch.arange(n, device=codes.device) > n - k
    fwd, rc = [], []
    for j in range(nw):
        f = torch.zeros((g, n), dtype=torch.int64, device=codes.device)
        r = torch.zeros_like(f)
        for i in range(min(16, k - 16 * j)):
            at = 16 * j + i
            f |= b[:, at:at + n] << (30 - 2 * i)
            r |= (3 - b[:, k - 1 - at:k - 1 - at + n]) << (30 - 2 * i)
        fwd.append(f)
        rc.append(torch.where(tail, 0, r))
    use_rc = torch.zeros((g, n), dtype=torch.bool, device=codes.device)
    for f, r in zip(reversed(fwd), reversed(rc)):
        use_rc = (r < f) | ((r == f) & use_rc)
    canon = [torch.where(use_rc, r, f) for f, r in zip(fwd, rc)]
    if key:
        lo = canon[1] if nw == 2 else 0
        return torch.where(ok, (canon[0] - 2**31) * 2**32 + lo, KEY_INVALID)
    return torch.stack([w.to(torch.int32) for w in canon]), ok


def kmer_canon(codes, k, key=False):
    """Canonical words of every window of every genome row.

    codes: (G, L) int8 (0..3, 4 = invalid; rows padded with 4). For window
    ``t`` of row ``g`` (bases ``[t, t + k)``), returns (words, valid):

    - words: (nw, G, L) int32, the canonical window words (window bases past
      the row count as A, and the reverse complement of a window that runs
      past the row is zero, as ``grm_tpu``'s ``_extract_canon`` computes);
    - valid: (G, L) bool, no invalid base in the window and ``t <= L - k``;

    or, with ``key`` (k <= 31 only), the (G, L) int64 sort key of the words
    alone, ``KEY_INVALID`` for an invalid window.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version.
    """
    _check_codes(codes, k)
    if codes.device.type != "cuda":
        return kmer_canon_plain(codes, k, key)
    if key and k > MAX_SINGLE_KEY_K:
        raise ValueError("a single sort key holds k <= %d" % MAX_SINGLE_KEY_K)
    lib = _build.library("kmer", _SIGNATURES)
    nw = n_words_for_k(k)
    g, n = codes.shape
    dev = codes.device
    if key:
        outs = (torch.empty((g, n), dtype=torch.int64, device=dev),)
        ptrs = (None, None, outs[0].data_ptr())
    else:
        outs = (torch.empty((nw, g, n), dtype=torch.int32, device=dev),
                torch.empty((g, n), dtype=torch.bool, device=dev))
        ptrs = (outs[0].data_ptr(), outs[1].data_ptr(), None)
    if g and n:
        with torch.cuda.device(dev):
            _build.check(lib.grm_kmer_canon(
                codes.data_ptr(), g, n, k, *ptrs,
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)),
                "kmer_canon")
            _build.launches["kmer_canon"] += 1
    return outs[0] if key else outs


def pair_keys(words, valid):
    """(nw, n) int32 words and (n,) bool validity -> (ceil(nw / 2), n)
    int64 sort keys, most significant pair first; invalid rows get
    ``KEY_INVALID`` in every pair."""
    nw = words.shape[0]
    u = words.to(torch.int64) & 0xFFFFFFFF
    keys = []
    for p in range(0, nw, 2):
        lo = u[p + 1] if p + 1 < nw else 0
        keys.append(torch.where(valid, (u[p] - 2**31) * 2**32 + lo,
                                KEY_INVALID))
    return torch.stack(keys)


def unpack_keys(keys, nw):
    """Inverse of :func:`pair_keys` for valid rows: (n_pairs, n) int64 ->
    (nw, n) int32 words."""
    u = keys ^ _SIGN
    out = []
    for j in range(nw):
        p = u[j // 2]
        out.append((p >> 32).to(torch.int32) if j % 2 == 0
                   else p.to(torch.int32))
    return torch.stack(out)


def _check_sort(keys, valid):
    if keys.dtype != torch.int64 or keys.dim() != 2 \
            or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous (n_pairs, n) int64 tensor")
    n_pairs, n = keys.shape
    if not 1 <= n_pairs <= MAX_SORT_PAIRS:
        raise ValueError("1 to %d key planes a sort" % MAX_SORT_PAIRS)
    if n >= 2**31:
        raise ValueError("at most 2**31 - 1 rows a sort")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != (n,)
                              or valid.device != keys.device):
        raise ValueError("valid must be (n,) bool on the keys' device")


def sort_keys_plain(keys, valid=None):
    """Plain PyTorch version of :func:`sort_keys`: one stable
    ``torch.sort`` per pair, least significant first, plus one by validity
    where ``valid`` is given."""
    _check_sort(keys, valid)
    if keys.shape[0] == 1 and valid is None:
        s, perm = torch.sort(keys[0], stable=True)
        return s[None], perm, None
    perm = torch.arange(keys.shape[1], device=keys.device)
    for p in reversed(range(keys.shape[0])):
        _, idx = torch.sort(keys[p][perm], stable=True)
        perm = perm[idx]
    if valid is not None:
        _, idx = torch.sort((~valid[perm]).to(torch.uint8), stable=True)
        perm = perm[idx]
    return keys[:, perm], perm, None if valid is None else valid[perm]


def sort_keys(keys, valid=None):
    """Stable sort of rows by [invalid, key pairs...].

    keys: (n_pairs, n) int64 from :func:`pair_keys` or ``kmer_canon``'s
    single key; ``valid``: (n,) bool, or None where ``KEY_INVALID`` can only
    mean an invalid row (a single key, k <= 31). Returns (sorted keys, the
    permutation (n,) int64, sorted validity or None).

    A CUDA tensor launches the stable hybrid radix sort of ``csrc/sort.cu``
    (two MSD scatters, then each bucket sorted in shared memory); a CPU
    tensor takes :func:`sort_keys_plain`.
    """
    _check_sort(keys, valid)
    if keys.device.type != "cuda":
        return sort_keys_plain(keys, valid)
    lib = _build.library("sort", _SORT_SIGNATURES)
    n_pairs, n = keys.shape
    dev = keys.device
    out = torch.empty_like(keys)
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    out_valid = None if valid is None else torch.empty(
        n, dtype=torch.bool, device=dev)
    if n == 0:
        return out, perm, out_valid
    # The plan and the levels' counters need zeroing; the work buffers do
    # not.
    scratch = torch.zeros(lib.grm_radix_sort_scratch_words(n_pairs, n),
                          dtype=torch.int64, device=dev)
    work = torch.empty(lib.grm_radix_sort_work_bytes(n_pairs, n),
                       dtype=torch.uint8, device=dev)
    valid = None if valid is None else valid.contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        _build.check(lib.grm_radix_sort(
            keys.data_ptr(), n_pairs, n, ptr(valid), out.data_ptr(),
            perm.data_ptr(), ptr(out_valid), work.data_ptr(),
            scratch.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)),
            "radix_sort")
        _build.launches["radix_sort"] += 1
    return out, perm, out_valid


def _check_merge(keys, segments):
    _check_sort(keys, None)
    if not 1 <= len(segments) <= MAX_SORT_SEGMENTS:
        raise ValueError("1 to %d segments a merge" % MAX_SORT_SEGMENTS)
    if any(int(rows) < 0 for rows, _ in segments) \
            or sum(int(rows) for rows, _ in segments) != keys.shape[1]:
        raise ValueError("the segments' rows must add up to the keys' rows")
    for _, count in segments:
        if isinstance(count, torch.Tensor) and (
                count.numel() != 1 or count.device != keys.device
                or count.dtype not in (torch.int32, torch.int64)):
            raise ValueError("a segment's valid count must be an int or a "
                             "(1,) integer tensor on the keys' device")


def _segment_valid(keys, segments):
    """(n,) bool: row i of segment s is valid where i < its count."""
    parts = []
    for rows, count in segments:
        count = int(count) if not isinstance(count, torch.Tensor) \
            else count.reshape(())
        parts.append(torch.arange(int(rows), device=keys.device) < count)
    return torch.cat(parts)


def merge_keys_plain(keys, segments):
    """Plain PyTorch version of :func:`merge_keys`:
    :func:`sort_keys_plain` of the concatenation, the validity from the
    segments' counts. Raises where a segment's valid rows are not sorted
    or a row past them is not ``KEY_INVALID`` in every pair."""
    _check_merge(keys, segments)
    valid = _segment_valid(keys, segments)
    if bool((keys[:, ~valid] != KEY_INVALID).any()):
        raise ValueError("a row past its segment's count is not KEY_INVALID")
    row0 = 0
    for rows, count in segments:
        v = max(min(int(count), int(rows)), 1)
        a, b = keys[:, row0:row0 + v - 1], keys[:, row0 + 1:row0 + v]
        le = torch.ones(a.shape[1], dtype=torch.bool, device=keys.device)
        for p in reversed(range(keys.shape[0])):  # lexicographic a <= b
            le = (a[p] < b[p]) | ((a[p] == b[p]) & le)
        if not bool(le.all()):
            raise ValueError("a segment's valid rows are not sorted")
        row0 += int(rows)
    return sort_keys_plain(keys, valid)


def merge_keys(keys, segments):
    """Stable sort of rows that come as sorted segments: the union merge.

    keys: (n_pairs, n) int64 (:func:`pair_keys`); ``segments``: the rows as
    consecutive segments, ``[(rows, valid count), ...]``, the count an int
    or a (1,) integer tensor on the keys' device (no fetch), where the
    first ``min(count, rows)`` rows of each segment are valid and sorted
    and the rest invalid (``KEY_INVALID`` in every pair). Returns what a
    stable sort by [invalid, key pairs...] of the concatenation returns:
    (sorted keys, the permutation (n,) int64, sorted validity (n,) bool):
    the valid rows merged, ties in segment order, then every invalid row
    in input order.

    A CUDA tensor launches the stable multiway merge of ``csrc/sort.cu``
    (each valid row read once, every row written once; the inputs are not
    checked); a CPU tensor takes :func:`merge_keys_plain`.
    """
    _check_merge(keys, segments)
    if keys.device.type != "cuda":
        return merge_keys_plain(keys, segments)
    lib = _build.library("sort", _SORT_SIGNATURES)
    n_pairs, n = keys.shape
    dev = keys.device
    out = torch.empty_like(keys)
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    out_valid = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out, perm, out_valid
    rows = np.cumsum([0] + [int(r) for r, _ in segments])
    seg_start = torch.from_numpy(rows.astype(np.int64)).pin_memory().to(
        dev, non_blocking=True)
    seg_count = torch.cat([
        c.reshape(1).to(torch.int32) if isinstance(c, torch.Tensor)
        else torch.tensor([int(c)], dtype=torch.int32, device=dev)
        for _, c in segments])
    scratch = torch.empty(
        lib.grm_merge_keys_scratch_words(n_pairs, n, len(segments)),
        dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _build.check(lib.grm_merge_keys(
            keys.data_ptr(), n_pairs, n, seg_start.data_ptr(),
            seg_count.data_ptr(), len(segments), out.data_ptr(),
            perm.data_ptr(), out_valid.data_ptr(), scratch.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)),
            "merge_keys")
        _build.launches["merge_keys"] += 1
    return out, perm, out_valid


def run_flags(keys, valid=None):
    """(valid, first row of its k-mer) flags of sorted rows, from
    :func:`sort_keys`'s outputs."""
    if valid is None:
        valid = keys[0] != KEY_INVALID
    new = torch.ones(keys.shape[1], dtype=torch.bool, device=keys.device)
    new[1:] = (keys[:, 1:] != keys[:, :-1]).any(0)
    return valid, new


def window_keys(codes, k):
    """Sort keys of every window of (G, L) int8 codes: (n_pairs, G * L)
    int64 and, for k past one key, the (G * L,) validity the sort needs."""
    if k <= MAX_SINGLE_KEY_K:
        return kmer_canon(codes, k, key=True).view(1, -1), None
    words, valid = kmer_canon(codes, k)
    valid = valid.view(-1)
    return pair_keys(words.view(words.shape[0], -1), valid), valid


def extract_sorted_kmers(codes, k, device=None):
    """Sorted canonical windows of one code array: (words: nw (n,) int32
    tensors, invalid (n,) int32, first (n,) bool), valid rows first, in
    order, ``first`` marking the first row of each distinct k-mer."""
    dev = resolve_device(device)
    nw = n_words_for_k(k)
    codes = np.asarray(codes, dtype=np.int8)
    if codes.shape[0] < k:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return [z] * nw, z, torch.zeros(0, dtype=torch.bool, device=dev)
    keys, valid = window_keys(torch.from_numpy(codes[None]).to(dev), k)
    keys, _, valid = sort_keys(keys, valid)
    valid, new = run_flags(keys, valid)
    words = unpack_keys(keys, nw)
    return list(words), (~valid).to(torch.int32), new & valid


def sorted_kmers_np(codes, k, return_counts=False, device=None):
    """Sorted distinct canonical k-mers as a (n, nw) uint32 numpy array.

    With ``return_counts=True`` also returns per-k-mer occurrence counts
    (int64).
    """
    words, inv, first = extract_sorted_kmers(codes, k, device=device)
    first = first.cpu().numpy()
    kmers = np.stack([w.cpu().numpy().view(np.uint32)[first] for w in words],
                     axis=1) if len(first) else \
        np.zeros((0, n_words_for_k(k)), np.uint32)
    if not return_counts:
        return kmers
    n_valid = int((inv == 0).sum())
    starts = np.flatnonzero(first)
    return kmers, np.diff(np.append(starts, n_valid)).astype(np.int64)


def decode_kmers_bytes(kmers, k):
    """(n, nw) packed uint32 -> (n,) numpy bytes array of dtype S{k}."""
    kmers = np.asarray(kmers, dtype=np.uint32)
    n = kmers.shape[0]
    if n == 0:
        return np.zeros(0, dtype="S%d" % k)
    ascii_map = np.frombuffer(b"ACGT", dtype=np.uint8)
    chars = np.empty((n, k), dtype=np.uint8)
    for j in range(k):
        code = (kmers[:, j // 16] >> np.uint32(30 - 2 * (j % 16))) \
            & np.uint32(3)
        chars[:, j] = ascii_map[code]
    return chars.reshape(-1).view("S%d" % k)


def decode_kmers(kmers, k):
    """(n, nw) packed uint32 -> list of DNA strings."""
    return [s.decode() for s in decode_kmers_bytes(kmers, k)]


def encode_kmer_strings(kmer_strings, k):
    """List of DNA strings -> (n, nw) packed uint32."""
    nw = n_words_for_k(k)
    out = np.zeros((len(kmer_strings), nw), dtype=np.uint32)
    for i, s in enumerate(kmer_strings):
        if len(s) != k:
            raise ValueError("k-mer %r does not have length %d" % (s, k))
        codes = encode_sequence(s)
        if (codes >= 4).any():
            raise ValueError("k-mer %r is not a valid DNA sequence" % s)
        for j, c in enumerate(codes):
            out[i, j // 16] |= np.uint32(int(c)) << np.uint32(30 - 2 * (j % 16))
    return out


def canonical_kmers_brute(seqs, k):
    """Brute-force host oracle: sorted distinct canonical k-mers as strings."""
    comp = str.maketrans("ACGT", "TGCA")
    found = set()
    for s in seqs:
        s = s.upper()
        for i in range(len(s) - k + 1):
            km = s[i:i + k]
            if set(km) - set("ACGT"):
                continue
            found.add(min(km, km.translate(comp)[::-1]))
    return sorted(found)
