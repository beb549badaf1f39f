"""The port's k-mer extraction (grm_tpu_torch.ops.kmer) against
grm_tpu.ops.kmer on the CPU: every comparison is exact.

On the CPU ``kmer_canon`` runs its plain PyTorch version; the CUDA kernel
is held to that version on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from grm_tpu.ops import kmer as jk
from grm_tpu_torch.ops import kmer as tk

KS = [9, 16, 17, 31, 32, 33]
LENGTH = 300  # one padded shape for grm_tpu's _extract_canon compiles


def _codes(rng, n, invalid=0.04):
    return rng.choice(5, n, p=[(1 - invalid) / 4] * 4 + [invalid]) \
        .astype(np.int8)


def _seqs(rng, n, lo, hi, alphabet="ACGT"):
    return ["".join(rng.choice(list(alphabet), rng.randint(lo, hi)))
            for _ in range(n)]


@pytest.mark.parametrize("k", KS)
def test_extract_canon_words_and_validity(rng, k):
    codes = _codes(rng, LENGTH)
    codes[100:140] = 4  # a run of invalid bases
    words, valid = jk._extract_canon(codes, k)
    got_words, got_valid = tk.kmer_canon(torch.from_numpy(codes[None]), k)
    assert got_words.shape == (len(words), 1, LENGTH)
    for j, w in enumerate(words):  # every window, invalid ones included
        np.testing.assert_array_equal(got_words[j, 0].numpy(),
                                      np.asarray(w).view(np.int32))
    np.testing.assert_array_equal(got_valid[0].numpy(), np.asarray(valid))


@pytest.mark.parametrize("k", [9, 16, 31])
def test_single_sort_key_orders_like_the_words(rng, k):
    codes = torch.from_numpy(_codes(rng, 500)[None])
    words, valid = tk.kmer_canon(codes, k)
    key = tk.kmer_canon(codes, k, key=True)
    want = tk.pair_keys(words.view(words.shape[0], -1), valid.view(-1))
    torch.testing.assert_close(key.view(1, -1), want, rtol=0, atol=0)
    assert bool((key[valid] < tk.KEY_INVALID).all())
    assert bool((key[~valid] == tk.KEY_INVALID).all())
    np.testing.assert_array_equal(
        tk.unpack_keys(want, words.shape[0])[:, valid.view(-1)].numpy(),
        words.view(words.shape[0], -1)[:, valid.view(-1)].numpy())
    with pytest.raises(ValueError):
        tk.kmer_canon(codes, 32, key=True)


@pytest.mark.parametrize("k", KS + [1, 64, 128])
@pytest.mark.parametrize("counts", [False, True])
def test_sorted_kmers_np(rng, k, counts):
    codes = _codes(rng, 2000)
    want = jk.sorted_kmers_np(codes, k, return_counts=counts)
    got = tk.sorted_kmers_np(codes, k, return_counts=counts, device="cpu")
    if counts:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].dtype == np.uint32 and got[1].dtype == np.int64
    else:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.uint32


@pytest.mark.parametrize("k", [5, 15, 31, 33])
def test_sorted_kmers_vs_brute(rng, k):
    seqs = _seqs(rng, 4, 30, 200, "ACGTN")
    want = jk.canonical_kmers_brute(seqs, k)
    assert tk.canonical_kmers_brute(seqs, k) == want
    got = tk.decode_kmers(tk.sorted_kmers_np(tk.encode_contigs(seqs), k,
                                             device="cpu"), k)
    assert got == want


def test_short_and_invalid_codes():
    for k, codes in ((31, np.zeros(30, np.int8)),
                     (31, np.full(500, 4, np.int8)),
                     (9, np.zeros(0, np.int8)),
                     (5, np.array([0, 1, 4, 2, 3, 4, 0, 1, 2, 3], np.int8))):
        for counts in (False, True):
            want = jk.sorted_kmers_np(codes, k, return_counts=counts)
            got = tk.sorted_kmers_np(codes, k, return_counts=counts,
                                     device="cpu")
            for a, b in zip(got if counts else (got,),
                            want if counts else (want,)):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype and a.shape == b.shape


def test_encode_contigs_and_sequences(rng):
    seqs = _seqs(rng, 3, 1, 50, "ACGTNacgtRY")
    np.testing.assert_array_equal(tk.encode_contigs(seqs),
                                  jk.encode_contigs(seqs))
    np.testing.assert_array_equal(tk.encode_sequence("ACGTNacgt-"),
                                  jk.encode_sequence("ACGTNacgt-"))
    assert tk.encode_contigs([]).shape == (0,)
    assert tk.MAX_K == jk.MAX_K
    assert [tk.n_words_for_k(k) for k in (1, 16, 17, 128)] == [1, 1, 2, 8]
    with pytest.raises(ValueError):
        tk.n_words_for_k(129)


@pytest.mark.parametrize("k", [7, 16, 31, 33, 128])
def test_decode_encode_round_trip(rng, k):
    strings = ["".join(rng.choice(list("ACGT"), k)) for _ in range(20)]
    packed = tk.encode_kmer_strings(strings, k)
    np.testing.assert_array_equal(packed, jk.encode_kmer_strings(strings, k))
    assert tk.decode_kmers(packed, k) == strings
    np.testing.assert_array_equal(tk.decode_kmers_bytes(packed, k),
                                  jk.decode_kmers_bytes(packed, k))
    with pytest.raises(ValueError):
        tk.encode_kmer_strings(["A" * (k + 1)], k)
    with pytest.raises(ValueError):
        tk.encode_kmer_strings(["N" * k], k)


def test_extract_sorted_kmers_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tk.extract_sorted_kmers(np.zeros(40, np.int8), 9)
