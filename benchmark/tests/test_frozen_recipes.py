"""The frozen recipes equal chip_smoke's at small sizes."""

import numpy as np
import pytest

import chip_smoke
from harness import recipes


@pytest.mark.parametrize("n,k,seed,classes", [
    (70, 5000, 3, 2), (342, 3001, 0, 2), (65, 1000, 2**31 + 5, 2),
    (90, 2000, 5, 3), (64, 517, 7, 2)])
def test_synthetic_arrays_equal_chip_smoke(n, k, seed, classes):
    want, want_attrs = chip_smoke.synthetic_arrays(n, k, seed, classes)
    got, got_attrs = recipes.synthetic_arrays(n, k, seed, classes)
    assert set(got) == set(want) and got_attrs == want_attrs
    for name in want:
        assert np.array_equal(got[name], want[name]), name


@pytest.mark.parametrize("start,count,k", [
    (0, 5000, 31), (16_000_000, 100, 31), (2**40, 50, 31), (7, 300, 9),
    (5, 100, 1), (2**60, 20, 31), (3, 10, 40)])
def test_kmer_sequence_block_equals_chip_smoke(start, count, k):
    assert np.array_equal(recipes.kmer_sequence_block(start, count, k),
                          chip_smoke._kmer_sequence_block(start, count, k))


@pytest.mark.parametrize("args", [(70, 20000, 90, 520, 0),
                                  (40, 5000, 30, 200, 2**31 + 1)])
def test_ingest_genomes_equal_chip_smoke(args):
    codes, labels, markers = recipes.ingest_genomes(*args)
    w_codes, w_labels, w_markers = chip_smoke.ingest_genomes(*args)
    assert len(codes) == len(w_codes)
    assert all(np.array_equal(a, b) for a, b in zip(codes, w_codes))
    assert np.array_equal(labels, w_labels) and markers == w_markers


def test_pack_u64_is_msb_first():
    col = np.zeros(130, np.uint8)
    col[[0, 63, 64, 129]] = 1
    got = recipes.pack_u64(col)
    assert got.tolist() == [(1 << 63) | 1, 1 << 63, 1 << 62]


def test_card_noise_is_seeded_dense_and_padded():
    a = recipes.card_noise(100, 4000, 2**31 + 9, "cpu")
    b = recipes.card_noise(100, 4000, 2**31 + 9, "cpu")
    c = recipes.card_noise(100, 4000, 2**31 + 10, "cpu")
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    bits = np.unpackbits(a.astype(">u8").view(np.uint8)).reshape(2, 4000,
                                                                  64)
    assert not bits[1, :, 36:].any()  # genomes 100..127 are padding
    assert abs(bits[0].mean() - 0.75) < 0.01
    arrays, _ = recipes.synthetic_arrays(100, 4000, 9, words=a.copy())
    assert arrays["kmer_matrix"].shape == (2, 4000)
