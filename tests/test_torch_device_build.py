"""The port's device ingest (grm_tpu_torch.parallel.device_build) against
grm_tpu.parallel.device_build on the CPU: matrix bits, union and counts
are equal exactly, for both builders, with and without the singleton
filter.

On the CPU the column steps run their plain PyTorch versions; the CUDA
kernels are held to those versions on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from grm_tpu.parallel import device_build as jdb
from grm_tpu_torch.ops import device_build as db
from grm_tpu_torch.ops import kmer as tk
from grm_tpu_torch.parallel import device_build as tdb

def _genomes(rng, n, length=300, snps=6):
    """Contig sets of n genomes: mutated copies of one backbone (shared
    k-mers, so that the singleton filter keeps some), two contigs each."""
    backbone = rng.choice(list("ACGT"), length)
    out = []
    for _ in range(n):
        s = backbone.copy()
        s[rng.randint(0, length, snps)] = rng.choice(list("ACGT"), snps)
        s = "".join(s)
        cut = rng.randint(1, length - 1)
        out.append([s[:cut], s[cut:] + "N" + s[:20]])
    return out


def _codes(contig_sets):
    return [tk.encode_contigs(c) for c in contig_sets]


def _same(got, want):
    assert got.n_kmers == want.n_kmers
    assert got.k == want.k and got.genome_ids == want.genome_ids
    np.testing.assert_array_equal(got.union_kmers_host(),
                                  want.union_kmers_host())
    np.testing.assert_array_equal(got.matrix.numpy(),
                                  np.asarray(want.matrix).view(np.int32))
    np.testing.assert_array_equal(got.union_words.numpy(),
                                  np.asarray(want.union_words).view(np.int32))


@pytest.mark.parametrize("k,filter_singleton", [(9, False), (17, False),
                                                (33, False), (11, True),
                                                (31, True)])
def test_build_matrix_device(rng, k, filter_singleton):
    codes = _codes(_genomes(rng, 6))
    ids = ["a%d" % i for i in range(6)]
    _same(tdb.build_matrix_device(codes, k, genome_ids=ids,
                                  filter_singleton=filter_singleton,
                                  device="cpu"),
          jdb.build_matrix_device(codes, k, genome_ids=ids,
                                  filter_singleton=filter_singleton))


@pytest.mark.parametrize("k,filter_singleton", [(9, False), (17, True),
                                                (33, True)])
def test_build_matrix_device_batched(rng, k, filter_singleton):
    """40 genomes in batches of 32: two batches, a ragged tail, and one
    union merge."""
    codes = _codes(_genomes(rng, 40, length=150, snps=3))
    kw = dict(genome_batch=32, batch_budget=3000,
              filter_singleton=filter_singleton)
    got = tdb.build_matrix_device_batched(codes, k, device="cpu", **kw)
    _same(got, jdb.build_matrix_device_batched(codes, k, **kw))
    assert got.matrix.shape[0] == 2


@pytest.mark.parametrize("k", [16, 32])
def test_all_t_kmer_against_the_invalid_sentinel(rng, k):
    poly_t = "T" * (k + 3)
    contig_sets = [
        [poly_t + "N" + "".join(rng.choice(list("ACGT"), 60))],
        ["".join(rng.choice(list("ACGT"), 60)) + "NN" + poly_t],
        ["N" * (k + 2), "".join(rng.choice(list("ACGT"), 60))],
    ]
    codes = _codes(contig_sets)
    _same(tdb.build_matrix_device(codes, k, device="cpu"),
          jdb.build_matrix_device(codes, k))
    _same(tdb.build_matrix_device_batched(codes, k, device="cpu"),
          jdb.build_matrix_device_batched(codes, k))


@pytest.mark.parametrize("k", [9, 31, 33])
def test_builders_against_the_per_genome_oracle(rng, k):
    """Both builders against the port's own oracle: each genome's
    sorted_kmers_np, merged with numpy."""
    codes = _codes(_genomes(rng, 35, length=200, snps=4))
    per = [tk.sorted_kmers_np(c, k, device="cpu") for c in codes]
    sets = [{tuple(r) for r in p} for p in per]
    union = np.unique(np.concatenate(per), axis=0)
    in_genomes = np.array([sum(tuple(u) in s for s in sets) for u in union])
    for fs in (False, True):
        for dm in (tdb.build_matrix_device(codes, k, filter_singleton=fs,
                                           device="cpu"),
                   tdb.build_matrix_device_batched(codes, k,
                                                   filter_singleton=fs,
                                                   device="cpu")):
            got = dm.union_kmers_host()
            presence = np.array([[tuple(u) in s for u in got] for s in sets])
            want = union[in_genomes >= 2] if fs else union
            np.testing.assert_array_equal(got, want)
            bits = tdb.DeviceMatrix(dm.matrix, dm.union_words, dm.n_kmers, k,
                                    dm.genome_ids).bit_matrix()
            np.testing.assert_array_equal(
                bits.get_columns_dense(np.arange(dm.n_kmers)),
                presence.astype(np.uint8))


def test_bit_matrix_wraps_the_device_matrix(rng):
    codes = _codes(_genomes(rng, 5))
    dm = tdb.build_matrix_device(codes, 13, device="cpu")
    bm = dm.bit_matrix()
    assert bm.data.data_ptr() == dm.matrix.data_ptr()  # no copy
    assert bm.n_columns == dm.n_kmers < dm.matrix.shape[1]
    assert bm.shape == (5, 2 * dm.n_kmers)
    want = jdb.build_matrix_device(codes, 13).bit_matrix()
    for rows in ([0, 2, 4], [1], []):
        np.testing.assert_array_equal(bm.sum_rows(rows), want.sum_rows(rows))


def test_errors_match(rng):
    codes = _codes(_genomes(rng, 3))
    for build in ("build_matrix_device", "build_matrix_device_batched"):
        for args, kw in (((codes, 9), {"k_budget": 10}),
                         (([], 9), {})):
            with pytest.raises(ValueError) as want:
                getattr(jdb, build)(*args, **kw)
            with pytest.raises(ValueError) as got:
                getattr(tdb, build)(*args, device="cpu", **kw)
            assert str(got.value) == str(want.value)
    wide = _codes(_genomes(rng, 3, length=1500, snps=300))
    for kw in ({"genome_batch": 48}, {"batch_budget": 100}):
        with pytest.raises(ValueError) as want:
            jdb.build_matrix_device_batched(wide, 9, **kw)
        with pytest.raises(ValueError) as got:
            tdb.build_matrix_device_batched(wide, 9, device="cpu", **kw)
        assert str(got.value) == str(want.value)


def test_column_steps_drop_past_the_budget(rng):
    """A union past k_budget: the plain steps drop the columns past it, as
    grm_tpu's scatters do, and the singleton filter still compacts."""
    codes = torch.from_numpy(np.stack([c[:300] for c in
                                       _codes(_genomes(rng, 3, snps=0))]))
    keys, valid = tk.window_keys(codes, 9)
    keys, perm, valid = tk.sort_keys(keys, valid)
    matrix, union, n = db.build_columns(keys, perm, valid, 1, 300, 50)
    assert matrix.shape == (1, 50) and int(n) > 50
    full, full_union, _ = db.build_columns(keys, perm, valid, 1, 300, 1000)
    np.testing.assert_array_equal(matrix.numpy(), full[:, :50].numpy())
    np.testing.assert_array_equal(union.numpy(), full_union[:50].numpy())
    out, out_union, m = db.compact_columns(matrix, union, n)
    counts = np.array([bin(int(x) & 0xFFFFFFFF).count("1")
                       for x in matrix[0].tolist()])
    keep = counts != 1
    assert int(m) == keep.sum()
    np.testing.assert_array_equal(out[0, :int(m)].numpy(),
                                  matrix[0].numpy()[keep])
    assert not out[0, int(m):].any() and not out_union[int(m):].any()


def test_build_needs_cuda_by_default(rng):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    codes = _codes(_genomes(rng, 2))
    for build in (tdb.build_matrix_device, tdb.build_matrix_device_batched):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(codes, 9)
