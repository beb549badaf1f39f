"""The port's kernels (their plain PyTorch versions, on the CPU) against the
JAX package: masked popcount column sums against ``popcount_colsum_pallas``
(interpret mode) and ``masked_popcount_colsum``, the argmax sweep against
``scm_utility_argmax_pallas``, the superblock-max sweep against the exact
engine's ``_pass1``, and ``BitMatrix`` against ``grm_tpu``'s. Inputs come
from numpy seeds; every comparison is exact except where a test states its
tolerance and why."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grm_tpu.ops.pallas_popcount import popcount_colsum_pallas
from grm_tpu.ops.pallas_scm_sweep import scm_utility_argmax_pallas
from grm_tpu.ops.popcount import BitMatrix as JaxBitMatrix
from grm_tpu.ops.popcount import masked_popcount_colsum
from grm_tpu.ops.popcount import u64_matrix_to_u32 as jax_u64_to_u32
from grm_tpu.parallel.scm_exact import _pass1
from grm_tpu.utils import pack_binary_bytes_to_ints

from grm_tpu_torch.ops import popcount as pc
from grm_tpu_torch.ops import scm_sweep as sw

def _t(a):
    """uint32 numpy -> int32 torch (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _packed(rng, n_genomes, n_cols, density=0.5):
    dense = (rng.rand(n_genomes, n_cols) < density).astype(np.uint8)
    return dense, pack_binary_bytes_to_ints(dense, 32)


@pytest.mark.parametrize("n_genomes,k,c", [(70, 512, 3), (101, 513, 1),
                                           (45, 2000, 12), (333, 700, 2)])
def test_popcount_colsum_plain_matches_jax(n_genomes, k, c):
    rng = np.random.RandomState(n_genomes + k)
    _, matrix = _packed(rng, n_genomes, k)
    masks = rng.randint(0, 2**32, size=(c, matrix.shape[0]),
                        dtype=np.uint64).astype(np.uint32)
    got = pc.popcount_colsum(_t(matrix), _t(masks)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(popcount_colsum_pallas(matrix, masks, interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(masked_popcount_colsum(matrix, masks)))


def test_popcount_colsum_pairs_plain_matches_column_slices():
    rng = np.random.RandomState(3)
    _, matrix = _packed(rng, 77, 1000)
    offsets = np.array([0, 256, 999, 1000, 7, 600, -100, -300])
    masks = rng.randint(0, 2**32, size=(len(offsets), 2, matrix.shape[0]),
                        dtype=np.uint64).astype(np.uint32)
    got = pc.popcount_colsum_pairs(
        _t(matrix), _t(masks), torch.from_numpy(offsets), 256).numpy()
    for i, off in enumerate(offsets):
        want = np.zeros((2, 256), np.int32)
        full = np.asarray(masked_popcount_colsum(matrix, masks[i]))
        lo = max(off, 0)
        part = full[:, lo:max(off + 256, 0)]
        want[:, lo - off:lo - off + part.shape[1]] = part
        np.testing.assert_array_equal(got[i], want)


def _fit_masks(rng, n_genomes, w, f):
    """Per-fit disjoint neg/pos example masks and their counts."""
    from grm_tpu.utils import build_row_mask

    neg, pos = [], []
    for _ in range(f):
        y = rng.rand(n_genomes)
        out = np.zeros((2, w), np.uint32)
        for i, sel in enumerate((y < 0.35, (y >= 0.35) & (y < 0.75))):
            m = build_row_mask(np.where(sel)[0], n_genomes, 32)
            out[i, :len(m)] = m
        neg.append(out[0])
        pos.append(out[1])
    neg, pos = np.stack(neg), np.stack(pos)
    popc = lambda a: np.unpackbits(a.view(np.uint8), axis=1).sum(1)
    return neg, pos, popc(neg).astype(np.int32), popc(pos).astype(np.int32)


@pytest.mark.parametrize("n_kmers,k_cols", [(531, 531), (500, 531),
                                            (130, 256)])
def test_sweep_argmax_plain_matches_pallas(n_kmers, k_cols):
    """The ragged cases of test_parallel's pallas sweep test, 4 fits with p
    in {0.5, 1, 2, 4}: winners and utilities equal."""
    rng = np.random.RandomState(n_kmers)
    n_genomes = 70
    dense, matrix = _packed(rng, n_genomes, k_cols, 0.4)
    dense[:, n_kmers:] = 0
    matrix = pack_binary_bytes_to_ints(dense, 32)
    neg, pos, nn, np_ = _fit_masks(rng, n_genomes, matrix.shape[0], 4)
    ps = np.array([0.5, 1.0, 2.0, 4.0], np.float32)
    want = scm_utility_argmax_pallas(
        jnp.asarray(matrix), jnp.asarray(neg), jnp.asarray(pos),
        jnp.asarray(nn.astype(np.float32)), jnp.asarray(np_.astype(np.float32)),
        jnp.asarray(ps), n_kmers, interpret=True, block=128)
    got = sw.scm_utility_argmax(
        _t(matrix), _t(neg), _t(pos), torch.from_numpy(nn),
        torch.from_numpy(np_), torch.from_numpy(ps), n_kmers, block=128)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("grid", ["dyadic", "published"])
@pytest.mark.parametrize("blacklist", [False, True])
@pytest.mark.parametrize("k", [700, 2048])
def test_sweep_sbmax_plain_matches_pass1(k, blacklist, grid):
    """Exact for p in {0.5, 1, 2, 4}, where no product rounds. For the
    published p grid XLA on the CPU contracts ``a - p * b`` into a fused
    multiply-add (one rounding) where PyTorch rounds the product first, so
    the two may differ by the product's rounding: at most
    2 eps (n_neg + p n_pos) per fit."""
    rng = np.random.RandomState(k + blacklist)
    n_genomes, sb = 101, 256
    _, matrix = _packed(rng, n_genomes, k)
    neg, pos, nn, np_ = _fit_masks(rng, n_genomes, matrix.shape[0], 10)
    if grid == "dyadic":
        ps = np.array([0.5, 1.0, 2.0, 4.0] * 3, np.float32)[:10]
    else:
        ps = np.array([0.1, 0.178, 0.316, 0.562, 1.0, 1.778, 3.162, 5.623,
                       10.0, 999999.0], np.float32)
    excl = None
    kp = -(-k // sb) * sb
    padded = np.zeros((matrix.shape[0], kp), np.uint32)
    padded[:, :k] = matrix
    if blacklist:
        excl = (rng.rand(2, k) < 0.2)
        excl_pad = np.zeros((2, kp), bool)
        excl_pad[:, :k] = excl
    want, _ = _pass1(jnp.asarray(padded), jnp.asarray(neg), jnp.asarray(pos),
                     jnp.asarray(ps), k, sb,
                     excl=None if excl is None else jnp.asarray(excl_pad))
    got = sw.scm_sweep_sbmax(
        _t(matrix), _t(neg), _t(pos), torch.from_numpy(nn),
        torch.from_numpy(np_), torch.from_numpy(ps), k, sb,
        None if excl is None else torch.from_numpy(excl.astype(np.uint8)))
    if grid == "dyadic":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        tol = 2 * np.finfo(np.float32).eps * (nn + ps * np_)
        want = np.asarray(want)
        np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
        diff = np.where(np.isinf(want), 0.0, got.numpy() - want)
        assert (np.abs(diff).max(1) <= tol).all()


@pytest.mark.parametrize("n_rows", [70, 130, 64])
def test_bitmatrix_matches_jax(n_rows):
    rng = np.random.RandomState(n_rows)
    dense = (rng.rand(n_rows, 300) < 0.5).astype(np.uint8)
    m64 = pack_binary_bytes_to_ints(dense, 64)
    from grm_tpu_torch.ops.popcount import BitMatrix, u64_matrix_to_u32

    np.testing.assert_array_equal(u64_matrix_to_u32(m64), jax_u64_to_u32(m64))
    ours = BitMatrix.from_u64(m64, n_rows, device="cpu")
    ref = JaxBitMatrix.from_u64(m64, n_rows)
    assert ours.shape == ref.shape
    rows_list = [rng.choice(n_rows, 9, replace=False), np.arange(n_rows),
                 np.array([0, n_rows - 1])]
    np.testing.assert_array_equal(ours.presence_counts(rows_list),
                                  ref.presence_counts(rows_list))
    for rows in rows_list:
        a, b = ours.sum_rows(rows), ref.sum_rows(rows)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    cols = np.array([5, 0, 299, 5, 17])
    np.testing.assert_array_equal(ours.get_columns_dense(cols),
                                  ref.get_columns_dense(cols))
    np.testing.assert_array_equal(ours.get_columns_dense(cols),
                                  dense[:, cols])
    with pytest.raises(IndexError):
        ours.get_columns_dense([300])
