"""``grm_tpu.ops``' entry names in the port: ``masked_popcount_colsum``
(a thin entry over ``popcount_colsum``; a 1-D mask is one row) and
``u32_matrix_to_u64`` (the host inverse of ``u64_matrix_to_u32``, an odd
row count padded with zeros), exactly against ``grm_tpu``'s, and the
package's re-exports."""

import numpy as np
import pytest
import torch

import grm_tpu.ops as jops
from grm_tpu.ops import popcount as jp

import grm_tpu_torch.ops as tops
from grm_tpu_torch.ops import popcount as tp


def _words(rng, shape):
    return rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n_masks", [0, 1, 3])
@pytest.mark.parametrize("shape", [(1, 1), (5, 37), (11, 1000)])
def test_masked_popcount_colsum_equals_jax(shape, n_masks):
    rng = np.random.RandomState(shape[1] + n_masks)
    matrix = _words(rng, shape)
    masks = _words(rng, (n_masks, shape[0]) if n_masks else (shape[0],))
    want = np.asarray(jp.masked_popcount_colsum(matrix, masks))
    got = tp.masked_popcount_colsum(matrix, masks, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # Tensors of the packed words give the same, on the matrix's device.
    as_t = lambda a: torch.from_numpy(a.view(np.int32))
    np.testing.assert_array_equal(
        tp.masked_popcount_colsum(as_t(matrix), as_t(masks)).numpy(), want)


@pytest.mark.parametrize("rows", [0, 1, 2, 5, 12])
def test_u32_matrix_to_u64_equals_jax(rows):
    rng = np.random.RandomState(rows)
    m32 = _words(rng, (rows, 9))
    got = tp.u32_matrix_to_u64(m32)
    want = jp.u32_matrix_to_u64(m32)
    assert got.dtype == np.uint64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # The round trip: u64_matrix_to_u32 gives the rows back (and the zero
    # row that padded an odd count).
    back = tp.u64_matrix_to_u32(got)
    np.testing.assert_array_equal(back[:rows], m32)
    assert not back[rows:].any()


def test_ops_package_exports_equal_jax():
    assert "masked_popcount_colsum" in tp.__all__
    assert "u32_matrix_to_u64" in tp.__all__
    assert tops.BitMatrix is tp.BitMatrix
    assert tops.masked_popcount_colsum is tp.masked_popcount_colsum
    assert {"BitMatrix", "masked_popcount_colsum"} <= set(dir(jops))
