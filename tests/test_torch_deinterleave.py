"""The artifact's matrix split (``grm_tpu_torch.ops.popcount``): the plain
version of the ``deinterleave_u64`` kernel against ``grm_tpu``'s XLA
program ``_deinterleave_u64_view`` (run in JAX on the CPU) and against
``u64_matrix_to_u32``; the chunked ``split_u64`` behind
``BitMatrix.from_u64`` against the same, with odd uint64 row counts, genome
counts that are a multiple of 32 but not of 64, no column, ragged last
chunks (small chunks by a smaller ``LOAD_CHUNK_BYTES``), one-column chunks
through the wrapper, and big-endian or non-contiguous input; and
``BitMatrix.from_u64(device="cpu")`` against ``grm_tpu``'s words. Inputs
come from numpy seeds; every comparison is exact (a layout copy)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grm_tpu.ops.popcount import BitMatrix as JaxBitMatrix
from grm_tpu.ops.popcount import _deinterleave_u64_view
from grm_tpu.ops.popcount import u64_matrix_to_u32 as jax_u64_to_u32

from grm_tpu_torch.ops import _build
from grm_tpu_torch.ops import popcount as pc


def _m64(rng, w64, k):
    return rng.integers(0, 2**64, size=(w64, k), dtype=np.uint64,
                        endpoint=False)


def _words(t):
    return t.numpy().view(np.uint32)


def _chunks(monkeypatch, w64, cols):
    """Make split_u64's staged chunks ``cols`` columns wide for ``w64``
    uint64 rows (None: the default width)."""
    if cols is not None:
        monkeypatch.setattr(pc, "LOAD_CHUNK_BYTES", 8 * w64 * cols)
        assert pc.load_chunk_cols(w64) == cols


# (genomes, k-mers): 342 genomes give 6 uint64 rows and 11 word rows (the
# last low half dropped); 96 = 32 x 3 and 32 a multiple of 32 but not of
# 64; 64 and 128 whole rows; 1 genome; no k-mer.
SHAPES = [(342, 1001), (96, 37), (32, 5), (64, 64), (128, 3), (1, 9),
          (342, 0), (5022, 17)]


@pytest.mark.parametrize("n_rows,k", SHAPES)
def test_plain_matches_xla_and_host_split(n_rows, k):
    rng = np.random.default_rng(n_rows * 7 + k)
    w64 = -(-n_rows // 64)
    n_words = -(-n_rows // 32)
    m64 = _m64(rng, w64, k)
    raw = torch.from_numpy(m64.view(np.int32).reshape(w64, 2 * k))
    got = _words(pc.deinterleave_u64_plain(raw, n_words))
    want = jax_u64_to_u32(m64)[:n_words]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pc.u64_matrix_to_u32(m64)[:n_words])
    if k:  # XLA's program keeps the padding row; it is what the plain drops
        xla = np.asarray(_deinterleave_u64_view(
            jnp.asarray(m64.view(np.uint32))))
        np.testing.assert_array_equal(got, xla[:n_words])
        assert xla.shape == (2 * w64, k)


@pytest.mark.parametrize("n_rows,k", SHAPES)
@pytest.mark.parametrize("chunk_cols", [None, 4, 8, 12, 252])
def test_split_u64_chunks(monkeypatch, n_rows, k, chunk_cols):
    rng = np.random.default_rng(n_rows + 31 * k)
    m64 = _m64(rng, -(-n_rows // 64), k)
    n_words = -(-n_rows // 32)
    _chunks(monkeypatch, m64.shape[0], chunk_cols)
    want = jax_u64_to_u32(m64)[:n_words]
    got = pc.split_u64(m64, n_words, "cpu")
    assert got.dtype == torch.int32 and got.shape == (n_words, k)
    np.testing.assert_array_equal(_words(got), want)


@pytest.mark.parametrize("n_rows,k", SHAPES)
def test_deinterleave_one_column_chunks(n_rows, k):
    """The wrapper over one-column chunks (odd offsets and widths that
    the load's chunks, multiples of 4, never give) builds the host split's
    words."""
    rng = np.random.default_rng(n_rows + 17 * k)
    w64, n_words = -(-n_rows // 64), -(-n_rows // 32)
    m64 = _m64(rng, w64, k)
    raw = torch.from_numpy(m64.view(np.int32).reshape(w64, 2 * k))
    out = torch.full((n_words, k), -7, dtype=torch.int32)
    for lo in range(k):
        pc.deinterleave_u64(raw[:, 2 * lo:2 * lo + 2].contiguous(), out, lo)
    np.testing.assert_array_equal(_words(out), jax_u64_to_u32(m64)[:n_words])


@pytest.mark.parametrize("layout", ["big-endian", "fortran", "strided",
                                    "int64"])
def test_split_u64_makes_the_input_native(monkeypatch, layout):
    rng = np.random.default_rng(5)
    m64 = _m64(rng, 6, 2 * 777)
    src = {"big-endian": lambda: m64.astype(">u8"),
           "fortran": lambda: np.asfortranarray(m64),
           "strided": lambda: m64[:, ::2],
           "int64": lambda: m64.view(np.int64)}[layout]()
    want = jax_u64_to_u32(np.asarray(src).astype(np.uint64))[:11]
    _chunks(monkeypatch, 6, 100)
    np.testing.assert_array_equal(_words(pc.split_u64(src, 11, "cpu")),
                                  want)


@pytest.mark.parametrize("fill_threads", [1, 3, 4])
@pytest.mark.parametrize("chunk_cols", [None, 77_776])
def test_split_u64_fill_threads(monkeypatch, fill_threads, chunk_cols):
    """A load past 8 MiB copies each chunk on FILL_THREADS threads, column
    slices each; the words do not change."""
    monkeypatch.setattr(pc, "FILL_THREADS", fill_threads)
    rng = np.random.default_rng(fill_threads)
    m64 = _m64(rng, 6, 200_003).astype(">u8")  # 9.6 MB, byte-swapped
    _chunks(monkeypatch, 6, chunk_cols)
    got = pc.split_u64(m64, 11, "cpu")
    np.testing.assert_array_equal(_words(got), jax_u64_to_u32(
        m64.astype(np.uint64))[:11])


def test_split_u64_drops_rows_past_the_word_count(monkeypatch):
    rng = np.random.default_rng(9)
    m64 = _m64(rng, 8, 50)
    _chunks(monkeypatch, 3, 8)  # 5 word rows read 3 uint64 rows
    np.testing.assert_array_equal(_words(pc.split_u64(m64, 5, "cpu")),
                                  jax_u64_to_u32(m64)[:5])
    with pytest.raises(ValueError):
        pc.split_u64(m64, 17, "cpu")


@pytest.mark.parametrize("n_rows,k", [(342, 1001), (96, 300), (70, 1),
                                      (64, 0)])
@pytest.mark.parametrize("chunk_cols", [None, 4, 64])
def test_from_u64_matches_grm_tpu(monkeypatch, n_rows, k, chunk_cols):
    rng = np.random.default_rng(n_rows + k)
    m64 = _m64(rng, -(-n_rows // 64), k)
    n_words = -(-n_rows // 32)
    _chunks(monkeypatch, m64.shape[0], chunk_cols)
    _build.reset_launches()
    ours = pc.BitMatrix.from_u64(m64, n_rows, device="cpu")
    assert _build.launches["deinterleave_u64"] == 0  # the CPU launches none
    assert ours.n_words == n_words and ours.n_columns == k
    assert ours.device == torch.device("cpu")
    ref = np.asarray(JaxBitMatrix.from_u64(m64, n_rows).data)
    np.testing.assert_array_equal(_words(ours.data), ref[:n_words, :k])
    if k:
        rows = [rng.choice(n_rows, min(9, n_rows), replace=False)]
        np.testing.assert_array_equal(
            ours.presence_counts(rows),
            JaxBitMatrix.from_u64(m64, n_rows).presence_counts(rows))


def test_deinterleave_wrapper_writes_its_columns_only():
    rng = np.random.default_rng(3)
    m64 = _m64(rng, 6, 40)
    out = torch.full((11, 100), -7, dtype=torch.int32)
    raw = torch.from_numpy(m64.view(np.int32).reshape(6, 80))
    assert pc.deinterleave_u64(raw, out, 30) is out
    np.testing.assert_array_equal(_words(out[:, 30:70]),
                                  jax_u64_to_u32(m64)[:11])
    assert (out[:, :30] == -7).all() and (out[:, 70:] == -7).all()


@pytest.mark.parametrize("raw_shape,out_shape,lo", [
    ((6, 81), (11, 100), 0),    # an odd count of 32-bit words
    ((6, 80), (13, 100), 0),    # too many word rows for 6 uint64 rows
    ((6, 80), (10, 100), 0),    # too few
    ((6, 80), (11, 100), 61),   # past the last column
    ((6, 80), (11, 100), -1),
])
def test_deinterleave_wrapper_rejects_what_does_not_fit(raw_shape, out_shape,
                                                        lo):
    raw = torch.zeros(raw_shape, dtype=torch.int32)
    out = torch.zeros(out_shape, dtype=torch.int32)
    with pytest.raises(ValueError):
        pc.deinterleave_u64(raw, out, lo)


def test_load_chunk_cols(monkeypatch):
    assert pc.load_chunk_cols(6) * 6 * 8 <= pc.LOAD_CHUNK_BYTES
    assert pc.load_chunk_cols(6) % 4 == 0
    assert pc.load_chunk_cols(10**9) == 4
    monkeypatch.setattr(pc, "LOAD_CHUNK_BYTES", 8 * 6 * 7)
    assert pc.load_chunk_cols(6) == 4  # rounded down to a multiple of 4
    monkeypatch.setattr(pc, "LOAD_CHUNK_BYTES", 1)
    assert pc.load_chunk_cols(6) == 4
