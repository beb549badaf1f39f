"""Masked-popcount column sweeps over the packed genome x k-mer bit matrix.

Port of ``grm_tpu/ops/popcount.py``. The matrix is stored as a (W, K)
``int32`` tensor of packed words (torch has no popcount and no ``uint32``
right shift on the CPU, so words travel as int32 bit patterns), MSB-first:
genome ``g`` is bit ``31 - g % 32`` of word row ``g // 32``. The on-disk
uint64 layout converts with :func:`u64_matrix_to_u32`, word for word as
``grm_tpu.ops.popcount.u64_matrix_to_u32`` does; :meth:`BitMatrix.from_u64`
splits it on the card instead (:func:`split_u64`: column chunks through a
pinned staging ring, each split by the hand-written CUDA kernel
``csrc/deinterleave.cu``).

The sweep, for C row-selection masks at once::

    counts[c, k] = sum_w popcount(matrix[w, k] & masks[c, w])

runs as the hand-written CUDA kernel ``csrc/popcount_colsum.cu`` on a CUDA
tensor, and as its plain PyTorch version (SWAR popcount on int64, column
block by column block) on a CPU tensor.

:class:`BitMatrix` holds the matrix on the device; :class:`StreamingBitMatrix`
keeps it in host memory (``ops/stream.py``) and runs the same kernel on each
chunk it uploads.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve_device
from ..profiling import span
from ..utils import build_row_mask, minimum_uint_size, unpack_binary_bytes_from_ints
from . import _build
from .stream import ChunkSource, split_u64_into

__all__ = [
    "BitMatrix",
    "StreamingBitMatrix",
    "popcount_colsum",
    "popcount_colsum_plain",
    "popcount_colsum_pairs",
    "popcount_colsum_pairs_plain",
    "popcount_rows",
    "masked_popcount_colsum",
    "masks_to_tensor",
    "u32_matrix_to_u64",
    "u64_matrix_to_u32",
    "deinterleave_u64",
    "deinterleave_u64_plain",
    "split_u64",
    "load_chunk_cols",
]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "grm_popcount_colsum": ([_P, _I, _L, _P, _I, _P, _P], _I),
    "grm_popcount_colsum_pairs": ([_P, _I, _L, _P, _P, _I, _I, _P, _P], _I),
}
_DEINTERLEAVE_SIGNATURES = {
    "grm_deinterleave_u64": ([_P, _I, _L, _P, _I, _L, _L, _P], _I),
}
_SMEM_WORDS = 12288  # 48 KB of masks per launch: no opt-in attribute needed
# Bytes of uint64 words per staged chunk of BitMatrix.from_u64: two such
# chunks on the card beside the matrix, two in pinned host memory.
LOAD_CHUNK_BYTES = 64 << 20
# Host threads that copy a chunk into its staging buffer (numpy copies
# without the GIL); a load under 8 MiB copies on the calling thread.
FILL_THREADS = 4


def u64_matrix_to_u32(m64):
    """Split a uint64 MSB-first packed matrix into uint32 word rows: row
    ``w`` of the uint64 matrix becomes rows ``2w`` (high half, genomes
    ``[64w, 64w+32)``) and ``2w+1`` (low half)."""
    m64 = np.ascontiguousarray(m64, dtype=np.uint64)
    out = np.empty((m64.shape[0] * 2, m64.shape[1]), dtype=np.uint32)
    split_u64_into(out, m64, 0, m64.shape[1])
    return out


def u32_matrix_to_u64(m32):
    """Inverse of :func:`u64_matrix_to_u32` on the host: word rows 2w and
    2w + 1 become the high and low halves of uint64 row w; an odd row count
    is padded with a zero row."""
    m32 = np.ascontiguousarray(m32, dtype=np.uint32)
    if m32.shape[0] % 2:
        m32 = np.concatenate([m32, np.zeros((1,) + m32.shape[1:], np.uint32)])
    return ((m32[0::2].astype(np.uint64) << np.uint64(32))
            | m32[1::2].astype(np.uint64))


def deinterleave_u64_plain(raw, n_words):
    """Plain PyTorch version of :func:`deinterleave_u64`: ``raw`` (W64, 2c)
    int32, the little-endian words of a (W64, c) uint64 matrix, -> (n_words,
    c) int32, row 2w the high halves of row w, row 2w + 1 the low halves;
    rows from ``n_words`` on are dropped."""
    w64, c2 = raw.shape
    halves = raw.view(w64, c2 // 2, 2)
    return torch.stack((halves[..., 1], halves[..., 0]), dim=1).reshape(
        2 * w64, c2 // 2)[:n_words]


def deinterleave_u64(raw, out, lo):
    """Split ``raw``, (W64, 2c) int32, the little-endian words of a (W64, c)
    uint64 chunk, into columns [lo, lo + c) of ``out``, the (n_words, K)
    int32 matrix (n_words is 2 W64 or 2 W64 - 1), as
    :func:`deinterleave_u64_plain` splits it. A CUDA tensor launches the
    kernel ``csrc/deinterleave.cu`` once; a CPU tensor takes the plain
    version. Returns ``out``."""
    _check_matrix(out)
    if raw.dtype != torch.int32 or raw.dim() != 2 or raw.shape[1] % 2:
        raise ValueError("raw must be a (W64, 2c) int32 tensor")
    w64, c = raw.shape[0], raw.shape[1] // 2
    n_words, k = out.shape
    if n_words not in (2 * w64, 2 * w64 - 1) or not 0 <= lo <= k - c:
        raise ValueError("a (%d, %d) chunk does not fit columns [%d, %d) of "
                         "a (%d, %d) matrix" % (w64, c, lo, lo + c, n_words, k))
    if raw.device != out.device:
        raise ValueError("raw and out must be on one device")
    if out.device.type != "cuda":
        out[:, lo:lo + c] = deinterleave_u64_plain(raw, n_words)
        return out
    if not raw.is_contiguous():
        raise ValueError("raw must be contiguous")
    if w64 > 65535:
        raise ValueError("too many uint64 rows for one launch")
    if c == 0 or w64 == 0:
        return out
    lib = _build.library("deinterleave", _DEINTERLEAVE_SIGNATURES)
    with torch.cuda.device(out.device):
        _build.check(lib.grm_deinterleave_u64(
            raw.data_ptr(), w64, c, out.data_ptr(), n_words, k, lo,
            _stream(out)), "deinterleave_u64")
        _build.launches["deinterleave_u64"] += 1
    return out


def load_chunk_cols(w64):
    """Columns per staged chunk of :func:`split_u64` for ``w64`` uint64
    rows: as many as fill :data:`LOAD_CHUNK_BYTES`, rounded down to a
    multiple of 4 (the kernel's 16-byte stores), at least 4."""
    return max(4, LOAD_CHUNK_BYTES // (8 * max(int(w64), 1)) // 4 * 4)


def _fill(dst, src, pool, threads):
    """``np.copyto(dst, src)`` into native byte order, the columns split
    across ``threads`` threads of ``pool`` where there is a pool."""
    if pool is None:
        np.copyto(dst, src, casting="unsafe")
        return
    step = -(-dst.shape[1] // threads)
    list(pool.map(lambda a: np.copyto(dst[:, a:a + step], src[:, a:a + step],
                                      casting="unsafe"),
                  range(0, dst.shape[1], step)))


def split_u64(m64, n_words, device):
    """The first ``n_words`` 32-bit word rows of the uint64 MSB-first
    matrix ``m64`` (any byte order and strides), as a (n_words, K) int32
    tensor on ``device``: the words of :func:`u64_matrix_to_u32`.

    The matrix goes through in column chunks (:func:`load_chunk_cols`) and
    a ring of two staging buffers. On a CUDA device they are pinned: the
    host copies chunk i + 1 into its buffer (native byte order) while chunk
    i is copied to the card on a copy stream of its own and split there by
    :func:`deinterleave_u64` on the current stream, which waits on an event
    for the copy. The host waits on an event before it refills a buffer
    whose copy may still run, and the copy stream on another before it
    overwrites a device buffer the kernel may still read. The card holds
    the matrix plus two chunks. The host's copy of a chunk runs on
    :data:`FILL_THREADS` threads, a slice of its columns each. On the CPU
    the same chunks take the plain version."""
    m64 = np.asarray(m64)
    if m64.ndim != 2:
        raise ValueError("m64 must be a 2-D uint64 matrix")
    if m64.dtype.kind != "u" or m64.dtype.itemsize != 8:
        m64 = m64.astype(np.uint64)
    device = resolve_device(device)
    w64, k = -(-int(n_words) // 2), m64.shape[1]
    if not 0 <= w64 <= m64.shape[0]:
        raise ValueError("%d word rows need %d uint64 rows, not %d"
                         % (n_words, w64, m64.shape[0]))
    with span("load.stage"):  # the matrix on the device
        out = torch.empty((n_words, k), dtype=torch.int32, device=device)
    if n_words == 0 or k == 0:
        return out
    ch = min(load_chunk_cols(w64), k)
    n_chunks = -(-k // ch)
    n_bufs = min(2, n_chunks)
    cuda = device.type == "cuda"
    threads = FILL_THREADS
    pool = (ThreadPoolExecutor(threads) if threads > 1
            and 8 * w64 * k >= 8 << 20 else None)
    with span("load.stage"):  # the staging buffers
        host = [torch.empty(2 * w64 * ch, dtype=torch.int32,
                            pin_memory=cuda) for _ in range(n_bufs)]
        if cuda:
            stage = [torch.empty(2 * w64 * ch, dtype=torch.int32,
                                 device=device) for _ in range(n_bufs)]
    if cuda:
        compute = torch.cuda.current_stream(device)
        copy = torch.cuda.Stream(device)
        copied = [torch.cuda.Event() for _ in range(n_bufs)]
        split = [torch.cuda.Event() for _ in range(n_bufs)]
    try:
        for ci in range(n_chunks):
            b, lo = ci % n_bufs, ci * ch
            c = min(ch, k - lo)
            if cuda and ci >= n_bufs:
                with span("load.wait"):
                    copied[b].synchronize()  # chunk ci - 2's copy left b
            raw = host[b][:2 * w64 * c]
            with span("load.fill", bytes=8 * w64 * c):
                _fill(raw.numpy().view(np.uint64).reshape(w64, c),
                      m64[:w64, lo:lo + c], pool, threads)
            with span("load.enqueue"):  # the chunk's copy and split
                if cuda:
                    with torch.cuda.stream(copy):
                        if ci >= n_bufs:  # chunk ci - 2's split read stage b
                            copy.wait_event(split[b])
                        stage[b][:raw.numel()].copy_(raw, non_blocking=True)
                        copied[b].record(copy)
                    compute.wait_event(copied[b])
                    raw = stage[b][:raw.numel()]
                deinterleave_u64(raw.view(w64, 2 * c), out, lo)
                if cuda:
                    split[b].record(compute)
    finally:
        if pool is not None:
            pool.shutdown()
        if cuda:
            compute.wait_stream(copy)
    return out


def masks_to_tensor(masks, device):
    """uint32 numpy masks -> int32 tensor of the same bits on ``device``."""
    arr = np.ascontiguousarray(masks, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device)


def _popcount32(x):
    """SWAR popcount of int32 words (as unsigned bits) -> int64 counts."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def popcount_rows(masks):
    """(..., W) int32 packed masks -> (...,) int64 set-bit counts."""
    return _popcount32(masks).sum(-1)


def _check_matrix(matrix):
    if matrix.dtype != torch.int32 or matrix.dim() != 2:
        raise ValueError("matrix must be a 2-D int32 tensor of packed words")
    if not matrix.is_contiguous():
        raise ValueError("matrix must be contiguous")


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def popcount_colsum_plain(matrix, masks):
    """Plain PyTorch version of :func:`popcount_colsum` (any device)."""
    w, k = matrix.shape
    c = masks.shape[0]
    out = torch.empty((c, k), dtype=torch.int32, device=matrix.device)
    step = max(1024, (1 << 24) // max(c * w, 1))
    for lo in range(0, k, step):
        sel = matrix[None, :, lo:lo + step] & masks[:, :, None]  # (C, W, B)
        out[:, lo:lo + step] = _popcount32(sel).sum(1).to(torch.int32)
    return out


def popcount_colsum(matrix, masks):
    """counts[c, k] = sum_w popcount(matrix[w, k] & masks[c, w]).

    matrix: (W, K) int32 packed words; masks: (C, W) int32. Returns (C, K)
    int32 on the matrix's device. A CUDA tensor launches the kernel (one
    launch per 12288 / W masks); a CPU tensor takes the plain version.
    """
    _check_matrix(matrix)
    if masks.dtype != torch.int32 or masks.dim() != 2 \
            or masks.shape[1] != matrix.shape[0]:
        raise ValueError("masks must be (C, W) int32 with W = matrix rows")
    if masks.device != matrix.device:
        raise ValueError("matrix and masks must be on one device")
    if matrix.device.type != "cuda":
        return popcount_colsum_plain(matrix, masks)
    lib = _build.library("popcount_colsum", _SIGNATURES)
    w, k = matrix.shape
    c = masks.shape[0]
    out = torch.empty((c, k), dtype=torch.int32, device=matrix.device)
    if k == 0 or c == 0:
        return out
    chunk = max(1, _SMEM_WORDS // max(w, 1))
    with torch.cuda.device(matrix.device):
        for lo in range(0, c, chunk):
            m = masks[lo:lo + chunk].contiguous()
            o = out[lo:lo + chunk]
            _build.check(lib.grm_popcount_colsum(
                matrix.data_ptr(), w, k, m.data_ptr(), m.shape[0],
                o.data_ptr(), _stream(matrix)), "popcount_colsum")
            _build.launches["popcount_colsum"] += 1
    return out


def masked_popcount_colsum(matrix, masks, device=None):
    """``grm_tpu``'s entry to the sweep: ``matrix`` (W, K) and ``masks``
    (C, W), or one (W,) mask taken as a row, each a uint32 numpy array or
    an int32 tensor of packed words; returns (C, K) int32 counts
    (:func:`popcount_colsum`: the kernel on the card, the plain version on
    the CPU) on the matrix tensor's device, else on ``device`` (default
    ``"cuda"``), where numpy inputs are uploaded."""
    dev = (matrix.device if isinstance(matrix, torch.Tensor)
           else resolve_device(device))
    matrix, masks = (
        x.to(dev) if isinstance(x, torch.Tensor)
        else masks_to_tensor(np.asarray(x, np.uint32), dev)
        for x in (matrix, masks))
    if masks.dim() == 1:
        masks = masks[None, :]
    return popcount_colsum(matrix.contiguous(), masks.contiguous())


def popcount_colsum_pairs_plain(matrix, masks, offsets, width):
    """Plain PyTorch version of :func:`popcount_colsum_pairs`."""
    k = matrix.shape[1]
    out = torch.zeros((masks.shape[0], 2, width), dtype=torch.int32,
                      device=matrix.device)
    for i, off in enumerate(offsets.tolist()):
        lo, hi = max(off, 0), min(off + width, k)
        if hi > lo:
            out[i, :, lo - off:hi - off] = popcount_colsum_plain(
                matrix[:, lo:hi], masks[i])
    return out


def popcount_colsum_pairs(matrix, masks, offsets, width):
    """Pair-batched column sums: pair p counts columns
    ``[offsets[p], offsets[p] + width)`` against its own two masks.

    masks: (P, 2, W) int32; offsets: (P,) int64. Returns (P, 2, width)
    int32; columns outside [0, K) count 0. The same device function as
    :func:`popcount_colsum`, one launch for all pairs.
    """
    _check_matrix(matrix)
    if masks.dtype != torch.int32 or masks.dim() != 3 or masks.shape[1] != 2 \
            or masks.shape[2] != matrix.shape[0]:
        raise ValueError("masks must be (P, 2, W) int32 with W = matrix rows")
    if offsets.dtype != torch.int64 or offsets.shape != masks.shape[:1]:
        raise ValueError("offsets must be (P,) int64")
    if masks.device != matrix.device or offsets.device != matrix.device:
        raise ValueError("matrix, masks and offsets must be on one device")
    if matrix.device.type != "cuda":
        return popcount_colsum_pairs_plain(matrix, masks, offsets, width)
    if 2 * matrix.shape[0] > _SMEM_WORDS or masks.shape[0] > 65535:
        raise ValueError("too many words or pairs for one launch")
    lib = _build.library("popcount_colsum", _SIGNATURES)
    out = torch.empty((masks.shape[0], 2, width), dtype=torch.int32,
                      device=matrix.device)
    if masks.shape[0] == 0 or width == 0:
        return out
    masks = masks.contiguous()
    offsets = offsets.contiguous()
    with torch.cuda.device(matrix.device):
        _build.check(lib.grm_popcount_colsum_pairs(
            matrix.data_ptr(), matrix.shape[0], matrix.shape[1],
            masks.data_ptr(), offsets.data_ptr(), masks.shape[0], width,
            out.data_ptr(), _stream(matrix)), "popcount_colsum_pairs")
        _build.launches["popcount_colsum_pairs"] += 1
    return out


def _gather_columns(matrix, cols):
    """(C,) column indices -> (C, W) packed int32 columns."""
    return matrix.index_select(1, cols).T.contiguous()


class BitMatrix:
    """Device-resident packed presence matrix with the reference's
    ``sum_rows`` semantics (rules.py:201-267).

    Wraps a (W, K) matrix for ``n_rows`` genomes; ``data`` is the int32
    tensor on ``device`` (default ``"cuda"``). ``packed_u32`` is a uint32
    numpy array, uploaded, or a (W, K) int32 tensor, wrapped as it lies
    (``device`` defaults to its own; another raises). ``n_columns`` below K
    marks the columns past it as padding, all zero.

    ``columns_sharding`` (a :class:`~grm_tpu_torch.parallel.mesh.
    MeshSharding`, the port's ``NamedSharding(mesh, P(None, "cols"))``)
    places the matrix on a mesh instead: ``data`` is then a
    :class:`~grm_tpu_torch.parallel.mesh.ShardedMatrix`, padded to the
    shard grid, ``n_columns`` stays the unpadded width, and ``device`` is
    the mesh's first device, where the sweeps' results land.
    """

    def __init__(self, packed_u32, n_rows, device=None, n_columns=None,
                 columns_sharding=None):
        if columns_sharding is not None:
            if n_columns is not None:  # the padding columns stay behind
                packed_u32 = packed_u32[:, :n_columns]
            data = columns_sharding.place(packed_u32)
            self._init(data, n_rows, data.device, data.n_words,
                       packed_u32.shape[1], columns_sharding)
            return
        if isinstance(packed_u32, torch.Tensor):
            if packed_u32.dtype != torch.int32 or packed_u32.dim() != 2:
                raise ValueError("BitMatrix expects a 2-D int32 tensor of "
                                 "packed words.")
            dev = packed_u32.device if device is None \
                else resolve_device(device)
            if dev != packed_u32.device:
                raise ValueError("the packed tensor lies on %s, not %s"
                                 % (packed_u32.device, dev))
            data = packed_u32.contiguous()
        else:
            dev = resolve_device(device)
            packed_u32 = np.asarray(packed_u32)
            if packed_u32.dtype != np.uint32 or packed_u32.ndim != 2:
                raise ValueError("BitMatrix expects a 2-D uint32-packed "
                                 "matrix.")
            data = masks_to_tensor(packed_u32, dev)
        self._init(data, n_rows, dev, data.shape[0],
                   data.shape[1] if n_columns is None else n_columns)

    def _init(self, data, n_rows, dev, n_words, n_columns, sharding=None):
        self.n_rows = int(n_rows)
        self.n_words = int(n_words)
        self.n_columns = int(n_columns)
        if not 0 <= self.n_columns <= data.shape[1]:
            raise ValueError("n_columns must be in [0, %d]" % data.shape[1])
        if self.n_words * 32 < self.n_rows:
            raise ValueError("Packed matrix has too few word-rows for n_rows.")
        self.data = data
        self.device = dev
        self.sharding = sharding  # the MeshSharding of ``data``, or None

    @property
    def sharded(self):
        """Whether ``data`` is a ShardedMatrix on a mesh."""
        return self.sharding is not None

    @classmethod
    def from_u64(cls, m64, n_rows, device=None, sharding=None):
        """From the on-disk uint64 layout, split on the device
        (:func:`split_u64`); word rows past the last genome's (all padding
        bits) are dropped. With ``sharding`` each of this process's shards
        is split straight onto its own device, and ``m64`` may be anything
        sliced ``m64[rows, cols]`` (a memory map, an h5py dataset): only
        those shards' words are read."""
        n_words = min(-(-int(n_rows) // 32), 2 * m64.shape[0])
        if sharding is None:
            return cls(split_u64(m64, n_words, device), n_rows)
        self = cls.__new__(cls)
        data = sharding.place_u64(m64, n_words)
        self._init(data, n_rows, data.device, n_words, m64.shape[1], sharding)
        return self

    @classmethod
    def from_dense(cls, dense01, device=None):
        """From a dense (n_genomes, n_kmers) 0/1 matrix (tests, small data)."""
        from ..utils import pack_binary_bytes_to_ints

        dense01 = np.asarray(dense01, dtype=np.uint8)
        return cls(pack_binary_bytes_to_ints(dense01, 32), dense01.shape[0],
                   device=device)

    @property
    def shape(self):
        """(n_genomes, 2 * n_kmers): presence then absence rules."""
        return self.n_rows, self.n_columns * 2

    def row_mask(self, rows):
        return build_row_mask(np.asarray(rows, dtype=np.int64),
                              self.n_words * 32, 32)

    def presence_counts(self, rows_list):
        """Presence counts for several row sets in one matrix pass:
        (C, K) int64 numpy."""
        masks = masks_to_tensor(
            np.stack([self.row_mask(r) for r in rows_list]), self.device)
        if self.sharded:
            counts = self.data.colsum(masks)
        else:
            counts = popcount_colsum(self.data, masks)
        return counts[:, :self.n_columns].cpu().numpy().astype(np.int64)

    def sum_rows(self, rows):
        """Length-2K vector, presence then absence counts, in the minimum
        uint dtype for len(rows) (rules.py:201-267)."""
        rows = np.asarray(rows)
        presence = self.presence_counts([rows])[0]
        out = np.empty(self.n_columns * 2,
                       dtype=minimum_uint_size(max(rows.shape[0], 1)))
        out[: self.n_columns] = presence
        out[self.n_columns:] = rows.shape[0] - presence
        return out

    def get_columns_dense(self, cols):
        """Unpacked presence columns (n_rows, len(cols)) uint8, gathered on
        the device."""
        cols = np.asarray(cols, dtype=np.int64)
        if cols.size == 0:
            return np.empty((self.n_rows, 0), np.uint8)
        if (cols < 0).any() or (cols >= self.n_columns).any():
            raise IndexError("column index out of range")
        idx = torch.as_tensor(cols, device=self.device)
        packed = (self.data.gather_columns(idx) if self.sharded
                  else _gather_columns(self.data, idx))
        words = packed.cpu().numpy().view(np.uint32)  # (n, W)
        return unpack_binary_bytes_from_ints(words.T)[: self.n_rows]


class StreamingBitMatrix:
    """Out-of-core packed presence matrix: the words stay in host memory
    and stream through the card chunk by chunk (port of
    ``grm_tpu/ops/popcount.py:150-214``).

    ``GrmDataset.bit_matrix`` returns one for a matrix past 60% of the
    device's memory. ``source`` is its :class:`~grm_tpu_torch.ops.stream.
    ChunkSource`: the chunk-major host layout (pinned on a CUDA device) that
    :meth:`presence_counts` and the streamed exact SCM and CART engines walk.
    ``block_cols`` is the chunk width (default: ``GRM_STREAM_CHUNK_COLS``,
    else 2^21, rounded to whole superblocks); ``grm_tpu`` sweeps blocks of
    2^22 columns here, but the width changes no count, so the chunks serve
    and no second layout is kept.
    """

    sharding = None  # never on a mesh

    def __init__(self, packed_u32, n_rows, block_cols=None, device=None):
        packed = np.ascontiguousarray(packed_u32, dtype=np.uint32)
        if packed.ndim != 2:
            raise ValueError("StreamingBitMatrix expects a 2-D uint32-packed "
                             "matrix.")

        def fill(dst, lo, hi):
            dst[...] = packed[:, lo:hi]

        self._init(packed.shape[0], packed.shape[1], n_rows, fill, block_cols,
                   device)

    def _init(self, n_words, n_columns, n_rows, fill, block_cols, device):
        self.n_rows = int(n_rows)
        if n_words * 32 < self.n_rows:
            raise ValueError("Packed matrix has too few word-rows for n_rows.")
        self.source = ChunkSource(n_words, n_columns, fill, block_cols, device)
        self.n_words = self.source.n_words
        self.n_columns = self.source.n_columns
        self.block_cols = self.source.chunk_cols
        self.device = self.source.device

    @classmethod
    def from_u64(cls, m64, n_rows, block_cols=None, device=None):
        """From the on-disk uint64 layout, split straight into the chunk
        layout; word rows past the last genome's are dropped, as
        :meth:`BitMatrix.from_u64` drops them."""
        m64 = np.ascontiguousarray(m64, dtype=np.uint64)
        self = cls.__new__(cls)
        self._init(-(-int(n_rows) // 32), m64.shape[1], n_rows,
                   lambda dst, lo, hi: split_u64_into(dst, m64, lo, hi),
                   block_cols, device)
        return self

    @property
    def shape(self):
        """(n_genomes, 2 * n_kmers): presence then absence rules."""
        return self.n_rows, self.n_columns * 2

    def row_mask(self, rows):
        return build_row_mask(np.asarray(rows, dtype=np.int64),
                              self.n_words * 32, 32)

    def presence_counts(self, rows_list):
        """Presence counts for several row sets, one pass over the chunks
        (the ``popcount_colsum`` kernel on each): (C, K) int64 numpy."""
        masks = masks_to_tensor(
            np.stack([self.row_mask(r) for r in rows_list]), self.device)
        out = torch.empty((masks.shape[0], self.n_columns), dtype=torch.int32,
                          device=self.device)
        for lo, width, chunk in self.source.chunks():
            out[:, lo:lo + width] = popcount_colsum(chunk, masks)[:, :width]
        return out.cpu().numpy().astype(np.int64)

    def sum_rows(self, rows):
        """Length-2K vector, presence then absence counts, in the minimum
        uint dtype for len(rows) (rules.py:201-267)."""
        rows = np.asarray(rows)
        presence = self.presence_counts([rows])[0]
        out = np.empty(self.n_columns * 2,
                       dtype=minimum_uint_size(max(rows.shape[0], 1)))
        out[: self.n_columns] = presence
        out[self.n_columns:] = rows.shape[0] - presence
        return out

    def get_columns_dense(self, cols):
        """Unpacked presence columns (n_rows, len(cols)) uint8, gathered
        from host memory."""
        cols = np.asarray(cols, dtype=np.int64)
        if cols.size == 0:
            return np.empty((self.n_rows, 0), np.uint8)
        if (cols < 0).any() or (cols >= self.n_columns).any():
            raise IndexError("column index out of range")
        return unpack_binary_bytes_from_ints(
            np.ascontiguousarray(self.source.columns(cols).T))[: self.n_rows]
