"""The chunk source of the streamed (out-of-core) engines: a packed matrix
kept in host memory chunk-major, uploaded to the card chunk by chunk.

``grm_tpu`` keeps a matrix past its device budget as a (W, K) host array
and uploads column slices of it per sweep (``StreamingBitMatrix``,
``_run_fits_streamed``'s ``chunk_view``, ``cart_exact._HostStream``), a
ragged tail zero-padded anew on every pass. Here the host copy is laid out
once as (n_chunks, W, chunk_cols) int32 words, written there straight by
the u64 -> u32 split, so that

- every chunk is one contiguous block, uploaded by one copy;
- the ragged tail is zero-padded once, when the layout is built;
- column ``c`` is ``host[c // chunk_cols, :, c % chunk_cols]``.

On a CUDA device the layout lies in pinned (page-locked) memory, so a copy
runs at the link's rate and asynchronously; pinning that fails raises, with
no fallback to pageable copies. :meth:`ChunkSource.chunks` double-buffers
on a copy stream of its own: chunk i + 1 is copied while the kernels run
chunk i on PyTorch's current stream, which waits on an event before it
touches a chunk, and the copy stream waits on another before it refills a
buffer. Every consumer is one of the port's kernel wrappers, which launch
on the current stream (``ops/_build.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ChunkSource", "chunk_width", "split_u64_into"]


def chunk_width(chunk_cols=None):
    """The streamed chunk width: ``chunk_cols``, else the environment's
    ``GRM_STREAM_CHUNK_COLS``, else 2^21 (``grm_tpu``'s default), rounded
    down to whole superblocks as ``grm_tpu``'s exact CART stream rounds it
    (``grm_tpu/parallel/cart_exact.py:510-511``): superblocks of
    ``min(8192, max(256, chunk_cols))`` columns, at least one."""
    if chunk_cols is None:
        chunk_cols = int(os.environ.get("GRM_STREAM_CHUNK_COLS", 1 << 21))
    sb = min(8192, max(256, int(chunk_cols)))
    return max(sb, (int(chunk_cols) // sb) * sb)


def split_u64_into(dst, m64, lo, hi):
    """Columns [lo, hi) of a uint64 MSB-first matrix into ``dst`` (W, hi -
    lo) uint32 word rows: row w of the uint64 matrix gives rows 2w (its
    high half, genomes [64w, 64w + 32)) and 2w + 1 (the low half), word for
    word as ``grm_tpu.ops.popcount.u64_matrix_to_u32`` splits them; rows
    past W are dropped."""
    w = dst.shape[0]
    block = m64[:, lo:hi]
    if np.little_endian:
        halves = block.view(np.uint32).reshape(m64.shape[0], hi - lo, 2)
        dst[0::2] = halves[:(w + 1) // 2, :, 1]
        dst[1::2] = halves[:w // 2, :, 0]
    else:  # pragma: no cover - big-endian hosts
        dst[0::2] = (block[:(w + 1) // 2] >> np.uint64(32)).astype(np.uint32)
        dst[1::2] = (block[:w // 2] & np.uint64(0xFFFFFFFF)).astype(np.uint32)


class ChunkSource:
    """A (W, K) packed matrix in host memory, chunk-major, and its upload.

    ``fill(dst, lo, hi)`` writes the uint32 words of columns [lo, hi) into
    ``dst``, a (W, hi - lo) numpy view of the layout. ``chunk_cols`` is
    rounded by :func:`chunk_width`. ``device`` is where the chunks go; on
    the CPU they are the layout's own views and nothing is copied.
    ``bytes_uploaded`` counts the bytes copied to the card.
    """

    def __init__(self, n_words, n_columns, fill, chunk_cols=None,
                 device=None):
        self.device = resolve_device(device)
        self.n_words = int(n_words)
        self.n_columns = int(n_columns)
        self.chunk_cols = ch = chunk_width(chunk_cols)
        self.n_chunks = -(-self.n_columns // ch)
        self.host = torch.empty((self.n_chunks, self.n_words, ch),
                                dtype=torch.int32,
                                pin_memory=self.device.type == "cuda")
        self.words = self.host.numpy().view(np.uint32)
        for ci in range(self.n_chunks):
            lo = ci * ch
            hi = min(self.n_columns, lo + ch)
            fill(self.words[ci, :, :hi - lo], lo, hi)
            self.words[ci, :, hi - lo:] = 0
        self.bytes_uploaded = 0
        self._copy_stream = None

    def chunks(self):
        """Yield ``(lo, width, chunk)`` per chunk in column order: ``lo`` its
        first global column, ``width`` its real columns (the rest are zero
        padding), ``chunk`` its (W, chunk_cols) int32 words on the device,
        valid until the next chunk is asked for."""
        ch = self.chunk_cols
        if self.device.type != "cuda":
            for ci in range(self.n_chunks):
                lo = ci * ch
                yield lo, min(ch, self.n_columns - lo), self.host[ci]
            return
        compute = torch.cuda.current_stream(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        copy = self._copy_stream
        n_bufs = min(2, self.n_chunks)
        bufs = [torch.empty((self.n_words, ch), dtype=torch.int32,
                            device=self.device) for _ in range(n_bufs)]
        ready = [torch.cuda.Event() for _ in range(n_bufs)]
        free = [torch.cuda.Event() for _ in range(n_bufs)]

        def upload(ci):
            b = ci % n_bufs
            with torch.cuda.stream(copy):
                if ci >= n_bufs:  # the kernels of chunk ci - 2 are queued
                    copy.wait_event(free[b])
                bufs[b].copy_(self.host[ci], non_blocking=True)
                ready[b].record(copy)
            self.bytes_uploaded += bufs[b].numel() * 4

        try:
            if self.n_chunks:
                upload(0)
            for ci in range(self.n_chunks):
                if ci + 1 < self.n_chunks:
                    upload(ci + 1)
                b = ci % n_bufs
                compute.wait_event(ready[b])
                lo = ci * ch
                yield lo, min(ch, self.n_columns - lo), bufs[b]
                free[b].record(compute)
        finally:
            # A consumer that stops early leaves a copy in flight: the
            # buffers go back to the allocator on the current stream.
            compute.wait_stream(copy)

    def columns(self, cols):
        """(len(cols), W) uint32 numpy: the packed words of global columns
        ``cols``, gathered from host memory."""
        cols = np.asarray(cols, np.int64)
        return self.words[cols // self.chunk_cols, :, cols % self.chunk_cols]

    def superblocks(self, sbs, sb, width):
        """The columns of superblocks ``sbs`` (ascending global indices of
        ``sb`` columns; ``sb`` divides the chunk width) side by side, then
        zeros up to ``width`` columns: a (W, width) int32 tensor on the
        device, uploaded from a pinned staging copy."""
        per_chunk = self.chunk_cols // sb
        sbs = np.asarray(sbs, np.int64)
        grid = self.words.reshape(self.n_chunks, self.n_words, per_chunk, sb)
        picked = grid[sbs // per_chunk, :, sbs % per_chunk]  # (n, W, sb)
        stage = torch.empty((self.n_words, len(sbs) * sb), dtype=torch.int32,
                            pin_memory=self.device.type == "cuda")
        stage.numpy().view(np.uint32).reshape(
            self.n_words, len(sbs), sb)[...] = picked.transpose(1, 0, 2)
        if self.device.type == "cuda":
            self.bytes_uploaded += stage.numel() * 4
        up = stage.to(self.device, non_blocking=True)
        return torch.nn.functional.pad(up, (0, width - up.shape[1]))
