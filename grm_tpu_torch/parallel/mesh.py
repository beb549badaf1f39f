"""Device-mesh sharding for the bit matrix and the argmax engine's fit (the
port of ``grm_tpu/parallel/mesh.py``).

A :class:`Mesh` is a ``("rows", "cols")`` grid of torch devices, as
``grm_tpu``'s mesh is a grid of ``jax.devices()``: genome word rows are the
data-parallel axis, k-mer columns the feature-parallel one (the reference's
43M-column "long axis"). A matrix placed on a mesh is a
:class:`ShardedMatrix`: a grid of int32 tensors, shard ``(r, c)`` on
``mesh.devices[r][c]``, padded with zero words and zero columns to the grid
(as ``shard_bit_matrix`` pads).

One process may drive every device of its mesh; a mesh may name one device
more than once, its shards then sharing that device (tests and one-card
runs). After :func:`~grm_tpu_torch.parallel.distributed.initialize` a mesh
spans the processes, as ``grm_tpu``'s multi-controller mesh spans
``jax.distributed``'s: every process runs the same program, each grid
position has an owner process (``Mesh.owners``), and each process places,
holds and sweeps only the shards of its own positions. Where ``grm_tpu``
lets XLA insert the collectives, the port runs each local shard's kernel on
its device and combines the small per-shard results: on the process's
first device (``.to()``, which orders each copy after the work queued on
both devices' current streams) and, on a mesh that spans processes, across
the processes with the collectives of
:mod:`~grm_tpu_torch.parallel.distributed` (gloo, host arrays). The column
sums of the row shards add up (the ``psum`` over ``rows``) and the column
shards' results stand side by side in column order (the ``all_gather``
over ``cols``); a winning column is the owner shards' words, the other
positions giving zero words that a sum combines exactly. Every process
ends with the same results.

:class:`MeshSharding` is the port's counterpart of ``NamedSharding(mesh,
P(None, "cols"))``: ``BitMatrix(columns_sharding=)``,
``GrmDataset.bit_matrix(sharding=)`` and ``InMemoryDataset(sharding=)``
take it. On a mesh with one row of devices it shards the columns only; on
one with several it shards the word rows too, which the scan engine
(:func:`grm_tpu_torch.parallel.scm_device.scm_cv_batch_device`) and the
argmax fit below run on, summing each column over the row shards.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.popcount import (_gather_columns, masks_to_tensor, popcount_colsum,
                            popcount_rows, split_u64)
from .distributed import (all_gather_arrays, all_gather_fixed,
                          all_gather_objects, all_reduce, check_agreement,
                          process_count, process_index)

__all__ = [
    "Mesh",
    "MeshSharding",
    "ShardedMatrix",
    "check_mesh",
    "column_shards",
    "combine_winners",
    "make_mesh",
    "mesh_sharding",
    "shard_bit_matrix",
    "sharded_presence_counts",
    "scm_device_step",
    "scm_fit_batch_device",
    "pad_columns",
    "shard_limit",
    "spans_processes",
]


class Mesh:
    """A ``(rows, cols)`` grid of torch devices. ``shape`` is
    ``{"rows": r, "cols": c}``, as a JAX mesh's; ``devices[r][c]`` is a
    ``torch.device`` (on its owner process). ``owners[r][c]`` is the rank
    of the process that holds position (r, c), or ``owners`` is None: one
    process holds every position. ``device`` is this process's first
    device of the mesh, where its combines land."""

    axis_names = ("rows", "cols")

    def __init__(self, devices, owners=None):
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(r) != len(grid[0])
                                          for r in grid):
            raise ValueError("a mesh is a non-empty rectangular grid of "
                             "devices")
        self.devices = grid
        self.shape = {"rows": len(grid), "cols": len(grid[0])}
        self.owners = None
        self.rank = 0
        if owners is not None:
            self.owners = [[int(o) for o in row] for row in owners]
            if [len(r) for r in self.owners] != [len(r) for r in grid]:
                raise ValueError("owners must have the devices' grid shape")
            self.rank = process_index()
            if not any(self.rank in row for row in self.owners):
                raise ValueError("process %d owns no position of the mesh"
                                 % self.rank)
        self.device = next(d for r, row in enumerate(grid)
                           for c, d in enumerate(row) if self.is_local(r, c))

    @property
    def size(self):
        return self.shape["rows"] * self.shape["cols"]

    @property
    def spans_processes(self):
        """Whether positions belong to more than one process: the combines
        then exchange across the processes."""
        return self.owners is not None and len(
            {o for row in self.owners for o in row}) > 1

    def is_local(self, r, c):
        """Whether this process holds position (r, c)."""
        return self.owners is None or self.owners[r][c] == self.rank

    def _key(self):
        return (tuple(tuple(str(d) for d in row) for row in self.devices),
                None if self.owners is None
                else tuple(tuple(row) for row in self.owners))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return "Mesh(%s)" % (self._key(),)


def make_mesh(n_devices=None, row_devices=1, devices=None):
    """Build a ("rows", "cols") mesh over the available devices.

    ``row_devices`` devices shard the genome word rows (data parallel); the
    rest shard the k-mer columns (feature parallel). ``devices`` names this
    process's devices (default: every visible CUDA device) and may repeat a
    device. In a process group of several processes
    (:func:`~grm_tpu_torch.parallel.distributed.initialize`) every process
    calls this with its own devices, and the mesh spans them in
    process-major order, rank 0's devices first (``jax.devices()``' order);
    every process must then own a position.
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    owners = None
    if process_count() > 1:
        per_rank = all_gather_objects([str(d) for d in devices])
        owners = [rank for rank, names in enumerate(per_rank) for _ in names]
        devices = [torch.device(d) for names in per_rank for d in names]
    if n_devices is None:
        n_devices = len(devices)
    if not 0 < n_devices <= len(devices):
        raise ValueError("a mesh of %d devices needs that many; %d given"
                         % (n_devices, len(devices)))
    if n_devices % row_devices != 0:
        raise ValueError("row_devices must divide n_devices")
    if owners is not None and len(set(owners[:n_devices])) < process_count():
        raise ValueError("a mesh of %d devices leaves a process without a "
                         "position; every process must own one" % n_devices)
    cols = n_devices // row_devices
    cut = lambda xs: [xs[r * cols:(r + 1) * cols] for r in range(row_devices)]
    return Mesh(cut(devices), None if owners is None else cut(owners))


def check_mesh(mesh, device):
    """Raise unless every device of ``mesh`` is of ``device``'s type: a run
    that asked for the card never shards onto the CPU, and the reverse."""
    want = torch.device(device).type
    bad = sorted({str(d) for row in mesh.devices for d in row
                  if d.type != want})
    if bad:
        raise ValueError("the mesh holds %s, not %s devices"
                         % (", ".join(bad), want))


def pad_columns(matrix, multiple):
    """Zero-pad the column axis to a multiple (zero words popcount to 0)."""
    k = matrix.shape[1]
    pad = (-k) % multiple
    if pad == 0:
        return matrix, k
    return (
        np.concatenate(
            [matrix, np.zeros((matrix.shape[0], pad), matrix.dtype)], axis=1
        ),
        k,
    )


def _padded(t, rows, cols):
    """``t`` zero-padded to (rows, cols) (itself when it already is)."""
    if tuple(t.shape) == (rows, cols):
        return t.contiguous()
    out = torch.zeros((rows, cols), dtype=t.dtype, device=t.device)
    out[:t.shape[0], :t.shape[1]] = t
    return out


class ShardedMatrix:
    """A (W, K) int32 packed matrix as a grid of shards over ``mesh``:
    ``shards[r][c]`` holds word rows ``[r lw, (r + 1) lw)`` and columns
    ``[c lk, (c + 1) lk)`` on ``mesh.devices[r][c]``, for this process's
    positions only (another process's position is None). ``n_words`` is
    the unpadded word count; ``shape`` the padded grid's."""

    def __init__(self, shards, mesh, n_words, local_shape):
        self.shards = shards
        self.mesh = mesh
        self.local_w, self.local_k = local_shape
        self.shape = (self.local_w * mesh.shape["rows"],
                      self.local_k * mesh.shape["cols"])
        self.n_words = int(n_words)
        self.device = mesh.device
        self.dtype = torch.int32
        self._stacked = None

    def local_positions(self):
        """[(r, c, shard)] of this process's positions, row-major."""
        return [(r, c, t) for r, row in enumerate(self.shards)
                for c, t in enumerate(row) if t is not None]

    def column_shards(self):
        """[(first column, (W, lk) tensor)] of this process's columns, in
        ascending column order. On a mesh of one row these are its shards;
        on one of several rows each column's row shards are stacked on the
        first row's device, once, which needs every row of the column in
        this process: a mesh whose rows span processes raises."""
        if self.mesh.shape["rows"] == 1:
            return [(c * self.local_k, t)
                    for c, t in enumerate(self.shards[0]) if t is not None]
        if self._stacked is None:
            cols = self.mesh.shape["cols"]
            held = [[row[c] is not None for row in self.shards]
                    for c in range(cols)]
            if any(any(h) and not all(h) for h in held):
                raise ValueError(
                    "the engines that walk column shards need every row "
                    "shard of a column in one process; this mesh's rows "
                    "span processes (use a columns-only mesh or the scan "
                    "engine)")
            self._stacked = [
                (c * self.local_k, torch.cat(
                    [row[c].to(self.shards[0][c].device)
                     for row in self.shards])[:self.n_words].contiguous())
                for c in range(cols) if all(held[c])]
        return self._stacked

    def colsum(self, masks):
        """Masked column sums, the ``popcount_colsum`` kernel once a local
        shard: masks (C, W') int32 on any device, W' at most the padded
        word count. Returns (C, K padded) int32 on this process's first
        device, the same on every process: each column's sums added over
        its row shards, the column shards side by side."""
        masks = torch.nn.functional.pad(masks, (0, self.shape[0]
                                                - masks.shape[1]))
        lw, lk = self.local_w, self.local_k
        parts = {}  # column shard -> its sums over this process's rows
        for r, c, shard in self.local_positions():
            m = masks[:, r * lw:(r + 1) * lw]
            part = popcount_colsum(shard, m.to(shard.device).contiguous())
            part = part.to(self.device)
            parts[c] = part if c not in parts else parts[c] + part
        if not self.mesh.spans_processes:
            return torch.cat([parts[c] for c in sorted(parts)], 1)
        # The psum over rows and the all_gather over cols: every process's
        # partial sums of its columns, added up column by column.
        mine = sorted(parts)
        local = (torch.stack([parts[c] for c in mine]).cpu().numpy()
                 if mine else np.zeros((0, masks.shape[0], lk), np.int32))
        out = np.zeros((masks.shape[0], self.shape[1]), np.int64)
        owners = self.mesh.owners
        for rank, sums in enumerate(all_gather_arrays(local)):
            held = sorted({c for r, row in enumerate(owners)
                           for c, o in enumerate(row) if o == rank})
            for c, s in zip(held, sums):
                out[:, c * lk:(c + 1) * lk] += s
        return torch.from_numpy(out.astype(np.int32)).to(self.device)

    def gather_columns(self, cols, n_words=None):
        """(C,) int64 column indices (any device) -> (C, n_words) int32
        packed columns on this process's first device, the same on every
        process (``n_words``: the unpadded word count by default, at most
        the padded one). Each local shard gathers every index clamped into
        its range and zeroes the ones it does not own, into its word rows;
        the positions' words are disjoint, so their sum, over the
        processes too, is the columns (the one-hot ``psum`` of
        ``grm_tpu``)."""
        cols = cols.to(self.device, torch.int64)
        lw, lk = self.local_w, self.local_k
        out = torch.zeros((cols.shape[0], self.shape[0]), dtype=torch.int32,
                          device=self.device)
        for r, c, shard in self.local_positions():
            lo = c * lk
            own = (cols >= lo) & (cols < lo + lk)
            local = torch.clamp(cols - lo, 0, lk - 1)
            words = _gather_columns(shard, local.to(shard.device))
            out[:, r * lw:(r + 1) * lw] += torch.where(
                own[:, None], words.to(self.device), 0)
        if self.mesh.spans_processes:
            out = torch.from_numpy(all_reduce(out.cpu().numpy())).to(
                self.device)
        width = self.n_words if n_words is None else n_words
        return out[:, :width].contiguous()


class MeshSharding:
    """Places a packed matrix on ``mesh`` as a :class:`ShardedMatrix`: the
    columns over its ``cols`` axis and the word rows over its ``rows``
    axis, zero-padded to the grid; a process places only the shards of
    its own positions."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __eq__(self, other):
        return isinstance(other, MeshSharding) and self.mesh == other.mesh

    def __hash__(self):
        return hash(self.mesh)

    def __repr__(self):
        return "MeshSharding(%r)" % (self.mesh,)

    def _grid(self, n_words, k):
        rows, cols = self.mesh.shape["rows"], self.mesh.shape["cols"]
        return -(-max(n_words, 1) // rows), -(-max(k, 1) // cols)

    def _place(self, n_words, k, take):
        """Each column with a local position: ``take(a, b, lo, hi, dev)``,
        words [a, b) of columns [lo, hi) on ``dev`` as an int32 tensor,
        once over the word rows of the column's local positions, cut into
        those positions' shards, each padded to (lw, lk) on its device."""
        lw, lk = self._grid(n_words, k)
        mesh = self.mesh
        if mesh.spans_processes:
            check_agreement("the matrix's shape and the mesh", n_words, k,
                            mesh._key())
        grid = [[None] * mesh.shape["cols"] for _ in mesh.devices]
        for c in range(mesh.shape["cols"]):
            rows = [r for r in range(mesh.shape["rows"])
                    if mesh.is_local(r, c)]
            if not rows:
                continue
            lo, hi = min(c * lk, k), min((c + 1) * lk, k)
            a = min(rows[0] * lw, n_words)
            b = min((rows[-1] + 1) * lw, n_words)
            column = take(a, b, lo, hi, mesh.devices[rows[0]][c])
            for r in rows:
                part = column[min(r * lw, n_words) - a:
                              min((r + 1) * lw, n_words) - a]
                grid[r][c] = _padded(part.to(mesh.devices[r][c]), lw, lk)
            del column
        return ShardedMatrix(grid, mesh, n_words, (lw, lk))

    def place(self, packed):
        """(W, K) uint32 numpy, or int32 tensor, -> ShardedMatrix."""
        if isinstance(packed, torch.Tensor):
            if packed.dtype != torch.int32 or packed.dim() != 2:
                raise ValueError("expected a 2-D int32 tensor of packed words")
            take = lambda a, b, lo, hi, dev: packed[a:b, lo:hi].to(dev)
        else:
            packed = np.asarray(packed)
            if packed.dtype != np.uint32 or packed.ndim != 2:
                raise ValueError("expected a 2-D uint32-packed matrix")
            take = lambda a, b, lo, hi, dev: masks_to_tensor(
                packed[a:b, lo:hi], dev)
        return self._place(*packed.shape, take)

    def place_u64(self, m64, n_words):
        """The first ``n_words`` word rows of the uint64 MSB-first matrix
        ``m64`` (a numpy array, a memory map or an h5py dataset: anything
        sliced ``m64[rows, cols]``), split on the card shard by shard: the
        word rows of each column's local positions go through ``split_u64``
        (the pinned staging ring and ``deinterleave_u64``) straight to
        their device. Only those rows and columns of ``m64`` are read, and
        the unsharded matrix is never materialised beside the shards."""

        def take(a, b, lo, hi, dev):
            u0, u1 = a // 2, -(-b // 2)  # word 2u: uint64 row u's high half
            words = (m64[u0:u1, lo:hi] if hi > lo
                     else np.zeros((u1 - u0, 0), np.uint64))
            return split_u64(words, b - 2 * u0, dev)[a - 2 * u0:]

        return self._place(n_words, m64.shape[1], take)


def mesh_sharding(mesh):
    """The MeshSharding that places the k-mer columns over ``mesh``, or
    None for no mesh."""
    return None if mesh is None else MeshSharding(mesh)


def shard_bit_matrix(packed_u32, mesh):
    """Place a (W, K) uint32 matrix on the mesh, padded to the shard grid.

    Returns (ShardedMatrix, original K). Rows are padded to the row-shard
    multiple, columns to the column-shard multiple.
    """
    packed_u32 = np.asarray(packed_u32, dtype=np.uint32)
    return MeshSharding(mesh).place(packed_u32), packed_u32.shape[1]


def sharded_presence_counts(matrix_sharded, masks, mesh=None):
    """Multi-mask popcount column sweep over the sharded matrix.

    masks: (C, W_padded) uint32 host array. Returns (C, K_padded) int32 on
    the host: one ``popcount_colsum`` launch a shard, the row shards'
    sums added (the ``psum`` over ``rows``), the column shards
    concatenated.
    """
    masks = masks_to_tensor(np.asarray(masks, dtype=np.uint32),
                            matrix_sharded.device)
    return matrix_sharded.colsum(masks).cpu().numpy()


def column_shards(matrix):
    """[(first column, (W, width) int32 tensor)] in ascending column order:
    a resident matrix is one shard at column 0, a ShardedMatrix its column
    shards. The engines walk this one list whatever the matrix."""
    if isinstance(matrix, ShardedMatrix):
        return matrix.column_shards()
    return [(0, matrix)]


def shard_limit(n_kmers, lo, shard):
    """The count of real k-mer columns of the shard at column ``lo``: the
    kernels' column limit."""
    return min(max(n_kmers - lo, 0), shard.shape[1])


def spans_processes(matrix):
    """Whether ``matrix`` is a ShardedMatrix on a mesh that spans
    processes: its engines' combines then exchange across them."""
    return isinstance(matrix, ShardedMatrix) and matrix.mesh.spans_processes


def combine_winners(matrix, first, vals, cols, better):
    """The processes' winners of a sweep over ``matrix``, combined as a
    process combines its shards': each process's ``vals`` (float32) and
    ``cols`` (int64, global columns), tensors of one shape, are folded in
    the order of the first columns they swept (``first``; None where a
    process swept nothing), a later one replacing the best only where
    ``better`` (``np.greater`` or ``np.less``) holds strictly, so the lowest
    global column wins ties. Returns (vals, cols) on the matrix's (first)
    device, the same on every process; where the matrix does not span
    processes, ``vals`` and ``cols`` themselves."""
    if not spans_processes(matrix):
        return vals, cols
    v = vals.cpu().numpy().astype(np.float32)
    c = cols.cpu().numpy().astype(np.int64)
    head = np.array([-1 if first is None else first], np.int64)
    blob = np.concatenate([head.view(np.uint8), v.view(np.uint8).ravel(),
                           c.view(np.uint8).ravel()])
    entries = []
    for part in all_gather_fixed(blob):
        lo = int(part[:8].view(np.int64)[0])
        if lo >= 0:
            entries.append((lo, part[8:8 + v.nbytes].view(np.float32)
                            .reshape(v.shape),
                            part[8 + v.nbytes:].view(np.int64)
                            .reshape(c.shape)))
    entries.sort(key=lambda e: e[0])
    _, best_v, best_c = entries[0]
    for _, pv, pc in entries[1:]:
        take = better(pv, best_v)
        best_v = np.where(take, pv, best_v)
        best_c = np.where(take, pc, best_c)
    dev = matrix.device
    return torch.from_numpy(best_v).to(dev), torch.from_numpy(best_c).to(dev)


def _colsum(matrix, masks):
    if isinstance(matrix, ShardedMatrix):
        return matrix.colsum(masks)
    return popcount_colsum(matrix, masks)


def _columns(matrix, cols, n_words=None):
    """(C,) column indices -> (C, n_words) packed columns on the matrix's
    (first) device (a ShardedMatrix's padded word rows up to ``n_words``)."""
    if isinstance(matrix, ShardedMatrix):
        return matrix.gather_columns(cols, n_words)
    return _gather_columns(matrix, cols)


def _counts_and_totals(matrix, pos_mask, neg_mask):
    counts = _colsum(matrix, torch.stack([neg_mask, pos_mask]))
    return (counts[0], counts[1], popcount_rows(neg_mask),
            popcount_rows(pos_mask))


def _scm_step(matrix, pos_mask, neg_mask, p, n_kmers):
    """One SCM iteration over the 2 Kp rule space: the argmax of the
    concatenated presence and absence utilities, padded columns and rules
    that cover nothing and err on nothing at -inf. ``matrix``: a (W, Kp)
    int32 tensor or a ShardedMatrix; the masks (W,) int32 tensors on its
    (first) device. Returns (best rule index in the unpadded 2K space, its
    float32 utility, new_pos, new_neg, n_neg_left)."""
    dev = matrix.device
    cn, cp, n_neg, n_pos = _counts_and_totals(matrix, pos_mask, neg_mask)
    kp = matrix.shape[1]
    col_is_pad = torch.arange(kp, device=dev) >= n_kmers
    neg_cover = torch.cat([n_neg - cn, cn])
    pos_err = torch.cat([n_pos - cp, cp])
    utility = neg_cover.float() - float(np.float32(p)) * pos_err.float()
    utility = torch.where(torch.cat([col_is_pad, col_is_pad]), -torch.inf,
                          utility)
    utility = torch.where((neg_cover == 0) & (pos_err == 0), -torch.inf,
                          utility)
    best = utility.argmax()
    best_col = best % kp
    is_absence = best >= kp
    col = _columns(matrix, best_col.view(1), pos_mask.shape[-1])[0]
    rule_bits = torch.where(is_absence, ~col, col)
    new_neg = neg_mask & rule_bits
    new_pos = pos_mask & rule_bits
    best_unpadded = torch.where(is_absence, best_col + n_kmers, best_col)
    return (best_unpadded, utility[best], new_pos, new_neg,
            popcount_rows(new_neg))


def scm_device_step(matrix_sharded, pos_mask, neg_mask, p, n_kmers,
                    mesh=None):
    """Run one fused SCM iteration (:func:`_scm_step`) on a ShardedMatrix or
    a (W, Kp) int32 tensor; pos_mask / neg_mask: (W,) uint32 numpy or int32
    tensors. Returns tensors on the matrix's (first) device."""
    dev = matrix_sharded.device
    return _scm_step(matrix_sharded, _as_mask(pos_mask, dev),
                     _as_mask(neg_mask, dev), p, n_kmers)


def _as_mask(mask, dev):
    if isinstance(mask, torch.Tensor):
        return mask.to(dev)
    return masks_to_tensor(np.asarray(mask, dtype=np.uint32), dev)


def _scm_iteration(matrix, pos_mask, neg_mask, p, n_kmers):
    """One greedy step: (best_rule, new_pos, new_neg, n_neg_left), tensors.

    ``matrix``: a (W, K) int32 tensor or a ShardedMatrix (counted shard by
    shard; the winning column is the row shards' words for it, stacked).
    """
    cn, cp, n_neg, n_pos = _counts_and_totals(matrix, pos_mask, neg_mask)

    col_is_pad = torch.arange(matrix.shape[1], device=matrix.device) >= n_kmers
    # presence half: cover = n_neg - cn, err = n_pos - cp
    u_pres = (n_neg - cn).float() - p * (n_pos - cp).float()
    u_pres = torch.where(col_is_pad | ((cn == n_neg) & (cp == n_pos)),
                         -torch.inf, u_pres)
    # absence half: cover = cn, err = cp
    u_abs = cn.float() - p * cp.float()
    u_abs = torch.where(col_is_pad | ((cn == 0) & (cp == 0)), -torch.inf,
                        u_abs)

    best_pres = u_pres.argmax()
    best_abs = u_abs.argmax()
    # argmax-over-concat semantics: presence wins ties.
    use_abs = u_abs[best_abs] > u_pres[best_pres]
    best_col = torch.where(use_abs, best_abs, best_pres)

    col = _columns(matrix, best_col.view(1), pos_mask.shape[-1])[0]
    rule_bits = torch.where(use_abs, ~col, col)
    new_pos = pos_mask & rule_bits
    new_neg = neg_mask & rule_bits
    best_rule = torch.where(use_abs, best_col + n_kmers, best_col)
    return best_rule, new_pos, new_neg, popcount_rows(new_neg)


def scm_fit_batch_device(matrix, pos_masks, neg_masks, ps, n_kmers,
                         max_rules):
    """Fit a batch of SCMs greedily, one fit after another.

    matrix: (W, K) int32 packed presence, or a ShardedMatrix;
    pos_masks/neg_masks: (F, W) int32 per-fit example masks (disjunction
    fits pre-swapped) on the matrix's (first) device; ps: (F,) float32.
    Returns numpy (rules (F, max_rules) int32 with -1 for unused slots,
    n_rules (F,) int32, n_neg_left (F,) int32).
    """
    f = pos_masks.shape[0]
    rules = np.full((f, max_rules), -1, np.int32)
    n_rules = np.zeros(f, np.int32)
    n_neg_left = np.zeros(f, np.int32)
    for i in range(f):
        pos, neg, p = pos_masks[i], neg_masks[i], ps[i]
        n_neg = int(popcount_rows(neg))
        step = 0
        while step < max_rules and n_neg > 0:
            best_rule, pos, neg, n_neg_t = _scm_iteration(
                matrix, pos, neg, p, n_kmers)
            rules[i, step] = int(best_rule)
            n_neg = int(n_neg_t)
            step += 1
        n_rules[i] = step
        n_neg_left[i] = n_neg
    return rules, n_rules, n_neg_left
