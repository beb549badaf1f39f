"""Device-mesh sharding for the bit matrix and the argmax engine's fit (the
port of ``grm_tpu/parallel/mesh.py``).

A :class:`Mesh` is one process's ``("rows", "cols")`` grid of torch
devices, as ``grm_tpu``'s single-controller mesh is a grid of
``jax.devices()``: genome word rows are the data-parallel axis, k-mer
columns the feature-parallel one (the reference's 43M-column "long
axis"). A matrix placed on a mesh is a :class:`ShardedMatrix`: a grid of
int32 tensors, shard ``(r, c)`` on ``mesh.devices[r][c]``, padded with zero
words and zero columns to the grid (as ``shard_bit_matrix`` pads).

Where ``grm_tpu`` lets XLA insert the collectives, the port runs each
shard's kernel on its own device and moves the small per-shard results
with ``.to()``: the column sums of the row shards add up on the mesh's
first device (the ``psum`` over ``rows``), the column shards' results
concatenate in ascending column order (the ``all_gather`` over ``cols``),
and a winning column is the owner shard's words, the other shards giving
zero words that an OR combines. ``.to()`` orders each copy after the work
queued on the current streams of both devices, so no stream waits are
written here. No ``torch.distributed`` call is made: one process drives
every device of its mesh. A mesh may name one device more than once; its
shards then share that device (tests and one-card runs).

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

__all__ = [
    "Mesh",
    "MeshSharding",
    "ShardedMatrix",
    "check_mesh",
    "column_shards",
    "make_mesh",
    "mesh_sharding",
    "shard_bit_matrix",
    "sharded_presence_counts",
    "scm_device_step",
    "scm_fit_batch_device",
    "pad_columns",
    "shard_limit",
]


class Mesh:
    """A ``(rows, cols)`` grid of torch devices. ``shape`` is
    ``{"rows": r, "cols": c}``, as a JAX mesh's; ``devices[r][c]`` is a
    ``torch.device``; ``device`` is the first, where combines land."""

    axis_names = ("rows", "cols")

    def __init__(self, devices):
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(r) != len(grid[0])
                                          for r in grid):
            raise ValueError("a mesh is a non-empty rectangular grid of "
                             "devices")
        self.devices = grid
        self.shape = {"rows": len(grid), "cols": len(grid[0])}
        self.device = grid[0][0]

    @property
    def size(self):
        return self.shape["rows"] * self.shape["cols"]

    def _key(self):
        return tuple(tuple(str(d) for d in row) for row in self.devices)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return "Mesh(%s)" % (self._key(),)


def make_mesh(n_devices=None, row_devices=1, devices=None):
    """Build a ("rows", "cols") mesh over the available devices.

    ``row_devices`` devices shard the genome word rows (data parallel); the
    rest shard the k-mer columns (feature parallel). ``devices`` defaults
    to every visible CUDA device and may repeat a device.
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 0 < n_devices <= len(devices):
        raise ValueError("a mesh of %d devices needs that many; %d given"
                         % (n_devices, len(devices)))
    if n_devices % row_devices != 0:
        raise ValueError("row_devices must divide n_devices")
    cols = n_devices // row_devices
    return Mesh([devices[r * cols:(r + 1) * cols]
                 for r in range(row_devices)])


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
    ``[c lk, (c + 1) lk)`` on ``mesh.devices[r][c]``. ``n_words`` is the
    unpadded word count; ``shape`` the padded grid's."""

    def __init__(self, shards, mesh, n_words):
        self.shards = shards
        self.mesh = mesh
        self.local_w, self.local_k = shards[0][0].shape
        self.shape = (self.local_w * mesh.shape["rows"],
                      self.local_k * mesh.shape["cols"])
        self.n_words = int(n_words)
        self.device = mesh.device
        self.dtype = torch.int32
        self._stacked = None

    def column_shards(self):
        """[(first column, (W, lk) tensor)] in ascending column order. On a
        mesh of one row these are the shards; on one of several rows each
        column's row shards are stacked on the first row's device, once."""
        if self.mesh.shape["rows"] == 1:
            return [(c * self.local_k, t)
                    for c, t in enumerate(self.shards[0])]
        if self._stacked is None:
            self._stacked = [
                (c * self.local_k, torch.cat(
                    [row[c].to(self.shards[0][c].device)
                     for row in self.shards])[:self.n_words].contiguous())
                for c in range(self.mesh.shape["cols"])]
        return self._stacked

    def colsum(self, masks):
        """Masked column sums, the ``popcount_colsum`` kernel once a shard:
        masks (C, W') int32 on any device, W' at most the padded word
        count. Returns (C, K padded) int32 on the mesh's first device: each
        column's sums added over the row shards, the column shards side by
        side."""
        masks = torch.nn.functional.pad(masks, (0, self.shape[0]
                                                - masks.shape[1]))
        parts = []
        for ci in range(self.mesh.shape["cols"]):
            total = None
            for ri, row in enumerate(self.shards):
                shard = row[ci]
                m = masks[:, ri * self.local_w:(ri + 1) * self.local_w]
                part = popcount_colsum(shard, m.to(shard.device).contiguous())
                part = part.to(self.device)
                total = part if total is None else total + part
            parts.append(total)
        return torch.cat(parts, 1)

    def gather_columns(self, cols, n_words=None):
        """(C,) int64 column indices (any device) -> (C, n_words) int32
        packed columns on the first device (``n_words``: the unpadded word
        count by default, at most the padded one). Each column shard
        gathers every index clamped into its range and zeroes the ones it
        does not own; the shards' words OR together (the one-hot ``psum``
        of ``grm_tpu``)."""
        cols = cols.to(self.device, torch.int64)
        rows = []
        for row in self.shards:
            acc = None
            for ci, shard in enumerate(row):
                lo = ci * self.local_k
                own = (cols >= lo) & (cols < lo + self.local_k)
                local = torch.clamp(cols - lo, 0, self.local_k - 1)
                words = _gather_columns(shard, local.to(shard.device))
                words = torch.where(own[:, None], words.to(self.device), 0)
                acc = words if acc is None else acc | words
            rows.append(acc)
        width = self.n_words if n_words is None else n_words
        return torch.cat(rows, 1)[:, :width].contiguous()


class MeshSharding:
    """Places a packed matrix on ``mesh`` as a :class:`ShardedMatrix`: the
    columns over its ``cols`` axis and the word rows over its ``rows``
    axis, zero-padded to the grid."""

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

    def _split_rows(self, column, lw, lk, c):
        """One column shard's (n_words, width) tensor cut into its row
        shards, each padded to (lw, lk) on its own device."""
        out = []
        for r, row in enumerate(self.mesh.devices):
            part = column[r * lw:(r + 1) * lw]
            out.append(_padded(part.to(row[c]), lw, lk))
        return out

    def place(self, packed):
        """(W, K) uint32 numpy, or int32 tensor, -> ShardedMatrix."""
        if isinstance(packed, torch.Tensor):
            if packed.dtype != torch.int32 or packed.dim() != 2:
                raise ValueError("expected a 2-D int32 tensor of packed words")
            take = lambda lo, hi, dev: packed[:, lo:hi].to(dev)
        else:
            packed = np.asarray(packed)
            if packed.dtype != np.uint32 or packed.ndim != 2:
                raise ValueError("expected a 2-D uint32-packed matrix")
            take = lambda lo, hi, dev: masks_to_tensor(packed[:, lo:hi], dev)
        n_words, k = packed.shape
        lw, lk = self._grid(n_words, k)
        grid = [[None] * self.mesh.shape["cols"] for _ in self.mesh.devices]
        for c in range(self.mesh.shape["cols"]):
            column = take(min(c * lk, k), min((c + 1) * lk, k),
                          self.mesh.devices[0][c])
            for r, shard in enumerate(self._split_rows(column, lw, lk, c)):
                grid[r][c] = shard
        return ShardedMatrix(grid, self.mesh, n_words)

    def place_u64(self, m64, n_words):
        """The first ``n_words`` word rows of the uint64 MSB-first matrix
        ``m64``, split on the card shard by shard: each column shard's
        range goes through ``split_u64`` (the pinned staging ring and
        ``deinterleave_u64``) straight to its device, so the unsharded
        matrix is never materialised beside the shards."""
        m64 = np.asarray(m64)
        k = m64.shape[1]
        lw, lk = self._grid(n_words, k)
        grid = [[None] * self.mesh.shape["cols"] for _ in self.mesh.devices]
        for c in range(self.mesh.shape["cols"]):
            lo, hi = min(c * lk, k), min((c + 1) * lk, k)
            column = split_u64(m64[:, lo:hi], n_words,
                               self.mesh.devices[0][c])
            for r, shard in enumerate(self._split_rows(column, lw, lk, c)):
                grid[r][c] = shard
            del column
        return ShardedMatrix(grid, self.mesh, n_words)


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
