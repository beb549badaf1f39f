"""The SCM utility sweep: masked presence counts for F fits at once, reduced
to small per-block results inside one kernel.

Port of ``grm_tpu/ops/pallas_scm_sweep.py`` (and of the core of the exact
engine's XLA ``_pass1``). One CUDA kernel, ``csrc/scm_sweep.cu``, counts
``(cn, cp) = matrix AND-POPC masks`` as a 1-bit matrix product on the
tensor cores (``csrc/bmma_tile.cuh``), with two epilogues:

- :func:`scm_sweep_argmax_blocks` (phase 1 of the argmax engine): per block
  of columns and fit, the min of ``u_min`` and the max of ``u_max`` over
  ``u_abs = cn - p * cp`` (the affine-complement trick: the presence utility
  is ``C_f - u_abs``), with rules that cover nothing, excluded rules and
  columns past ``limit`` masked to +-float32 max;
- :func:`scm_sweep_sbmax` (pass 1 of the exact engine): per fit and
  superblock, ``max(u_pres, u_abs)``, -inf on padding and excluded rules.

The kernel reads the fits' masks as the product's B operand, 4 fits x (neg,
pos) to a tile, packed in fragment order by ``ops/tiles.py``'s
``pack_mask_tiles``. It has two builds. Up to 512 genomes (16 words) a
pass keeps 32 groups of 4 fits in registers and a grid row keeps its
groups' masks in shared memory. Past 512 genomes (the deep build) a block
keeps up to 32 groups' masks in shared memory for the whole launch, 4
groups a consumer warp, and a producer warp streams the block's columns
through a ring of shared-memory stages by cp.async: each matrix word is
read from device memory once a launch, and every product takes its
operands from shared memory. Groups past one block go to grid rows, each
of which reads the matrix again (:func:`sweep_plan`).

:func:`scm_utility_argmax` adds phase 2 (``pallas_scm_sweep.py:290-336``)
in torch: the first-occurrence argmin/argmax over blocks, then the winner
block recounted with the pair-batched popcount kernel and scored with the
direct utility formulas.

Every wrapper launches the kernel for a CUDA tensor and runs the plain
PyTorch version (same float32 operations in the same order) for a CPU one.
The fit masks are (F, W) int32 packed words; n_neg/n_pos (F,) int32 counts;
ps (F,) float32; excl an optional (2, K) uint8 mask (row 0 presence rules,
row 1 absence rules).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .popcount import _check_matrix, _stream, popcount_colsum_pairs, popcount_colsum_plain
from .tiles import TILE_LANES, TILE_NODES, pack_mask_tiles, tile_plan

__all__ = [
    "BLOCK_K",
    "scm_sweep_argmax_blocks",
    "scm_sweep_argmax_blocks_plain",
    "scm_sweep_sbmax",
    "scm_sweep_sbmax_plain",
    "scm_utility_argmax",
    "sweep_plan",
]

BLOCK_K = 4096
_F32_MAX = float(np.finfo(np.float32).max)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "grm_scm_sweep": (
        [_I, _P, _I, _L, _L, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P],
        _I),
    "grm_scm_sweep_smem_bytes": ([_I, _I], _L),
}
_SMEM_BUDGET = 64 << 10  # shallow: groups of fits past it go to grid rows
_SMEM_MAX = 227 << 10
_CHUNK_STEPS = 4  # tensor-core steps of one 16-byte load of B
_PASS_GROUPS = 32  # groups of 4 fits a pass keeps in registers
# The deep build (csrc/scm_sweep.cu's constants of the same names).
_DEEP_WARPS = 8  # consumer warps of a block
_WARP_GROUPS = 4  # groups a consumer warp keeps in registers
_DEEP_GROUPS = _DEEP_WARPS * _WARP_GROUPS  # groups a block, at most
_STAGE_BYTES = 32 * 64 * 4 + 16  # a ring stage, 32 word rows x 64 columns,
# and its two mbarriers
_MAX_STAGES, _MIN_STAGES = 8, 2
_EPI_ARGMAX, _EPI_SBMAX = 0, 1


def _deep(w):
    """Whether w words take the deep build: more than one chunk of 4
    steps (512 genomes)."""
    return tile_plan(1, 2, w)[2] > _CHUNK_STEPS


def _deep_group_bytes(w):
    """A deep block's shared memory for one group: its B fragments (8 bytes
    a lane and k256 step) and its 4 fits' constants (16 bytes each)."""
    s256 = -(-tile_plan(1, 2, w)[2] // 2)
    return 8 * TILE_LANES * s256 + 16 * TILE_NODES


def _smem_bytes(w, groups_per_row):
    """Shared memory of one block of ``csrc/scm_sweep.cu``. Shallow: the B
    fragments of its groups (16 bytes a lane and 4 steps), 16 bytes of
    constants a fit, and the reduction scratch of 8 warps x the pass's fit
    slots. Deep: the groups' B fragments and constants, then as many ring
    stages as the rest holds, up to 8."""
    if _deep(w):
        fixed = groups_per_row * _deep_group_bytes(w)
        return fixed + _STAGE_BYTES * min(
            _MAX_STAGES, (_SMEM_MAX - fixed) // _STAGE_BYTES)
    chunks = -(-tile_plan(1, 2, w)[2] // _CHUNK_STEPS)
    return (16 * TILE_LANES * groups_per_row * chunks
            + 16 * TILE_NODES * groups_per_row
            + 2 * 4 * 8 * TILE_NODES * _PASS_GROUPS)


def sweep_plan(f, w):
    """How f fits over w words go to the kernel: (groups of 4 fits a block
    keeps, grid rows, shared-memory bytes of a block).

    Each grid row reads the matrix again. Up to 16 words: a pass keeps 32
    groups in registers, and the groups of a grid row fit a 64 KB budget
    and take as many passes as they need. Past 16 words (the deep build): a
    block keeps at most 32 groups, 4 a consumer warp, their masks beside a
    ring of at least two stages, and the groups are spread evenly over the
    fewest grid rows. The shared-memory limit keeps w under ~6,700 words,
    so every count stays far below the 2^23 that the kernel's float
    conversion needs."""
    groups = tile_plan(f, 2, w)[0]
    if _deep(w):
        cap = min(_DEEP_GROUPS, (_SMEM_MAX - _MIN_STAGES * _STAGE_BYTES)
                  // _deep_group_bytes(w))
        gpr = 0
        if cap:  # the fewest rows, the groups spread evenly over them
            gpr = -(-groups // -(-groups // cap))
    else:
        gpr = groups
        while gpr > 1 and _smem_bytes(w, gpr) > _SMEM_BUDGET:
            gpr = -(-gpr // 2)
    if gpr < 1 or _smem_bytes(w, gpr) > _SMEM_MAX:
        raise ValueError("%d words of fit masks do not fit one block's "
                         "shared memory" % w)
    rows = -(-groups // gpr)
    if rows > 65535:
        raise ValueError("too many fits for one launch")
    return gpr, rows, _smem_bytes(w, gpr)


def _check_fits(matrix, neg, pos, n_neg, n_pos, ps, excl):
    _check_matrix(matrix)
    w, k = matrix.shape
    f = neg.shape[0]
    for name, t, dtype, shape in (
            ("neg", neg, torch.int32, (f, w)), ("pos", pos, torch.int32, (f, w)),
            ("n_neg", n_neg, torch.int32, (f,)),
            ("n_pos", n_pos, torch.int32, (f,)),
            ("ps", ps, torch.float32, (f,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError("%s must be %s of shape %s" % (name, dtype, shape))
        if t.device != matrix.device:
            raise ValueError("%s is not on the matrix's device" % name)
    if excl is not None and (excl.dtype != torch.uint8
                             or tuple(excl.shape) != (2, k)
                             or excl.device != matrix.device):
        raise ValueError("excl must be (2, K) uint8 on the matrix's device")


def _launch(epi, matrix, neg, pos, n_neg, n_pos, ps, limit, block, excl,
            out_a, out_b):
    w, k = matrix.shape
    f = neg.shape[0]
    gpr, _, smem = sweep_plan(f, w)
    lib = _build.library("scm_sweep", _SIGNATURES)
    if lib.grm_scm_sweep_smem_bytes(w, gpr) != smem:
        raise RuntimeError("scm_sweep: the kernel's shared-memory layout is "
                           "not the wrapper's")
    tiles = pack_mask_tiles(torch.stack([neg, pos], 1))
    # Held in locals until after the launch, so that no copy is freed early.
    args = [tiles] + [t.contiguous() for t in (n_neg, n_pos, ps)]
    excl_c = None if excl is None else excl.contiguous()
    with torch.cuda.device(matrix.device):
        _build.check(lib.grm_scm_sweep(
            epi, matrix.data_ptr(), w, k, min(int(limit), k),
            *[t.data_ptr() for t in args], f, gpr,
            None if excl_c is None else excl_c.data_ptr(), int(block),
            out_a.data_ptr(), None if out_b is None else out_b.data_ptr(),
            _stream(matrix)), "scm_sweep")


def _column_counts(matrix, neg, pos, lo, hi):
    """(cn, cp) (F, hi-lo) int32 plain counts of columns [lo, hi)."""
    counts = popcount_colsum_plain(matrix[:, lo:hi].contiguous(),
                                   torch.cat([neg, pos], 0))
    f = neg.shape[0]
    return counts[:f], counts[f:]


def _plain_chunk(matrix, block, f):
    """Columns per plain-version step: whole blocks, bounded temporaries."""
    w = matrix.shape[0]
    per_col = max(2 * f * (w + 8), 1)
    return block * max(1, (1 << 24) // (per_col * block))


def scm_sweep_argmax_blocks_plain(matrix, neg, pos, n_neg, n_pos, ps, limit,
                                  block, excl=None):
    """Plain PyTorch version of :func:`scm_sweep_argmax_blocks`."""
    k = matrix.shape[1]
    f = neg.shape[0]
    nb = -(-k // block)
    minp = torch.empty((nb, f), dtype=torch.float32, device=matrix.device)
    maxa = torch.empty((nb, f), dtype=torch.float32, device=matrix.device)
    step = _plain_chunk(matrix, block, f)
    total = (n_neg + n_pos)[:, None]
    for lo in range(0, k, step):
        hi = min(k, lo + step)
        cn, cp = _column_counts(matrix, neg, pos, lo, hi)
        u = cn.float() - ps[:, None] * cp.float()
        s = cn + cp
        cols = torch.arange(lo, hi, device=matrix.device)
        pad = (cols >= limit)[None, :]
        ex_p = ex_a = pad
        if excl is not None:
            ex_p = pad | excl[0, lo:hi].bool()[None, :]
            ex_a = pad | excl[1, lo:hi].bool()[None, :]
        u_min = torch.where((s == total) | ex_p, _F32_MAX, u)
        u_max = torch.where((s == 0) | ex_a, -_F32_MAX, u)
        n = -(-(hi - lo) // block)
        width = n * block
        u_min = torch.nn.functional.pad(u_min, (0, width - (hi - lo)),
                                        value=_F32_MAX)
        u_max = torch.nn.functional.pad(u_max, (0, width - (hi - lo)),
                                        value=-_F32_MAX)
        b0 = lo // block
        minp[b0:b0 + n] = u_min.view(f, n, block).amin(2).T
        maxa[b0:b0 + n] = u_max.view(f, n, block).amax(2).T
    return minp, maxa


def scm_sweep_argmax_blocks(matrix, neg, pos, n_neg, n_pos, ps, limit,
                            block, excl=None):
    """Phase 1 of the argmax sweep: (minp, maxa), each (NB, F) float32 with
    NB = ceil(K / block)."""
    _check_fits(matrix, neg, pos, n_neg, n_pos, ps, excl)
    if matrix.device.type != "cuda":
        return scm_sweep_argmax_blocks_plain(matrix, neg, pos, n_neg, n_pos,
                                             ps, limit, block, excl)
    nb = -(-matrix.shape[1] // block)
    f = neg.shape[0]
    minp = torch.empty((nb, f), dtype=torch.float32, device=matrix.device)
    maxa = torch.empty((nb, f), dtype=torch.float32, device=matrix.device)
    if nb and f:
        _launch(_EPI_ARGMAX, matrix, neg, pos, n_neg, n_pos, ps, limit, block,
                excl, minp, maxa)
        _build.launches["scm_sweep_argmax"] += 1
        if _deep(matrix.shape[0]):
            _build.launches["scm_sweep_deep"] += 1
    return minp, maxa


def scm_sweep_sbmax_plain(matrix, neg, pos, n_neg, n_pos, ps, limit, sb,
                          excl=None):
    """Plain PyTorch version of :func:`scm_sweep_sbmax`."""
    k = matrix.shape[1]
    f = neg.shape[0]
    nsb = -(-k // sb)
    out = torch.empty((f, nsb), dtype=torch.float32, device=matrix.device)
    step = _plain_chunk(matrix, sb, f)
    nn = n_neg.float()[:, None]
    np_ = n_pos.float()[:, None]
    pv = ps[:, None]
    for lo in range(0, k, step):
        hi = min(k, lo + step)
        cn, cp = _column_counts(matrix, neg, pos, lo, hi)
        cnf, cpf = cn.float(), cp.float()
        u_pres = (nn - cnf) - pv * (np_ - cpf)
        u_abs = cnf - pv * cpf
        cols = torch.arange(lo, hi, device=matrix.device)
        pad = (cols >= limit)[None, :]
        ex_p = ex_a = pad
        if excl is not None:
            ex_p = pad | excl[0, lo:hi].bool()[None, :]
            ex_a = pad | excl[1, lo:hi].bool()[None, :]
        u_pres = torch.where(ex_p, -torch.inf, u_pres)
        u_abs = torch.where(ex_a, -torch.inf, u_abs)
        m = torch.maximum(u_pres, u_abs)
        n = -(-(hi - lo) // sb)
        m = torch.nn.functional.pad(m, (0, n * sb - (hi - lo)),
                                    value=-torch.inf)
        out[:, lo // sb:lo // sb + n] = m.view(f, n, sb).amax(2)
    return out


def scm_sweep_sbmax(matrix, neg, pos, n_neg, n_pos, ps, limit, sb,
                    excl=None):
    """Pass 1 of the exact engine: (F, NSB) float32 per-superblock maxima of
    max(u_pres, u_abs), NSB = ceil(K / sb)."""
    _check_fits(matrix, neg, pos, n_neg, n_pos, ps, excl)
    if matrix.device.type != "cuda":
        return scm_sweep_sbmax_plain(matrix, neg, pos, n_neg, n_pos, ps,
                                     limit, sb, excl)
    nsb = -(-matrix.shape[1] // sb)
    f = neg.shape[0]
    out = torch.empty((f, nsb), dtype=torch.float32, device=matrix.device)
    if nsb and f:
        _launch(_EPI_SBMAX, matrix, neg, pos, n_neg, n_pos, ps, limit, sb,
                excl, out, None)
        _build.launches["scm_sweep_sbmax"] += 1
        if _deep(matrix.shape[0]):
            _build.launches["scm_sweep_deep"] += 1
    return out


def scm_utility_argmax(matrix, neg, pos, n_neg, n_pos, ps, n_kmers,
                       block=None, excl=None):
    """Best presence/absence utility and column per fit, one matrix pass.

    Returns (bpu, bpi, bau, bai): best presence utility and column, best
    absence utility and column, (F,) float32 / int64 tensors. Ties go to the
    lowest block, then the lowest column.
    """
    k = matrix.shape[1]
    bk = min(BLOCK_K if block is None else int(block), k)
    minp, maxa = scm_sweep_argmax_blocks(matrix, neg, pos, n_neg, n_pos, ps,
                                         n_kmers, bk, excl)
    f = neg.shape[0]
    dev = matrix.device
    pres_start = torch.clamp(minp.argmin(0) * bk, max=k - bk)
    abs_start = torch.clamp(maxa.argmax(0) * bk, max=k - bk)
    fit_masks = torch.stack([neg, pos], 1)  # (F, 2, W)
    counts = popcount_colsum_pairs(
        matrix, torch.cat([fit_masks, fit_masks], 0),
        torch.cat([pres_start, abs_start]).to(torch.int64), bk)
    nn = n_neg.float()[:, None]
    np_ = n_pos.float()[:, None]
    pv = ps[:, None]
    rows = torch.arange(f, device=dev)
    offs = torch.arange(bk, device=dev)

    def winner(start, cn, cp, presence):
        cols = start[:, None] + offs[None, :]
        cnf, cpf = cn.float(), cp.float()
        if presence:
            u = (nn - cnf) - pv * (np_ - cpf)
            bad = (cn == n_neg[:, None]) & (cp == n_pos[:, None])
        else:
            u = cnf - pv * cpf
            bad = (cn == 0) & (cp == 0)
        bad = bad | (cols >= n_kmers)
        if excl is not None:
            bad = bad | excl[0 if presence else 1][cols].bool()
        u = torch.where(bad, -torch.inf, u)
        off = u.argmax(1)
        return u[rows, off], start + off

    bpu, bpi = winner(pres_start, counts[:f, 0], counts[:f, 1], True)
    bau, bai = winner(abs_start, counts[f:, 0], counts[f:, 1], False)
    return bpu, bpi, bau, bai
