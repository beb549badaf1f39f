"""Iteration-major SCM CV grid engine (the "device-argmax" engine's CV):
each greedy iteration makes one pass over the packed matrix and scores
every fit at once.

Port of ``grm_tpu/parallel/scm_grid.py``. The sweep is the ``scm_sweep``
kernel's argmax epilogue with its torch phase 2
(:func:`grm_tpu_torch.ops.scm_sweep.scm_utility_argmax`). That epilogue
takes the rule-exclusion mask (the k-mer blacklist), so one kernel serves
both of the JAX engine's sweeps (the XLA block scan and the Pallas kernel).

A matrix whose columns are sharded over a mesh's ``cols`` axis runs the
same iterations: the sweep walks the column shards (a resident matrix is
one), each on its own device with the shard's count of real columns as the
kernel's column limit, the per-shard winners come to the first device, and
per fit and half the first shard at the maximum wins (shards ascend by
column, so the lowest global column wins ties, presence beating absence as
unsharded); the winning column comes from its owner shard.
:func:`scm_cv_grid_sharded` is ``grm_tpu``'s name for it. On a mesh that
spans processes each process sweeps its own shards, one gather a sweep
brings every process's winners to all of them, and they fold by the same
rule; every process then holds the same fit state, checked first
(``check_agreement``) to start from the same fits.

Selection semantics match the JAX engine exactly under exact float32
arithmetic: pure argmax utility (no isclose tie sets), ties to the lowest
block then the lowest column, presence beats absence on equal utility,
rules that cover nothing and err on nothing excluded. Per-length fold-test
risks come from packed prediction masks in float32, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.popcount import masks_to_tensor, popcount_rows
from ..ops.scm_sweep import scm_utility_argmax
from .distributed import check_agreement
from .mesh import (MeshSharding, ShardedMatrix, _columns, column_shards,
                   combine_winners, shard_limit, spans_processes)

__all__ = ["scm_cv_grid_device", "scm_cv_grid_sharded"]


def _fold_risks(conj, tpos, tneg, n_tpos, n_tneg, is_disj):
    """Fold-test risk (F,) float32 of the current conjunction masks (F, W)."""
    pos_pred1 = popcount_rows(tpos & conj).float()
    neg_pred1 = popcount_rows(tneg & conj).float()
    n_test = torch.clamp(n_tpos + n_tneg, min=1.0)
    conj_errors = (n_tpos - pos_pred1) + neg_pred1
    disj_errors = pos_pred1 + (n_tneg - neg_pred1)
    return torch.where(is_disj, disj_errors, conj_errors) / n_test


def _apply_rule(state, bits, use_abs, best_col, step_i, n_kmers):
    """Advance the fit state with the chosen rules' packed columns ``bits``
    (F, W), already inverted for absence rules. Updates ``state`` in place
    and returns it."""
    act = state["active"][:, None]
    for name in ("pos", "neg", "conj"):
        state[name] = torch.where(act, state[name] & bits, state[name])
    active = state["active"]
    best_rule = torch.where(use_abs, best_col + n_kmers, best_col)
    state["rules"][:, step_i] = torch.where(active, best_rule, -1).to(
        torch.int32)
    risk = _fold_risks(state["conj"], state["tpos"], state["tneg"],
                       state["n_tpos"], state["n_tneg"], state["is_disj"])
    # Inactive fits carry their last risk forward (the reference duplicates
    # the final element, experiment_scm.py:180-181).
    prev = state["risks"][:, step_i]
    state["risks"][:, step_i + 1] = torch.where(active, risk, prev)
    state["n_rules"] += active.to(torch.int32)
    state["active"] = active & (popcount_rows(state["neg"]) > 0)
    return state


def _sweep(matrix, args, n_kmers, excl):
    """``scm_utility_argmax`` on each local column shard of ``matrix`` (a
    resident matrix is one), combined on its (first) device: per fit and
    half the first shard at the maximum, its column made global in int64;
    then, on a mesh that spans processes, the processes' winners the same
    way (:func:`~grm_tpu_torch.parallel.mesh.combine_winners`). ``excl``:
    one (2, width) mask or None a local shard. A later shard of padding
    only is skipped: its winners would be -inf."""
    best = first = None
    for (lo, shard), shard_excl in zip(column_shards(matrix), excl):
        limit = shard_limit(n_kmers, lo, shard)
        if lo and limit == 0:
            continue
        dev = shard.device
        bpu, bpi, bau, bai = (t.to(matrix.device) for t in scm_utility_argmax(
            shard, *[a.to(dev) for a in args], limit, excl=shard_excl))
        bpi, bai = bpi.to(torch.int64) + lo, bai.to(torch.int64) + lo
        if best is None:
            best, first = [bpu, bpi, bau, bai], lo
            continue
        take_p, take_a = bpu > best[0], bau > best[2]
        best = [torch.where(take_p, bpu, best[0]),
                torch.where(take_p, bpi, best[1]),
                torch.where(take_a, bau, best[2]),
                torch.where(take_a, bai, best[3])]
    if best is None:  # every local shard is padding: nothing to offer
        f = args[0].shape[0]
        best = [torch.zeros(f, device=matrix.device),
                torch.zeros(f, dtype=torch.int64, device=matrix.device)] * 2
    vals, cols = combine_winners(matrix, first,
                                 torch.stack([best[0], best[2]]),
                                 torch.stack([best[1], best[3]]), np.greater)
    return [vals[0], cols[0], vals[1], cols[1]]


def _grid_step(matrix, state, step_i, n_kmers, excl):
    """One greedy SCM iteration for all fits: one pass over the matrix."""
    n_neg = popcount_rows(state["neg"]).to(torch.int32)
    n_pos = popcount_rows(state["pos"]).to(torch.int32)
    args = (state["neg"], state["pos"], n_neg, n_pos, state["ps"])
    bpu, bpi, bau, bai = _sweep(matrix, args, n_kmers, excl)
    # Presence wins ties against absence (argmax-over-concat semantics).
    use_abs = bau > bpu
    best_col = torch.where(use_abs, bai, bpi)
    packed = _columns(matrix, best_col, state["pos"].shape[1])
    bits = torch.where(use_abs[:, None], ~packed, packed)
    return _apply_rule(state, bits, use_abs, best_col, step_i, n_kmers)


def _build_fit_arrays(fits):
    """Fit-state arrays in numpy."""
    pos = np.stack([f["pos_mask"] for f in fits])
    neg = np.stack([f["neg_mask"] for f in fits])
    tpos = np.stack([f["test_pos_mask"] for f in fits])
    tneg = np.stack([f["test_neg_mask"] for f in fits])
    ps = np.array([f["p"] for f in fits], np.float32)
    is_disj = np.array(
        [f["model_type"] == "disjunction" for f in fits], bool
    )
    return pos, neg, tpos, tneg, ps, is_disj


def _init_state(pos, neg, tpos, tneg, is_disj, n_fits, max_rules):
    """Initial fit state in numpy.

    The empty model predicts all 1 (conj mask all-ones), so the length-0
    risk reduces to n_tneg/n_test (conjunction) or n_tpos/n_test
    (disjunction) — float32, matching :func:`_fold_risks` exactly.
    """
    n_tpos = np.bitwise_count(tpos).sum(-1).astype(np.float32)
    n_tneg = np.bitwise_count(tneg).sum(-1).astype(np.float32)
    conj = np.full_like(pos, np.uint32(0xFFFFFFFF))
    rules = np.full((n_fits, max_rules), -1, np.int32)
    risks = np.zeros((n_fits, max_rules + 1), np.float32)
    n_test = np.maximum(n_tpos + n_tneg, np.float32(1.0))
    risks[:, 0] = np.where(is_disj, n_tpos, n_tneg) / n_test
    n_rules = np.zeros((n_fits,), np.int32)
    active = np.bitwise_count(neg).sum(-1) > 0
    return conj, rules, risks, n_rules, active, n_tpos, n_tneg


def scm_cv_grid_device(matrix, fits, n_kmers, max_rules, excl_rules=None):
    """Run the batched CV fits, iteration-major, on the matrix's device.

    ``matrix``: (W, K) int32 packed presence tensor, or a
    :class:`~grm_tpu_torch.parallel.mesh.ShardedMatrix` of one row of
    devices, swept shard by shard. ``fits``: list of dicts with keys
    pos_mask, neg_mask, test_pos_mask, test_neg_mask (numpy uint32 (W,)), p
    (float), model_type (str). ``excl_rules`` (optional int array, values
    in [0, 2K)): blacklisted rules (presence idx k, absence idx k +
    n_kmers) excluded from selection (experiment_scm.py:632-671); the
    exclusion mask shards with the columns. Returns numpy (rules (F,
    max_rules) int32 [-1 pad], n_rules (F,) int32, risks (F, max_rules+1)
    float32).
    """
    if isinstance(matrix, ShardedMatrix):
        if matrix.mesh.shape["rows"] != 1:
            raise ValueError(
                "scm_cv_grid_sharded shards columns only; use the scan "
                "engine for row-sharded matrices"
            )
    elif matrix.dtype != torch.int32 or matrix.dim() != 2:
        raise ValueError("grid engine expects a (W, K) int32 packed matrix")
    if spans_processes(matrix):
        check_agreement(
            "the CV grid's fits, K, rule budget, matrix shape and blacklist",
            *_build_fit_arrays(fits), n_kmers, max_rules, matrix.shape,
            None if excl_rules is None else np.asarray(excl_rules, np.int64))
    excl = _excl_mask(excl_rules, n_kmers, matrix.shape[1])
    excl = [None if excl is None else torch.from_numpy(np.ascontiguousarray(
        excl[:, lo:lo + shard.shape[1]])).to(shard.device)
        for lo, shard in column_shards(matrix)]
    return _run_grid(matrix, fits, n_kmers, max_rules, excl)


def scm_cv_grid_sharded(matrix, fits, n_kmers, max_rules, mesh,
                        excl_rules=None):
    """Column-sharded CV grid engine over a ("rows", "cols") mesh
    (``grm_tpu``'s name): :func:`scm_cv_grid_device` on ``matrix`` placed
    on ``mesh``. ``matrix``: a ShardedMatrix on ``mesh``, or a (W, K)
    uint32 array or int32 tensor, which is placed on it. Requires an
    unsharded word-row axis (``rows`` size 1): row-sharded matrices take the
    scan engine.
    """
    if not (isinstance(matrix, ShardedMatrix) and matrix.mesh == mesh):
        matrix = MeshSharding(mesh).place(matrix)
    return scm_cv_grid_device(matrix, fits, n_kmers, max_rules, excl_rules)


def _excl_mask(excl_rules, n_kmers, width):
    """(2, width) uint8 numpy exclusion mask of a blacklist, or None."""
    if excl_rules is None or not len(excl_rules):
        return None
    excl = np.zeros((2, width), np.uint8)
    er = np.asarray(excl_rules, np.int64)
    excl[0, er[er < n_kmers]] = 1
    excl[1, er[er >= n_kmers] - n_kmers] = 1
    return excl


def _run_grid(matrix, fits, n_kmers, max_rules, excl):
    dev = matrix.device
    pos, neg, tpos, tneg, ps, is_disj = _build_fit_arrays(fits)
    n_fits = len(fits)
    conj, rules, risks, n_rules, active, n_tpos, n_tneg = _init_state(
        pos, neg, tpos, tneg, is_disj, n_fits, max_rules
    )
    state = {
        "pos": masks_to_tensor(pos, dev), "neg": masks_to_tensor(neg, dev),
        "conj": masks_to_tensor(conj, dev),
        "tpos": masks_to_tensor(tpos, dev), "tneg": masks_to_tensor(tneg, dev),
        "rules": torch.from_numpy(rules).to(dev),
        "risks": torch.from_numpy(risks).to(dev),
        "n_rules": torch.from_numpy(n_rules).to(dev),
        "active": torch.from_numpy(active).to(dev),
        "n_tpos": torch.from_numpy(n_tpos).to(dev),
        "n_tneg": torch.from_numpy(n_tneg).to(dev),
        "ps": torch.from_numpy(ps).to(dev),
        "is_disj": torch.from_numpy(is_disj).to(dev),
    }
    for step in range(max_rules):
        if not bool(state["active"].any()):
            # Every fit has stopped: the remaining lengths repeat the last
            # risk, as the JAX engine's no-op iterations do.
            state["risks"][:, step + 1:] = state["risks"][:, step:step + 1]
            break
        state = _grid_step(matrix, state, step, n_kmers, excl)
    return (state["rules"].cpu().numpy(), state["n_rules"].cpu().numpy(),
            state["risks"].cpu().numpy())
