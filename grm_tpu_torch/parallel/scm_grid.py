"""Iteration-major SCM CV grid engine on one device (the "device-argmax"
engine's CV): each greedy iteration makes one pass over the packed matrix
and scores every fit at once.

Port of ``scm_cv_grid_device`` from ``grm_tpu/parallel/scm_grid.py``. The
sweep is the ``scm_sweep`` kernel's argmax epilogue with its torch phase 2
(:func:`grm_tpu_torch.ops.scm_sweep.scm_utility_argmax`). That epilogue
takes the rule-exclusion mask (the k-mer blacklist), so one kernel serves
both of the JAX engine's sweeps (the XLA block scan and the Pallas kernel).

Selection semantics match the JAX engine exactly under exact float32
arithmetic: pure argmax utility (no isclose tie sets), ties to the lowest
block then the lowest column, presence beats absence on equal utility,
rules that cover nothing and err on nothing excluded. Per-length fold-test
risks come from packed prediction masks in float32, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.popcount import _gather_columns, masks_to_tensor, popcount_rows
from ..ops.scm_sweep import scm_utility_argmax

__all__ = ["scm_cv_grid_device"]


def _fold_risks(conj, tpos, tneg, n_tpos, n_tneg, is_disj):
    """Fold-test risk (F,) float32 of the current conjunction masks (F, W)."""
    pos_pred1 = popcount_rows(tpos & conj).float()
    neg_pred1 = popcount_rows(tneg & conj).float()
    n_test = torch.clamp(n_tpos + n_tneg, min=1.0)
    conj_errors = (n_tpos - pos_pred1) + neg_pred1
    disj_errors = pos_pred1 + (n_tneg - neg_pred1)
    return torch.where(is_disj, disj_errors, conj_errors) / n_test


def _fetch_columns(matrix, cols):
    """(F,) per-fit column indices -> (F, W) packed columns."""
    return _gather_columns(matrix, cols)


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


def _grid_step(matrix, state, step_i, n_kmers, excl):
    """One greedy SCM iteration for all fits: one pass over the matrix."""
    n_neg = popcount_rows(state["neg"]).to(torch.int32)
    n_pos = popcount_rows(state["pos"]).to(torch.int32)
    bpu, bpi, bau, bai = scm_utility_argmax(
        matrix, state["neg"], state["pos"], n_neg, n_pos, state["ps"],
        n_kmers, excl=excl)
    # Presence wins ties against absence (argmax-over-concat semantics).
    use_abs = bau > bpu
    best_col = torch.where(use_abs, bai, bpi)
    packed = _fetch_columns(matrix, best_col)
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

    ``matrix``: (W, K) int32 packed presence tensor. ``fits``: list of
    dicts with keys pos_mask, neg_mask, test_pos_mask, test_neg_mask (numpy
    uint32 (W,)), p (float), model_type (str). ``excl_rules`` (optional int
    array, values in [0, 2K)): blacklisted rules (presence idx k, absence
    idx k + n_kmers) excluded from selection (experiment_scm.py:632-671).
    Returns numpy (rules (F, max_rules) int32 [-1 pad], n_rules (F,) int32,
    risks (F, max_rules+1) float32).
    """
    if matrix.dtype != torch.int32 or matrix.dim() != 2:
        raise ValueError("grid engine expects a (W, K) int32 packed matrix")
    dev = matrix.device
    pos, neg, tpos, tneg, ps, is_disj = _build_fit_arrays(fits)
    n_fits = len(fits)
    conj, rules, risks, n_rules, active, n_tpos, n_tneg = _init_state(
        pos, neg, tpos, tneg, is_disj, n_fits, max_rules
    )

    excl = None
    if excl_rules is not None and len(excl_rules):
        excl_np = np.zeros((2, matrix.shape[1]), np.uint8)
        er = np.asarray(excl_rules, np.int64)
        excl_np[0, er[er < n_kmers]] = 1
        excl_np[1, er[er >= n_kmers] - n_kmers] = 1
        excl = torch.from_numpy(excl_np).to(dev)

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
