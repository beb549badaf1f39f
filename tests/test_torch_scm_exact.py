"""The port's exact SCM engine (on the CPU) against ``grm_tpu``'s
``ExactScmEngine.run_fits`` on tie-rich CV fits: rules, rule counts, fold
error counts, test sizes and tie sets must be equal. Covers the default
compaction budgets, budgets of 1 (every escalation path), a blacklist, and
a matrix past 500,000 k-mers (2K > UTIL_BLOCK_SIZE), where the reference's
cross-block allclose tie accumulation runs."""

import jax.numpy as jnp
import numpy as np
import pytest

from grm_tpu.parallel.scm_exact import ExactScmEngine as JaxEngine
from grm_tpu.parallel.scm_exact import _make_risk_lookup as jax_lookup
from grm_tpu.utils import pack_binary_bytes_to_ints

from grm_tpu_torch.ops.popcount import masks_to_tensor
from grm_tpu_torch.parallel.scm_exact import ExactScmEngine, _make_risk_lookup

from helpers_scm import make_cv_fits


def _tie_rich(seed, n_genomes, n_kmers, dup_cols, density=0.5, flips=2):
    rng = np.random.RandomState(seed)
    dense = (rng.rand(n_genomes, n_kmers) < density).astype(np.uint8)
    y = (rng.rand(n_genomes) > 0.5).astype(np.uint8)
    marker = y.copy()
    marker[rng.choice(n_genomes, flips, replace=False)] ^= 1
    dense[:, 5] = marker
    for c in dup_cols[:-1]:
        dense[:, c] = marker  # exact duplicates: presence-rule ties
    dense[:, dup_cols[-1]] = 1 - marker  # its absence rule ties too
    by_kmer = rng.randint(0, 3, n_kmers)  # few distinct risks: risk ties
    by_anti = rng.randint(0, 3, n_kmers)
    return dense, y, by_kmer, by_anti


def _fits(y, n_genomes, w, by_kmer, by_anti, n_kmers, lookup, **kw):
    fits = make_cv_fits(y, n_genomes, w, **kw)
    for f in fits:
        f["risk_lookup"] = lookup(by_kmer, by_anti, n_kmers)
    return fits


def _compare(dense, y, by_kmer, by_anti, max_rules, excl=None, fit_kw=None,
             **engine_kw):
    n_genomes, n_kmers = dense.shape
    packed = pack_binary_bytes_to_ints(dense, 32)
    w = packed.shape[0]
    fit_kw = fit_kw or {}
    want = JaxEngine(jnp.asarray(packed), n_kmers, excl_rules=excl,
                     **engine_kw).run_fits(
        _fits(y, n_genomes, w, by_kmer, by_anti, n_kmers, jax_lookup,
              **fit_kw), max_rules, collect_ties=True)
    got = ExactScmEngine(masks_to_tensor(packed, "cpu"), n_kmers,
                         excl_rules=excl, **engine_kw).run_fits(
        _fits(y, n_genomes, w, by_kmer, by_anti, n_kmers, _make_risk_lookup,
              **fit_kw), max_rules, collect_ties=True)
    for g, w_ in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w_)
    assert len(got[4]) == len(want[4])
    for g_fit, w_fit in zip(got[4], want[4]):
        assert len(g_fit) == len(w_fit)
        for g, w_ in zip(g_fit, w_fit):
            np.testing.assert_array_equal(g, w_)
    return got


@pytest.mark.parametrize("budgets", [{}, {"hit_budget": 1, "cand_budget": 1}])
@pytest.mark.parametrize("seed", [0, 1])
def test_exact_engine_matches_jax(seed, budgets):
    dense, y, bk, ba = _tie_rich(seed, 40, 700, [100, 300, 650])
    got = _compare(dense, y, bk, ba, 4, **budgets)
    assert any(len(t) > 1 for fit in got[4] for t in fit)  # ties happened


def test_exact_engine_blacklist_matches_jax():
    dense, y, bk, ba = _tie_rich(2, 40, 700, [100, 300, 650])
    excl = [5, 5 + 700, 100, 650 + 700, 123]
    got = _compare(dense, y, bk, ba, 4, excl=excl)
    assert not np.isin(got[0], excl).any()


def test_exact_engine_past_one_utility_block_matches_jax():
    """500,100 k-mers: rules at and past index 1,000,000 (absence rules of
    the last columns) fall in the reference's second utility block, and
    the planted complement makes the winner's tie set span both blocks."""
    n_kmers = 500_100
    # Sparse noise: no random column reaches the perfect marker's utility.
    dense, y, bk, ba = _tie_rich(4, 24, n_kmers, [250_000, 500_050],
                                 density=0.05, flips=0)
    got = _compare(dense, y, bk, ba, 2, fit_kw={
        "model_types": ("conjunction",), "ps": (1.0,), "n_folds": 2})
    ties = [t for fit in got[4] for t in fit]
    assert any((t < 1_000_000).any() and (t >= 1_000_000).any()
               for t in ties)
