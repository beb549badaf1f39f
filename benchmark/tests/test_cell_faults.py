"""A run with the timed path broken underneath comes out not correct: the
whole run but the look for a card, on the CPU at a small size, once for
each fault the cell can have (one chip: no exchange between chips to
leave out)."""

import time

import numpy as np
import pytest

from harness import runner


def run_cell(spec, small_bench, cell, trace=False):
    c = runner.Cell(spec, cell, small_bench, trace)
    return runner.measure(c, 2_900_000_011, 0.3, trace, "cpu",
                          time.perf_counter())


def scm_load_unchanged(mp):
    """The load's split step returns its output as it found it."""
    import grm_tpu_torch.ops.popcount as pc

    mp.setattr(pc, "deinterleave_u64", lambda raw, out, lo: out)


def scm_half_the_examples(mp):
    """Every fit's example masks leave out half their examples."""
    import grm_tpu_torch.learning.experiments.scm_experiment as se

    orig = se.build_packed_mask
    mp.setattr(se, "build_packed_mask",
               lambda idx, n, w: orig(np.asarray(idx)[::2], n, w))


def scm_rule_altered(mp):
    """The learned model's first rule changes type where it is made."""
    import grm_tpu_torch.learning.experiments as ex

    orig = ex.learn_SCM

    def altered(*a, **kw):
        out = orig(*a, **kw)
        model = out[4]
        if model.rules:
            model.rules[0] = model.rules[0].inverse()
        return out
    mp.setattr(ex, "learn_SCM", altered)


def cart_half_the_examples(mp):
    """Every tree's examples leave out half of each class."""
    import grm_tpu_torch.learning.experiments.cart_experiment as ce

    orig = ce._class_example_idx
    mp.setattr(ce, "_class_example_idx",
               lambda idx, labels, n: orig(np.asarray(idx)[::2], labels, n))


def cart_split_altered(mp):
    """The learned tree's root sends its examples the other way."""
    import grm_tpu_torch.learning.experiments as ex

    orig = ex.learn_CART

    def altered(*a, **kw):
        out = orig(*a, **kw)
        root = out[4].decision_tree
        if not root.is_leaf:
            root.left_child, root.right_child = (root.right_child,
                                                 root.left_child)
        return out
    mp.setattr(ex, "learn_CART", altered)


def ingest_filter_unchanged(mp):
    """The singleton filter returns the matrix it was given."""
    import grm_tpu_torch.parallel.device_build as db

    mp.setattr(db, "compact_columns", lambda m, u, n: (m, u, n))


def ingest_half_the_batch(mp):
    """Half of each batch's genomes give no windows."""
    import grm_tpu_torch.parallel.device_build as db
    from grm_tpu_torch.ops.kmer import KEY_INVALID

    orig = db.window_keys

    def half(codes, k):
        keys, valid = orig(codes, k)
        g = codes.shape[0]
        keys.view(keys.shape[0], g, -1)[:, g // 2:] = KEY_INVALID
        return keys, valid
    mp.setattr(db, "window_keys", half)


def ingest_rule_altered(mp):
    """The fitted model's first rule changes type where it is made."""
    import grm_tpu_torch.pipeline as pl

    orig = pl.train_scm

    def altered(*a, **kw):
        res = orig(*a, **kw)
        res.model.rules[0] = res.model.rules[0].inverse()
        return res
    mp.setattr(pl, "train_scm", altered)


@pytest.mark.parametrize("cell,fault", [
    ("scm.mtb-isoniazid-5022", scm_load_unchanged),
    ("scm.mtb-isoniazid-5022", scm_half_the_examples),
    ("scm.mtb-isoniazid-5022", scm_rule_altered),
    ("cart.mtb-isoniazid-5022", scm_load_unchanged),
    ("cart.mtb-isoniazid-5022", cart_half_the_examples),
    ("cart.mtb-isoniazid-5022", cart_split_altered),
    ("ingest.kover-median-342", ingest_filter_unchanged),
    ("ingest.kover-median-342", ingest_half_the_batch),
    ("ingest.kover-median-342", ingest_rule_altered),
])
def test_a_broken_timed_path_is_not_correct(cell, fault, spec, small_bench,
                                             monkeypatch):
    fault(monkeypatch)
    result, checks = run_cell(spec, small_bench, cell)
    assert not result["correct"], checks
    assert any(v > lim for _, v, lim in checks)


def test_the_unbroken_path_is_correct(spec, small_bench):
    result, checks = run_cell(spec, small_bench, "scm.mtb-isoniazid-5022")
    assert result["correct"], checks
