"""Each cell's controls come out not correct: at least one compared number
past its limit. On the CPU at a small size; the benchmark's
``controls.py`` reads them on the card at the cells' own sizes."""

import numpy as np
import pytest

from harness import runner


@pytest.mark.parametrize("cell,control", [
    ("scm.mtb-isoniazid-5022", "float32"),
    ("scm.mtb-isoniazid-5022", "argmax"),
    ("cart.mtb-isoniazid-5022", "float32"),
    ("ingest.kover-median-342", "forward_strand"),
    ("ingest.kover-median-342", "no_filter"),
])
@pytest.mark.parametrize("seed", [5, 2**31 + 77, 4_000_000_001])
def test_controls_fail(cell, control, seed, spec, small_bench):
    c = runner.Cell(spec, cell, small_bench)
    assert control in c.job.CONTROLS or control == "argmax"
    state = c.job.setup(c.config, c.traffic, seed, "cpu")
    numbers = c.job.control(state, control)
    assert any(v > lim for _, v, lim in numbers), numbers


def test_float32_control_reads_a_gap_the_limit_separates(spec, small_bench):
    c = runner.Cell(spec, "scm.mtb-isoniazid-5022", small_bench)
    state = c.job.setup(c.config, c.traffic, 11, "cpu")
    gap = dict((n, v) for n, v, _ in c.job.control(state, "float32"))
    limit = c.config["limits"]["learn_float_gap"]
    assert gap["learn_float_gap"] > 100 * limit


def test_int8_products_on_the_card(card):
    """The reference's counts on the card (int8 products) equal a plain
    count."""
    from reference.scm import PackedMatrix
    from harness import recipes

    arrays, _ = recipes.synthetic_arrays(300, 70_001, 3)
    pm = PackedMatrix(arrays["kmer_matrix"], 300, card, chunk_cols=1 << 14)
    rng = np.random.RandomState(0)
    masks = (rng.rand(30, 300) < 0.5).astype(np.int8)
    got = pm.counts(masks).cpu().numpy()
    dense = np.stack([pm.column(c) for c in range(70_001)], axis=1)
    assert np.array_equal(got, masks.astype(np.int64) @ dense)
