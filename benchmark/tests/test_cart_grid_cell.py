"""The GUI's class-importance grid cell, ``cart-grid.mtb-isoniazid-5022``:
its configuration, traffic, job and metrics load by name through the
harness; the job's check, on the CPU at a small size, reads 0 on every
exact number and the float32 control fails it; the two metrics that read
what the grid adds (``cart_forest_trees``, ``cart_select_s``) read their
spans, and are silent without them."""

import json
import os
import shutil
import time

import pytest

from harness import runner

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "cart-grid.mtb-isoniazid-5022"
CONFIG = "mtb-isoniazid-5022-gui-grid"


@pytest.fixture
def grid_bench(tmp_path):
    """A copy of the benchmark's folder whose grid configuration is cut to
    96 genomes x 3,000 k-mers."""
    dst = tmp_path / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    path = dst / "configs" / (CONFIG + ".json")
    cfg = json.loads(path.read_text())
    cfg["dataset"].update(n_genomes=96, n_kmers=3000)
    path.write_text(json.dumps(cfg))
    return str(dst)


def metric(name):
    return runner.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                              "m_" + name)


def test_the_cell_loads_by_name(spec):
    for trace in (False, True):
        cell = runner.Cell(spec, CELL, BENCH, trace)
        assert cell.chips == 1
        assert cell.config["name"] == CONFIG
        assert cell.traffic["job"] == "learn_cart_grid"
        assert cell.job.CONTROLS == ("float32",)
        assert len(cell.config["cart"]["class_importance"]) == 16
        names = set(cell.metrics)
        if trace:
            assert {"cart_forest_trees", "cart_select_s",
                    "cart_exact_roofline", "cart_nodes_per_round",
                    "load_fill_s"} <= names
        else:
            assert names == {"setup_s", "learn_s"}


def test_the_grid_is_the_gui_s_in_its_order(spec):
    cell = runner.Cell(spec, CELL, BENCH)
    values = [0.25, 0.5, 0.75, 1.0]
    assert cell.config["cart"]["class_importance"] == [
        {"0": a, "1": b} for a in values for b in values]
    base = runner.Cell(spec, "cart.mtb-isoniazid-5022", BENCH).config
    for block in ("dataset", "split"):
        assert cell.config[block] == base[block]
    state = type("S", (), {"settings": cell.config["cart"]})()
    assert cell.job.cli_tokens(state) == [
        "0:", "0.25", "0.5", "0.75", "1.0", "1:", "0.25", "0.5", "0.75",
        "1.0"]


@pytest.mark.parametrize("seed", [5, 2**31 + 77, 4_000_000_001])
def test_check_reads_zero_on_every_exact_number(seed, spec, grid_bench):
    cell = runner.Cell(spec, CELL, grid_bench)
    state = cell.job.setup(cell.config, cell.traffic, seed, "cpu")
    numbers = cell.job.check(state, cell.job.run(state, None))
    got = {n: (v, lim) for n, v, lim in numbers}
    for name in ("matrix_words_differ", "report_fields_differ",
                 "learn_entries_differ"):
        assert got[name] == (0, 0), name
    gap, limit = got["learn_float_gap"]
    assert limit == 1e-9 and gap <= limit


@pytest.mark.parametrize("seed", [5, 2**31 + 77, 4_000_000_001])
def test_the_float32_control_fails(seed, spec, grid_bench):
    cell = runner.Cell(spec, CELL, grid_bench)
    state = cell.job.setup(cell.config, cell.traffic, seed, "cpu")
    numbers = cell.job.control(state, "float32")
    assert any(v > lim for _, v, lim in numbers), numbers


def test_a_traced_cpu_run_reads_the_forest_and_the_selection(spec,
                                                             grid_bench):
    """The whole harness on the CPU, traced: correct, one forest of 96
    trees a job, 16 selections."""
    cell = runner.Cell(spec, CELL, grid_bench, True)
    result, checks = runner.measure(cell, 3_000_000_019, 0.5, True, "cpu",
                                    time.perf_counter())
    assert result["correct"], checks
    m = result["metrics"]
    assert m["cart_forest_trees"]["value"] == 96
    assert m["cart_select_s"]["value"] > 0
    assert m["cart_nodes_per_round"]["value"] > 6


def rec(name, start, end, **counts):
    from types import SimpleNamespace

    return SimpleNamespace(name=name, start=start, end=end, parent=None,
                           rank=None, counts=counts)


def synthetic_run(program):
    run = runner.Run()
    run.jobs = [(10.0, 11.0), (11.0, 12.0)]
    run.program_spans = program
    run.program_spans_dropped = 0
    return run


def test_the_metrics_read_their_spans():
    program = [rec("cart.grow", 10.1, 10.5, trees=96, combos=16),
               rec("cart.grow", 11.1, 11.5, trees=96, combos=16)]
    program += [rec("cart.select", 10.6 + i * 0.01, 10.6 + i * 0.01 + 0.002,
                    ties=int(i in (3, 7))) for i in range(16)]
    program += [rec("cart.select", 11.6, 11.604, ties=0)]
    run = synthetic_run(program)
    assert metric("cart_forest_trees").read(run) == 96
    assert metric("cart_select_s").read(run) == pytest.approx(
        (16 * 0.002 + 0.004) / 2)
    run = synthetic_run([rec("cart.grow", 10.1, 10.5, trees=6, combos=1)])
    assert metric("cart_forest_trees").read(run) == 6


@pytest.mark.parametrize("name", ["cart_forest_trees", "cart_select_s"])
def test_the_metrics_are_silent_without_their_spans(name):
    """A program without the counters or the span (the parent of this
    change: ``cart.grow`` uncounted, no ``cart.select``) leaves the metric
    out of the line."""
    run = synthetic_run([rec("cart.grow", 10.1, 10.5),
                         rec("cart.round", 10.2, 10.3, trees=6, nodes=6)])
    assert metric(name).read(run) is None
    assert metric(name).read(synthetic_run([])) is None
