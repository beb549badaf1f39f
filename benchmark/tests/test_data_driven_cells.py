"""A configuration, a cell and a per-layer metric are added by adding
files and entries: the harness finds them by name. Also the real cells,
cut small, run through the whole harness on the CPU and come out
correct."""

import json
import os
import shutil
import time

import pytest

from harness import runner

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOY_JOB = '''
"""A toy job: sums a seeded vector, the work of a cell added by files."""
import numpy as np


class State:
    pass


def setup(config, traffic, seed, device):
    s = State()
    s.values = np.random.RandomState(seed).rand(config["size"])
    s.want = float(s.values.sum())
    return s


def run(state, spans):
    if spans is not None:
        with spans.span("sum"):
            total = float(state.values.sum())
    else:
        total = float(state.values.sum())
    return {"total": total}


def summary(outcome):
    return outcome["total"]


def release(state, outcome):
    outcome.clear()


def work(state):
    return {"items": len(state.values)}


def check(state, outcome):
    return [("sum_gap", abs(outcome["total"] - state.want), 1e-9)]
'''

TOY_METRIC = '''
"""sum_s: the mean seconds of a job's sum span."""


def read(run):
    return run.spans.mean_s("sum") if run.spans else None
'''


def test_a_cell_added_by_files_alone(tmp_path, spec):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {os.path.join(dp, p): open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(bench) for p in fs}
    (bench / "configs" / "toy-vector.json").write_text(json.dumps(
        {"name": "toy-vector", "source": "a test", "size": 1000,
         "reduced": []}))
    (bench / "traffic" / "toy_sum.json").write_text(json.dumps(
        {"job": "toy_sum", "loop": "closed", "clients": 1,
         "warmup_jobs": 1}))
    (bench / "jobs" / "toy_sum.py").write_text(TOY_JOB)
    (bench / "metrics" / "sum_s.py").write_text(TOY_METRIC)
    spec["configs"].append({"name": "toy-vector", "source": "a test",
                            "file": "benchmark/configs/toy-vector.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "toy.sum", "config": "toy-vector",
                              "traffic": "toy_sum", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "toy_rate", "unit": "s",
                               "better": "lower", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["toy.sum"]})
    (bench / "metrics" / "toy_rate.py").write_text(
        "def read(run):\n    return run.window_s / len(run.jobs)\n")
    spec["per_layer"].append({"name": "sum_s", "unit": "s",
                              "better": "lower", "source": "program_span",
                              "layer": "toy", "moves": "toy_rate",
                              "workloads": ["toy.sum"]})
    for trace, names in ((False, {"setup_s", "toy_rate"}),
                         (True, {"sum_s"})):
        cell = runner.Cell(spec, "toy.sum", str(bench), trace)
        result, checks = runner.measure(cell, 2**31 + 7, 0.2, trace, "cpu",
                                        time.perf_counter())
        assert result["correct"] and set(result["metrics"]) == names
        assert checks[0] == ("jobs_differ", 0, 0)
    # The harness's own files are untouched.
    for path, body in before.items():
        assert open(path, "rb").read() == body, path


@pytest.mark.parametrize("cell", ["scm.mtb-isoniazid-5022",
                                  "ingest.kover-median-342",
                                  "cart.mtb-isoniazid-5022"])
@pytest.mark.parametrize("trace", [False, True])
def test_the_cells_run_small_on_the_cpu(cell, trace, spec, small_bench):
    c = runner.Cell(spec, cell, small_bench, trace)
    result, checks = runner.measure(c, 3_000_000_007, 0.5, trace, "cpu",
                                    time.perf_counter())
    assert result["correct"], checks
    assert all(v == 0 for name, v, _ in checks if "gap" not in name)
    want = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])}
    # The CPU has no device timeline: those metrics stay silent.
    got = set(result["metrics"])
    assert got <= want and (trace or got == want)
    assert result["attempted"] >= 1 and result["failed"] == 0
