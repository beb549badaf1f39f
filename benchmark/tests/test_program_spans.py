"""The program's spans on the device trace's clock
(:mod:`harness.program_spans`), on synthetic records: the window, the
clock fit, self time, device idle inside spans, and the metrics that read
them."""

import os
import time
from types import SimpleNamespace

import pytest

from harness import program_spans as ps
from harness import runner
from harness.trace import DeviceTimeline, Spans

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def metric(name):
    return runner.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                              "m_" + name.replace(".", "_"))


def rec(name, start, end, parent=None, **counts):
    return SimpleNamespace(name=name, start=start, end=end, parent=parent,
                           rank=None, counts=counts)


def make_run(jobs, program, bench=(), timeline=None, skew=()):
    """A traced run whose program recorded ``program``; ``bench``: the
    benchmark's spans (name, start s, end s), put on the profiler's clock
    1000 s (1e9 us) later than ``perf_counter``, the first ones ``skew``
    us later still."""
    run = runner.Run()
    run.jobs = jobs
    run.program_spans = list(program)
    run.program_spans_dropped = 0
    run.spans = Spans(lambda: None)
    run.spans.done = [(n, 0, s, e) for n, s, e in bench]
    run.timeline = timeline or DeviceTimeline([], window_s=1.0)
    skew = list(skew) + [0] * len(bench)
    run.timeline.spans = [(n, s * 1e6 + 1e9 + d, e * 1e6 + 1e9)
                          for (n, s, e), d in zip(bench, skew)]
    return run


def test_window_keeps_the_spans_that_start_inside_it(monkeypatch):
    inside = rec("a", 10.5, 10.6)
    records = [rec("warm-up", 1.0, 2.0), inside, rec("b", 12.0, 13.0),
               rec("check", 15.0, 16.0), rec("open", 11.0, None)]
    monkeypatch.setattr(ps._profiling, "take_spans", lambda: (records, 4))
    run = runner.Run()
    run.jobs = [(10.0, 11.0), (11.0, 14.0)]
    assert ps.window(run) == [inside, records[2]]
    assert run.program_spans_dropped == 4
    assert ps.window(run) == [inside, records[2]]  # taken once
    assert ps.LAST_RUN is run


def test_clock_offset_is_the_median_and_keeps_the_largest_residual():
    bench = [("load", 1.0, 2.0), ("fit", 2.0, 3.0), ("load", 3.0, 4.0),
             ("fit", 4.0, 5.0)]
    offset, residual = ps.clock(make_run([(1.0, 5.0)], [], bench,
                                         skew=(30, -10)))
    assert offset == pytest.approx(1e9)
    assert residual == pytest.approx(30)


def test_clock_matches_spans_of_a_name_in_order():
    bench = [("fit", 2.0, 3.0), ("load", 1.0, 2.0)]  # entered out of order
    run = make_run([(1.0, 3.0)], [], bench)
    run.timeline.spans = [(n, s * 1e6 + 5e8, e * 1e6 + 5e8)
                          for n, s, e in sorted(bench, key=lambda b: b[1])]
    assert ps.clock(run) == (pytest.approx(5e8), pytest.approx(0))
    run.timeline = None
    assert ps.clock(run) is None


def test_self_time_of_nested_spans():
    top = rec("top", 0.0, 10.0)
    a = rec("a", 1.0, 4.0, top)
    b = rec("b", 3.0, 6.0, top)  # overlaps a: the union counts once
    leaf = rec("leaf", 1.5, 2.0, a)
    kids = ps.children([top, a, b, leaf])
    assert ps.self_s(top, kids) == pytest.approx(10.0 - 5.0)
    assert ps.own(top, kids) == [(0.0, 1.0), (6.0, 10.0)]
    assert ps.self_s(a, kids) == pytest.approx(2.5)
    assert ps.self_s(leaf, kids) == pytest.approx(0.5)


def test_idle_in_intervals_against_hand_computed_unions():
    busy = [[0, 2], [5, 6], [8, 20]]
    assert ps.idle_in([(1, 9)], busy) == pytest.approx(8 - 1 - 1 - 1)
    assert ps.idle_in([(1, 3), (2, 4)], busy) == pytest.approx(2)
    assert ps.idle_in([(20, 25)], busy) == pytest.approx(5)
    assert ps.idle_in([(6, 8)], busy) == pytest.approx(2)
    assert ps.idle_in([], busy) == 0


def event(start_us, end_us):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name="kern", time_range=SimpleNamespace(start=start_us, end=end_us),
        device_type=DeviceType.CUDA)


def learn_run():
    """Two jobs of a CART cell: the device busy 0.1-0.3 s and 1.1-1.2 s of
    each job (on the profiler's clock), the host's stages around it."""
    base = 1e9
    events = []
    program = []
    for j in range(2):
        t = 10.0 + 2 * j
        events += [event(base + (t + 0.1) * 1e6, base + (t + 0.3) * 1e6),
                   event(base + (t + 1.1) * 1e6, base + (t + 1.2) * 1e6)]
        learn = rec("cart.learn", t, t + 1.5)
        grow = rec("cart.grow", t, t + 1.0, learn)
        rnd = rec("cart.round", t, t + 1.0, grow, trees=6, nodes=4 + j)
        program += [learn, grow, rnd,
                    rec("cart.advance", t, t + 0.1, rnd),
                    rec("cart.score", t + 0.1, t + 0.9, rnd),
                    rec("cart.replay", t + 0.5, t + 0.8,
                        None),  # parent set below
                    rec("cart.finish", t + 1.0, t + 1.4, learn),
                    rec("cart.predict", t + 1.4, t + 1.5, learn)]
        program[-3].parent = program[-4]
    bench = [("fit", 10.0, 11.5), ("fit", 12.0, 13.5)]
    tl = DeviceTimeline(events, window_s=4.0)
    return make_run([(10.0, 11.6), (12.0, 13.6)], program, bench, tl)


def test_idle_inside_spans_and_their_own_intervals():
    run = learn_run()
    # advance 0-0.1 idle; replay 0.5-0.8 idle; finish 1.0-1.4 less 0.1
    # busy; predict idle: a job 0.1 + 0.3 + 0.3 + 0.1.
    assert ps.idle_s(run, ("cart.advance", "cart.replay", "cart.finish",
                           "cart.predict")) == pytest.approx(2 * 0.8)
    # cart.score's own intervals 0.1-0.5 and 0.8-0.9: 0.2 busy, 0.3 idle.
    assert ps.idle_s(run, "cart.score", self_only=True) == pytest.approx(
        2 * 0.3)
    assert ps.idle_s(run, "cart.score") == pytest.approx(2 * 0.6)
    assert ps.idle_s(run, "no.such.span") is None
    # The split adds up to the idle inside the benchmark's fit spans.
    parts = [ps.idle_s(run, n, self_only=True) for n in
             ("cart.learn", "cart.grow", "cart.round", "cart.advance",
              "cart.score", "cart.replay", "cart.finish", "cart.predict")]
    whole = 2 * (1.5 - 0.2 - 0.1)
    assert sum(parts) == pytest.approx(whole)


def test_cart_metrics_on_a_synthetic_run():
    run = learn_run()
    assert metric("cart_advance_s").read(run) == pytest.approx(0.1)
    assert metric("cart_replay_s").read(run) == pytest.approx(0.3)
    assert metric("cart_finish_s").read(run) == pytest.approx(0.5)
    assert metric("cart_host_idle_s").read(run) == pytest.approx(0.8)
    assert metric("cart_nodes_per_round").read(run) == pytest.approx(4.5)


def test_load_and_ingest_metrics_on_a_synthetic_run():
    base = 1e9
    load = rec("load", 10.0, 11.0, bytes=100)
    build = rec("ingest.build", 11.0, 12.0)
    program = [load, rec("load.read", 10.0, 10.2, load),
               rec("load.fill", 10.2, 10.5, load, bytes=60),
               rec("load.fill", 10.6, 10.8, load, bytes=40),
               build, rec("ingest.pad", 11.0, 11.4, build, genomes=32),
               rec("ingest.pad", 11.5, 11.6, build, genomes=6),
               rec("pipeline.decode", 11.7, 11.75)]
    tl = DeviceTimeline([event(base + 10.4e6, base + 10.7e6),
                         event(base + 11.3e6, base + 11.55e6)], window_s=2.0)
    run = make_run([(10.0, 12.0)], program,
                   [("load", 10.0, 11.0), ("build", 11.0, 12.0)], tl)
    assert metric("load_fill_s").read(run) == pytest.approx(0.5)
    # fills 10.2-10.5 and 10.6-10.8, busy from 10.4 to 10.7
    assert metric("load_fill_idle_s").read(run) == pytest.approx(0.3)
    assert metric("ingest_pad_s").read(run) == pytest.approx(0.5)
    # pads 11.0-11.4 and 11.5-11.6, busy 11.3 to 11.55
    assert metric("ingest_pad_idle_s").read(run) == pytest.approx(0.35)
    assert metric("ingest_decode_s").read(run) == pytest.approx(0.05)


@pytest.mark.parametrize("name", [
    "load_fill_s", "load_fill_idle_s", "scm_sweep_s", "scm_select_s",
    "cart_advance_s", "cart_replay_s", "cart_finish_s", "cart_host_idle_s",
    "cart_nodes_per_round", "ingest_pad_s", "ingest_pad_idle_s",
    "ingest_decode_s"])
def test_metrics_are_silent_without_program_spans(name):
    """A program without spans (the parent of this change) leaves every
    metric out of the line."""
    run = make_run([(10.0, 12.0)], [], [("fit", 10.0, 12.0)])
    assert metric(name).read(run) is None


def test_span_tree_reports_a_small_cpu_run(spec, small_bench):
    """``span_tree.report`` on a traced CPU run of the ingest cell, cut
    small: the program's tree under the top span, which covers the
    benchmark's ``build`` span; the CPU has no device timeline, so no
    idle."""
    tool = runner.load_module(os.path.join(BENCH, "span_tree.py"),
                              "span_tree_under_test")
    cell = runner.Cell(spec, "ingest.kover-median-342", small_bench, True)
    result, _ = runner.measure(cell, 3_000_000_019, 0.5, True, "cpu",
                               time.perf_counter())
    assert result["correct"] and "ingest_pad_s" in result["metrics"]
    out = tool.report(ps.LAST_RUN)
    assert out["dropped"] == 0 and out["clock_residual_us"] is not None
    assert out["clock_residuals"][-1][0] == out["clock_residual_us"]
    assert {"- > ingest.build", "ingest.build > ingest.pad",
            "ingest.build > ingest.batch", "ingest.build > ingest.merge",
            "ingest.build > ingest.counts", "ingest.build > ingest.compact",
            "- > pipeline.fit", "pipeline.fit > pipeline.decode"} \
        == set(out["tree"])
    pads = out["tree"]["ingest.build > ingest.pad"]
    assert pads["n"] == 3 and pads["counts"]["genomes"] == 70 * out["jobs"]
    assert pads["idle_s"] is None
    top = out["tops"]["ingest.build"]
    assert top["n"] == out["jobs"] and 0.9 < top["coverage"][0] <= 1.0
    assert 0.95 < top["over_bench"][0] <= top["over_bench"][1] <= 1.0
