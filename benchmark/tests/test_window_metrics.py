"""The window's arithmetic and the device timeline's idle share."""

import os
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from harness import runner
from harness.trace import DeviceTimeline, busy_length, merge_intervals, \
    short_name

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def metric(name):
    return runner.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                              "m_" + name.replace(".", "_"))


def make_run(jobs, **kw):
    run = runner.Run()
    run.jobs = jobs
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_learn_s_is_the_window_over_the_jobs():
    run = make_run([(10.0, 11.5), (11.6, 13.0), (13.1, 14.3)])
    assert metric("learn_s").read(run) == pytest.approx((14.3 - 10.0) / 3)


def test_ingest_mbp_s_is_all_megabases_over_the_window():
    run = make_run([(0.0, 0.5), (0.52, 1.0), (1.01, 1.6)],
                   work={"mbp": 1504.8})
    assert metric("ingest_mbp_s").read(run) == pytest.approx(
        3 * 1504.8 / 1.6)


def test_setup_s():
    assert metric("setup_s").read(make_run([(0, 1)], setup_s=12.5)) == 12.5


def event(name, start, end, device=True):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_busy_is_the_union_of_intervals():
    assert merge_intervals([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3],
                                                                 [5, 8]]
    assert busy_length([(5, 7), (0, 2), (1, 3), (7, 8)]) == 6


def test_idle_share_and_gaps_on_synthetic_intervals():
    events = [event("kern_a(int)", 0, 400_000),
              event("kern_b(int)", 300_000, 500_000),
              event("Memcpy HtoD (Pinned -> Device)", 800_000, 900_000),
              event("kern_a(int)", 950_000, 1_000_000),
              # spans: on the host, and their mirror on the device
              event("bench:load", 0, 520_000, device=False),
              event("bench:fit", 520_000, 1_000_000, device=False),
              event("bench:fit", 520_000, 1_000_000, device=True)]
    tl = DeviceTimeline(events, window_s=2.0)
    assert tl.busy_s == pytest.approx(0.65)
    run = make_run([(0, 2.0)], timeline=tl)
    assert metric("device_idle.learn").read(run) == pytest.approx(67.5)
    assert metric("device_idle.ingest").read(run) == pytest.approx(67.5)
    assert tl.idle_gaps() == [["fit", pytest.approx(0.3)],
                              ["fit", pytest.approx(0.05)]]
    assert tl.kernel_s([r"kern_a"]) == (pytest.approx(0.45), 2)
    assert tl.top_ops()[0] == ["kern_a", pytest.approx(0.45)]


def test_idle_share_is_silent_without_device_work():
    tl = DeviceTimeline([event("bench:load", 0, 10, device=False)], 1.0)
    assert metric("device_idle.learn").read(make_run([(0, 1)],
                                                     timeline=tl)) is None


def test_short_names():
    assert short_name("void (anonymous namespace)::scm_sweep_kernel<1, "
                      "true, false>(unsigned int const*, int)") \
        == "scm_sweep_kernel<1, true, false>"
    assert short_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD"
