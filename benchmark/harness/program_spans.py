"""The program's own spans (``grm_tpu_torch.profiling.span``) in a traced
run, on the device trace's clock.

Importing this module turns the program's spans on. Only per-layer metric
modules import it, and the runner loads those only with ``--trace 1``, so
an untraced run never records a span. A program without spans (no
``record_spans`` in its ``profiling``) records none, and every reader here
then finds nothing and returns None.

- :func:`window`: the program's spans that start inside the window (set-up
  and warm-up dropped), taken from the program once per run.
- :func:`clock`: the offset from ``time.perf_counter()`` seconds to the
  profiler's microseconds, fitted on the benchmark's own spans, which are
  in both clocks (``run.spans.done`` and ``run.timeline.spans``): the
  median of their profiler start minus their ``perf_counter`` start, and
  the largest residual.
- :func:`self_s`: a span's length less the union of its children's
  (:func:`own`: the intervals that are left).
- :func:`idle_s`: the device-idle seconds inside a set of spans: their
  intervals, mapped onto the profiler's clock, less the union of
  ``run.timeline.intervals``.
"""

from __future__ import annotations

import statistics

import torch

from harness.trace import SPAN_PREFIX, merge_intervals

try:
    from grm_tpu_torch import profiling as _profiling
except ImportError:  # the program is not beside the benchmark
    _profiling = None

if hasattr(_profiling, "record_spans"):
    _profiling.record_spans(True)

# A process's first record_function pays a one-time set-up of about a
# millisecond between the range's start and the clock read of the
# benchmark's span inside it; paid here, it stays out of the window's first
# span and out of the clock fit.
with torch.profiler.record_function(SPAN_PREFIX + "warm-up"):
    pass

LAST_RUN = None  # the run read last, for a tool that runs the window itself


def window(run):
    """The program's spans that start inside the window, ``run.jobs[0][0]``
    to ``run.jobs[-1][1]``, in the order they were entered. Taken from the
    program on the first call and kept on ``run`` (``run.program_spans``,
    and the count the program dropped, ``run.program_spans_dropped``)."""
    global LAST_RUN
    LAST_RUN = run
    if getattr(run, "program_spans", None) is None:
        take = getattr(_profiling, "take_spans", None)
        records, dropped = take() if take is not None else ([], 0)
        lo, hi = run.jobs[0][0], run.jobs[-1][1]
        run.program_spans = [r for r in records
                             if r.end is not None and lo <= r.start <= hi]
        run.program_spans_dropped = dropped
    return run.program_spans


def named(run, names):
    """The window's spans whose name is one of ``names``."""
    names = {names} if isinstance(names, str) else set(names)
    return [r for r in window(run) if r.name in names]


def per_job(run, value):
    """``value`` a job of the window, or None where ``value`` is None."""
    return None if value is None else value / len(run.jobs)


def total_s(run, names):
    """The summed length of the window's spans ``names``, or None where
    there is none."""
    got = named(run, names)
    return sum(r.end - r.start for r in got) if got else None


def clock_diffs(run):
    """The benchmark's spans matched across the two clocks, the k-th of a
    name in one with the k-th of that name in the other: [(name, its
    ``perf_counter`` start s, its profiler start us less that s in us)]."""
    if run.spans is None or run.timeline is None:
        return []
    host, prof = {}, {}
    for name, _, start, _ in run.spans.done:
        host.setdefault(name, []).append(start)
    for name, start, _ in run.timeline.spans:
        prof.setdefault(name, []).append(start)
    return [(name, h, p - h * 1e6) for name, starts in host.items()
            for h, p in zip(sorted(starts), sorted(prof.get(name, ())))]


def clock(run):
    """(offset us, largest residual us): a ``perf_counter`` second ``t``
    lies at ``t * 1e6 + offset`` on the profiler's clock; the offset is the
    median of :func:`clock_diffs`. None where nothing matches."""
    diffs = [d for _, _, d in clock_diffs(run)]
    if not diffs:
        return None
    offset = statistics.median(diffs)
    return offset, max(abs(d - offset) for d in diffs)


def children(records):
    """The spans' children among ``records``: a dict by ``id`` of the
    parent record."""
    kids = {}
    for r in records:
        kids.setdefault(id(r.parent), []).append(r)
    return kids


def own(rec, kids):
    """``rec``'s own intervals, in seconds: its range less the union of its
    children's (``kids``, from :func:`children`)."""
    pieces = [(rec.start, rec.end)]
    for cs, ce in merge_intervals([(c.start, c.end)
                                   for c in kids.get(id(rec), ())]):
        s, e = pieces.pop()
        pieces += [(s, min(cs, e)), (max(ce, s), e)]
    return [(s, e) for s, e in pieces if e > s]


def self_s(rec, kids):
    """``rec``'s self time: its length less the union of its children's."""
    return sum(e - s for s, e in own(rec, kids))


def idle_in(intervals, busy):
    """The length of the union of ``intervals`` that no interval of the
    merged, sorted ``busy`` covers (both in one unit)."""
    total, j = 0.0, 0
    for s, e in merge_intervals(intervals):
        total += e - s
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            total -= min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return total


def idle_s(run, names, self_only=False):
    """The device-idle seconds inside the window's spans ``names`` (with
    ``self_only``: inside their own intervals, their children's left out),
    or None where there is no such span, no device work or no clock fit."""
    got = named(run, names)
    fit = clock(run)
    if not got or fit is None or not run.timeline.intervals:
        return None
    kids = children(window(run)) if self_only else {}
    spans = [iv for r in got for iv in own(r, kids)]
    offset = fit[0]
    return idle_in([(s * 1e6 + offset, e * 1e6 + offset) for s, e in spans],
                   merge_intervals(run.timeline.intervals)) / 1e6
