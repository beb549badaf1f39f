"""What a traced run (``--trace 1``) records, and how it is read.

- Spans: the benchmark's own, around its calls into the program's layers
  (``load``, ``fit``, ``report``, ``build``, ...). A span ends in
  ``torch.cuda.synchronize()``, and is also a ``record_function`` range,
  so that the profiler's timeline says what the host was doing in each
  idle gap of the device.
- Calls: the arguments' shapes at an op wrapper's public entry, recorded
  by a wrapper that the benchmark installs around the window
  (:class:`Wrappers`), turned into least times by the metric that asked.
- The device timeline: every kernel, copy and fill that torch.profiler
  saw in the window.

No Chrome trace is written: only sums leave the process.
"""

from __future__ import annotations

import contextlib
import re
import sys
import time
from collections import defaultdict

SPAN_PREFIX = "bench:"


class Spans:
    """Host-clock spans of one run, each ended by ``sync`` (the card's
    synchronize)."""

    def __init__(self, sync):
        self.done = []  # (name, job index, start s, end s)
        self.job = 0
        self.sync = sync

    @contextlib.contextmanager
    def span(self, name):
        import torch

        with torch.profiler.record_function(SPAN_PREFIX + name):
            t0 = time.perf_counter()
            yield
            self.sync()
            self.done.append((name, self.job, t0, time.perf_counter()))

    def mean_s(self, name):
        """The mean length of the spans called ``name``, or None."""
        got = [e - s for n, _, s, e in self.done if n == name]
        return sum(got) / len(got) if got else None


class Wrappers:
    """Wrap op entries for the length of the window.

    ``wanted`` maps ``"module:function"`` to a callable ``(args, kwargs)
    -> record``; each call of the function appends its record to
    ``calls["module:function"]``. The wrapper replaces the function on its
    module and on every loaded module of the program that holds the same
    object under the same name (a ``from ... import``)."""

    def __init__(self, wanted):
        self.wanted = dict(wanted)
        self.calls = defaultdict(list)
        self._undo = []

    def install(self):
        import importlib

        for key, record in self.wanted.items():
            mod_name, fn_name = key.split(":")
            mod = importlib.import_module(mod_name)
            original = getattr(mod, fn_name)
            sink = self.calls[key]

            def wrapper(*args, __o=original, __r=record, __s=sink, **kw):
                __s.append(__r(args, kw))
                return __o(*args, **kw)

            for m in list(sys.modules.values()):
                name = getattr(m, "__name__", "") or ""
                if name.split(".")[0] != mod_name.split(".")[0]:
                    continue
                if getattr(m, fn_name, None) is original:
                    setattr(m, fn_name, wrapper)
                    self._undo.append((m, fn_name, original))

    def remove(self):
        for m, fn_name, original in reversed(self._undo):
            setattr(m, fn_name, original)
        self._undo = []


def merge_intervals(intervals):
    """Sorted, merged copies of (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_length(intervals):
    """The length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merge_intervals(intervals))


def short_name(name, width=96):
    """A kernel's name without its parameter list and namespace noise."""
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    name = name[:cut].strip()
    if name.startswith("void "):
        name = name[5:]
    return name[:width]


class DeviceTimeline:
    """The device's work in a traced window, from torch.profiler's events:
    intervals (us) by name, and the benchmark's spans in the same clock."""

    def __init__(self, events, window_s):
        from torch.autograd import DeviceType

        self.window_s = window_s
        self.by_name = defaultdict(float)  # full name -> device us
        self.count = defaultdict(int)
        self.intervals = []
        self.spans = []  # (name, start us, end us)
        for e in events:
            tr = e.time_range
            if e.name.startswith(SPAN_PREFIX):
                # A span is a range on the host, mirrored on the device's
                # timeline as an annotation, which is no work of the device.
                if e.device_type != DeviceType.CUDA:
                    self.spans.append((e.name[len(SPAN_PREFIX):], tr.start,
                                       tr.end))
            elif e.device_type == DeviceType.CUDA:
                self.by_name[e.name] += tr.end - tr.start
                self.count[e.name] += 1
                self.intervals.append((tr.start, tr.end))

    @property
    def busy_s(self):
        return busy_length(self.intervals) / 1e6

    def kernel_s(self, patterns):
        """Device seconds of the kernels whose names match any of the
        regular expressions ``patterns``, and how many launches."""
        rx = [re.compile(p) for p in patterns]
        secs, n = 0.0, 0
        for name, us in self.by_name.items():
            if any(r.search(name) for r in rx):
                secs += us / 1e6
                n += self.count[name]
        return secs, n

    def top_ops(self, n=10):
        """The ``n`` device operations that took most time: [[short name,
        seconds]], names merged where they shorten alike."""
        merged = defaultdict(float)
        for name, us in self.by_name.items():
            merged[short_name(name)] += us / 1e6
        return [[k, v] for k, v in sorted(merged.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """The ``n`` longest gaps between the device's work, each named by
        the innermost span the host was in at its middle (``"between
        jobs"`` outside every span): [[label, seconds]]."""
        merged = merge_intervals(self.intervals)
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])]
        gaps.sort(key=lambda g: -g[0])
        out = []
        for length, s, e in gaps[:n]:
            mid = (s + e) / 2
            inside = [(se - ss, nm) for nm, ss, se in self.spans
                      if ss <= mid <= se]
            out.append([min(inside)[1] if inside else "between jobs",
                        length / 1e6])
        return out
