"""Per-stage timing and profiling hooks (port of ``grm_tpu/profiling.py``).

Named stage timers with a report, the headline throughput numbers, and a
``torch.profiler`` trace context in place of ``grm_tpu``'s ``jax_trace``:
it writes a Chrome/Perfetto trace JSON, readable in ``chrome://tracing``
or ui.perfetto.dev, with no TensorBoard needed.

The port's own spans (:func:`span`) mark its stages where the work
happens: the load's read, fill and waits, the learners' greedy steps and
forest rounds, the ingest's batches. They are off unless
:func:`record_spans` or :func:`torch_trace` turns them on.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from collections import OrderedDict

__all__ = ["StageTimer", "torch_trace", "throughput", "span", "spanned",
           "record_spans", "take_spans", "SpanRecord"]


class StageTimer:
    """Collects named stage durations; nested stages are flattened by name."""

    def __init__(self):
        self.stages = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.time()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (time.time() - t0)

    @property
    def total(self):
        return sum(self.stages.values())

    def report(self):
        lines = ["Stage timings:"]
        for name, seconds in self.stages.items():
            lines.append("  %-32s %8.3fs" % (name, seconds))
        lines.append("  %-32s %8.3fs" % ("TOTAL", self.total))
        return "\n".join(lines)

    def as_dict(self):
        return dict(self.stages)


@contextlib.contextmanager
def torch_trace(log_dir):
    """Trace the block with ``torch.profiler`` (the CPU, and the card where
    CUDA is available) and write it into ``log_dir`` as a Chrome/Perfetto
    trace JSON, ``trace-<pid>-<ns>.json``. Yields the profiler; its
    ``trace_path`` attribute names the file once the block has ended.

    Spans are on for the block: each shows in the trace as a ``grm:<name>``
    range above the operators it launched. Their records stay in memory
    for :func:`take_spans`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = _on
    record_spans(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        record_spans(was_on)
    prof.trace_path = os.path.join(
        str(log_dir), "trace-%d-%d.json" % (os.getpid(), time.time_ns()))
    prof.export_chrome_trace(prof.trace_path)


def throughput(n_kmers, n_genomes, seconds, n_chips=1):
    """Headline throughput numbers (BASELINE.md metric definitions)."""
    seconds = max(seconds, 1e-12)
    return {
        "kmers_per_s_per_chip": n_kmers / seconds / n_chips,
        "genomes_per_s": n_genomes / seconds,
        "seconds": seconds,
    }


# -- spans ---------------------------------------------------------------

MAX_SPANS = 1 << 20  # records kept until taken; later ones are counted
SPAN_PREFIX = "grm:"

_on = False
_records = []
_dropped = 0
_local = threading.local()  # .open: this thread's open spans, innermost last
_range = None  # the profiler's range type, set by record_spans(True)
_dist = None  # torch.distributed, set by record_spans(True)


class SpanRecord:
    """One span of the port: ``name``; ``start`` and ``end`` on
    ``time.perf_counter()`` (``end`` None while open); ``parent``, the
    record of the span that encloses it on its thread (None at the top);
    ``rank``, the process's rank where a mesh spans processes (None
    otherwise); ``counts``, a dict of integers.

    Counts known only at the end are set on the record the ``with``
    statement yields: ``rec["nodes"] = n``. The context of a span that is
    off is false, so that a count that costs work is computed only where
    it is recorded: ``if rec: rec["nodes"] = ...``."""

    __slots__ = ("name", "start", "end", "parent", "rank", "counts", "_range")

    def __init__(self, name, counts):
        self.name = name
        self.counts = {k: int(v) for k, v in counts.items()}
        self.start = self.end = self.parent = self.rank = self._range = None

    def __setitem__(self, key, value):
        self.counts[key] = int(value)

    def __enter__(self):
        global _dropped
        stack = _open_spans()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        if _dist.is_available() and _dist.is_initialized():
            self.rank = _dist.get_rank()
        if len(_records) < MAX_SPANS:
            _records.append(self)
        else:
            _dropped += 1
        self._range = _range(SPAN_PREFIX + self.name)
        self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        self._range.__exit__(*exc)
        self._range = None
        _open_spans().pop()
        return False


class _NoSpan:
    """The one context :func:`span` returns while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __setitem__(self, key, value):
        pass

    def __bool__(self):
        return False


_NO_SPAN = _NoSpan()


def _open_spans():
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


def span(name, **counts):
    """A span around a stage of the port: ``with span("scm.step", fits=n)
    as rec: ...``. It records what the host did and when; it never
    synchronizes the device, whose trace says whether the device waited.

    While spans are on it records a :class:`SpanRecord` and is a profiler
    range ``grm:<name>`` (a ``cpu_op``: a ``record_function`` range would
    be mirrored onto the device's timeline as if it were device work).
    Off, it returns one shared context that records nothing."""
    if not _on:
        return _NO_SPAN
    return SpanRecord(name, counts)


def spanned(name):
    """A decorator: each call of the function is a :func:`span` ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with SpanRecord(name, {}):
                return fn(*args, **kwargs)

        return call

    return wrap


def record_spans(on=True):
    """Turn spans on or off for the process."""
    global _on, _range, _dist
    if on and _range is None:
        import torch
        import torch.distributed

        _range = torch._C._profiler._RecordFunctionFast
        _dist = torch.distributed
    _on = bool(on)


def take_spans():
    """(the spans recorded since the last call, in the order they were
    entered; how many were dropped past :data:`MAX_SPANS`), and forget
    them."""
    global _records, _dropped
    out, dropped = _records, _dropped
    _records, _dropped = [], 0
    return out, dropped
