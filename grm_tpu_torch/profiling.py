"""Per-stage timing and profiling hooks (port of ``grm_tpu/profiling.py``).

Named stage timers with a report, the headline throughput numbers, and a
``torch.profiler`` trace context in place of ``grm_tpu``'s ``jax_trace``:
it writes a Chrome/Perfetto trace JSON, readable in ``chrome://tracing``
or ui.perfetto.dev, with no TensorBoard needed.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

__all__ = ["StageTimer", "torch_trace", "throughput"]


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
    ``trace_path`` attribute names the file once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
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
