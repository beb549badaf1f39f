"""One run of one cell: set-up, warm-up, the measured window, the check,
the result line.

The cell, its configuration, its traffic and its metrics are found by name
(:func:`load_cell`): ``BENCHMARK.json`` names them, ``configs/<config>.json``
holds the deployment, ``traffic/<traffic>.json`` the mix (which job, the
loop, the warm-up), ``jobs/<job>.py`` the job, and ``metrics/<metric>.py``
each metric. Adding a configuration, a cell or a metric adds files and
entries; no file of the harness changes.

The window is closed-loop with one client: jobs run back to back until
the first job that ends past ``--seconds``. Nothing compiles inside it:
the warm-up job has built and loaded every kernel the cell's shapes use.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

from .trace import DeviceTimeline, Spans, Wrappers

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Top-level module names no run may load: JAX and its kin, the JAX package
# and its benchmark script. Compared whole: ``grm_tpu_torch`` is not
# ``grm_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "grm_tpu", "bench")


class CellError(Exception):
    """The cell cannot run as named."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """The module in file ``path``, imported under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise CellError("no module at %s" % path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic,
    job and metrics, read from ``bench_dir`` (the benchmark's folder)."""

    def __init__(self, spec, name, bench_dir=HERE, trace=False):
        by_name = {w["name"]: w for w in spec["workloads"]}
        if name not in by_name:
            raise CellError("no workload %r in BENCHMARK.json" % name)
        self.workload = by_name[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.config = load_json(os.path.join(
            bench_dir, "configs", self.workload["config"] + ".json"))
        self.traffic = load_json(os.path.join(
            bench_dir, "traffic", self.workload["traffic"] + ".json"))
        self.job = load_module(os.path.join(
            bench_dir, "jobs", self.traffic["job"] + ".py"),
            "bench_job_" + self.traffic["job"])
        kind = "per_layer" if trace else "end_to_end"
        self.metric_entries = [m for m in spec[kind]
                               if name in m.get("workloads", [name])]
        self.metrics = {
            m["name"]: load_module(os.path.join(
                bench_dir, "metrics", m["name"] + ".py"),
                "bench_metric_" + m["name"].replace(".", "_"))
            for m in self.metric_entries}


def load_cell(root, name, trace=False, bench_dir=HERE):
    """The cell ``name`` of ``<root>/BENCHMARK.json``."""
    return Cell(load_json(os.path.join(root, "BENCHMARK.json")), name,
                bench_dir, trace)


class Run:
    """What a metric reads: the window's jobs, the set-up time, the job's
    work, and in a traced run the spans, the calls and the device
    timeline."""

    def __init__(self):
        self.jobs = []  # (start s, end s) of each job in the window
        self.setup_s = None
        self.work = {}
        self.spans = None
        self.calls = {}
        self.timeline = None

    @property
    def window_s(self):
        return self.jobs[-1][1] - self.jobs[0][0]


def forbidden_modules():
    """The loaded modules whose top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def check_card(chips):
    """Raise unless torch sees ``chips`` CUDA devices."""
    import torch

    if not torch.cuda.is_available():
        raise CellError("no CUDA device: this benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise CellError("the cell asks for %d chips, torch sees %d"
                        % (chips, torch.cuda.device_count()))


def measure(cell, seed, seconds, trace, device, t_start, log=None):
    """Set up, warm up, run the window and check it. Returns (the result
    dict without its checks, the checks [(name, value, limit)]): every
    job's summary must equal the last job's, and the last job's outcome
    must pass the job's own check against the plain reference."""
    import torch

    log = log or (lambda msg: None)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    job, run = cell.job, Run()
    state = job.setup(cell.config, cell.traffic, seed, device)
    for _ in range(int(cell.traffic.get("warmup_jobs", 1))):
        job.release(state, job.run(state, None))
    sync()
    run.setup_s = time.perf_counter() - t_start
    run.work = job.work(state)
    log("set-up %.3f s" % run.setup_s)

    wrappers, prof = None, None
    if trace:
        run.spans = Spans(sync)
        wanted = {}
        for mod in cell.metrics.values():
            wanted.update(getattr(mod, "WRAPS", {}))
        wrappers = Wrappers(wanted)
        wrappers.install()
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        prof.start()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    summaries = []
    t_window = time.perf_counter()
    deadline = t_window + seconds
    while True:
        if run.spans is not None:
            run.spans.job = len(run.jobs)
        t0 = time.perf_counter()
        outcome = job.run(state, run.spans)
        t1 = time.perf_counter()
        run.jobs.append((t0, t1))
        summaries.append(job.summary(outcome))
        if t1 >= deadline:
            break
        job.release(state, outcome)
        del outcome
    t_end = time.perf_counter()
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated()
                                            if cuda else 0)}
    breakdown = None
    if trace:
        prof.stop()
        wrappers.remove()
        run.calls = dict(wrappers.calls)
        run.timeline = DeviceTimeline(prof.events(), t_end - t_window)
        del prof
        device_info["busy_s"] = run.timeline.busy_s
        device_info["window_s"] = run.timeline.window_s
        breakdown = {"device_ops": run.timeline.top_ops(),
                     "idle_gaps": run.timeline.idle_gaps()}
    log("window: %d jobs in %.3f s; each job (s): %s"
        % (len(run.jobs), run.window_s,
           " ".join("%.3f" % (e - s) for s, e in run.jobs)))

    if run.spans is not None:
        log("spans (s): " + " ".join("%s:%d:%.3f" % (n, j, e - s)
                                      for n, j, s, e in run.spans.done))
    metrics = {}
    for entry in cell.metric_entries:
        value = cell.metrics[entry["name"]].read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    checks = [("jobs_differ", sum(s != summaries[-1] for s in summaries), 0)]
    checks += job.check(state, outcome)
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": len(run.jobs), "failed": 0, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, checks
