"""Run one cell traced, as ``run.py --trace 1`` runs it, and print where
the window's time went by the program's own spans.

    python3 benchmark/span_tree.py --workload <cell> --seed <n> --seconds <s> \\
        [--out <file>.json]

For each (parent, span) name pair, a job's mean: how many spans, their
length, their self time (their children's left out), the device-idle
seconds inside their own intervals and their counts summed. Then the clock
fit's residuals (the median and the largest three, with their spans), and for each of the program's top spans (``load``,
``scm.learn``, ``cart.learn``, ``ingest.build``) the share its children
cover, its length over the benchmark's span around the same call, and the
device idle inside that benchmark span beside the idle inside the top
span (which its spans' own intervals split, row by row, in the tree). The
per-layer metrics and the checks are those of a traced run; the result
line is printed first.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)

# The program's top spans and the benchmark's span around the same call.
TOPS = {"load": "load", "scm.learn": "fit", "cart.learn": "fit",
        "ingest.build": "build"}


def log(msg):
    print("[span_tree %.1f] %s" % (time.perf_counter() - T_START, msg),
          file=sys.stderr, flush=True)


def report(run):
    """The tree, the clock fit, and each top span's coverage and idle split
    (see the module's docstring), as a dict."""
    from harness import program_spans as ps
    from harness.trace import merge_intervals

    recs = ps.window(run)
    kids = ps.children(recs)
    jobs = len(run.jobs)
    fit = ps.clock(run)
    busy = merge_intervals(run.timeline.intervals) if run.timeline else []

    def idle(intervals):
        if fit is None or not busy:
            return None
        return ps.idle_in([(s * 1e6 + fit[0], e * 1e6 + fit[0])
                           for s, e in intervals], busy) / 1e6

    rows = {}
    for r in recs:
        key = "%s > %s" % (r.parent.name if r.parent else "-", r.name)
        row = rows.setdefault(key, {"n": 0, "s": 0.0, "self_s": 0.0,
                                    "idle_s": 0.0, "counts": {}})
        own = ps.own(r, kids)
        row["n"] += 1
        row["s"] += r.end - r.start
        row["self_s"] += ps.self_s(r, kids)
        got = idle(own)
        row["idle_s"] = None if got is None or row["idle_s"] is None \
            else row["idle_s"] + got
        for k, v in r.counts.items():
            row["counts"][k] = row["counts"].get(k, 0) + v
    for row in rows.values():
        for k in ("n", "s", "self_s", "idle_s"):
            if row[k] is not None:
                row[k] /= jobs

    bench = [(n, s, e) for n, _, s, e in run.spans.done] if run.spans else []
    tops = {}
    for r in recs:
        if r.name not in TOPS or (r.parent and r.parent.name in TOPS):
            continue
        mid = (r.start + r.end) / 2
        outer = [(s, e) for n, s, e in bench
                 if n == TOPS[r.name] and s <= mid <= e]
        length = r.end - r.start
        covered = sum(e - s for s, e in merge_intervals(
            [(c.start, c.end) for c in kids.get(id(r), ())]))
        t = tops.setdefault(r.name, {"n": 0, "coverage": [], "over_bench":
                                     [], "bench_idle_s": 0.0,
                                     "program_idle_s": 0.0})
        t["n"] += 1
        t["coverage"].append(covered / length if length > 0 else None)
        if outer:
            s, e = outer[0]
            t["over_bench"].append(length / (e - s))
            bi = idle([(s, e)])
            pi = idle([(r.start, r.end)])
            if bi is not None and pi is not None:
                t["bench_idle_s"] += bi / jobs
                t["program_idle_s"] += pi / jobs
    for t in tops.values():
        for k in ("coverage", "over_bench"):
            vals = [v for v in t[k] if v is not None]
            t[k] = [min(vals), max(vals)] if vals else None
    residuals = sorted((abs(d - fit[0]), name, h - run.jobs[0][0])
                       for name, h, d in ps.clock_diffs(run)) if fit else []
    return {"jobs": jobs, "spans": len(recs),
            "dropped": getattr(run, "program_spans_dropped", None),
            "clock_offset_us": fit and fit[0],
            "clock_residual_us": fit and fit[1],
            # the median and the largest three: (us, span, s into the window)
            "clock_residuals": residuals and
            [residuals[len(residuals) // 2]] + residuals[-3:],
            "tree": dict(sorted(rows.items())), "tops": tops}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--bench-dir", default=BENCH,
                        help="the benchmark folder whose cells are run")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    # As run.py sets them.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = os.path.join(ROOT, ".benchcache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    sys.path[:0] = [ROOT, BENCH]

    from harness import program_spans, runner

    cell = runner.load_cell(ROOT, args.workload, trace=True,
                            bench_dir=args.bench_dir)
    if args.device == "cuda":
        runner.check_card(cell.chips)
    result, checks = runner.measure(cell, args.seed, args.seconds, True,
                                    args.device, T_START, log)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    print(json.dumps(result), flush=True)
    if program_spans.LAST_RUN is None:
        log("no metric of the cell read the program's spans")
        return 1
    out = report(program_spans.LAST_RUN)
    out["workload"] = args.workload
    out["seed"] = args.seed
    print(json.dumps(out, indent=1), flush=True)
    if args.out:
        with open(os.path.join(ROOT, args.out), "w") as f:
            json.dump({"result": result, "spans": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
