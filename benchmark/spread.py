"""Run one cell several times, each run a process of its own as the check
runs it, and report each metric's median and spread.

    python3 benchmark/spread.py --workload <cell> --seeds 11 12 13 \\
        --seconds 10 [--trace 0|1] [--out chiprun_out/<file>.json]

A spread is the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median. Every
run's result line and the end of its standard error go to ``--out``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def spread(values):
    """(median, IQR / median) of ``values``; the IQR is 0 below 2 values."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, default=0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    runs = []
    for seed in args.seeds:
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
             args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace)],
            cwd=ROOT, capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        runs.append({"seed": seed, "rc": proc.returncode,
                     "wall_s": time.time() - t0, "result": result,
                     "stderr": proc.stderr[-3000:]})
        print(json.dumps({"seed": seed, "rc": proc.returncode,
                          "wall_s": round(time.time() - t0, 1),
                          "correct": result and result["correct"],
                          "metrics": result and {
                              k: v["value"]
                              for k, v in result["metrics"].items()},
                          "checks": result and result.get("checks")}),
              flush=True)
    ok = [r["result"] for r in runs if r["result"]]
    summary = {}
    for name in sorted({m for r in ok for m in r["metrics"]}):
        values = [r["metrics"][name]["value"] for r in ok
                  if name in r["metrics"]]
        med, spr = spread(values)
        summary[name] = {"median": med, "spread": spr, "n": len(values)}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    if args.out:
        with open(os.path.join(ROOT, args.out), "w") as f:
            json.dump({"workload": args.workload, "runs": runs,
                       "summary": summary}, f, indent=1)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
