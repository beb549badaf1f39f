"""Read a cell's compared numbers on many seeds, and its controls', in one
process: the readings its limits are set from.

    python3 benchmark/controls.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 7 8 9 [--controls NAME ...] [--out FILE]

For each of ``--seeds`` the cell is set up, one job runs through the
timed path (untimed here), and the check's numbers are read. For each of
``--control-seeds`` each control of the cell's job (``CONTROLS`` in its
module) is read: a control has to come out past at least one limit.
One JSON line a reading.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--controls", nargs="*")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path[:0] = [ROOT, BENCH]
    from harness import runner

    cell = runner.load_cell(ROOT, args.workload)
    runner.check_card(cell.chips)
    job = cell.job
    lines = []

    def emit(kind, seed, name, numbers, t0):
        line = {"kind": kind, "seed": seed, "control": name,
                "s": round(time.time() - t0, 1),
                "numbers": {n: v for n, v, _ in numbers},
                "past_limit": [n for n, v, lim in numbers if v > lim]}
        lines.append(line)
        print(json.dumps(line), flush=True)

    for seed in args.seeds:
        t0 = time.time()
        state = job.setup(cell.config, cell.traffic, seed, "cuda")
        emit("program", seed, None, job.check(state, job.run(state, None)),
             t0)
        del state
    for seed in args.control_seeds:
        for name in args.controls or job.CONTROLS:
            t0 = time.time()
            state = job.setup(cell.config, cell.traffic, seed, "cuda")
            emit("control", seed, name, job.control(state, name), t0)
            del state
    if args.out:
        with open(os.path.join(ROOT, args.out), "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
