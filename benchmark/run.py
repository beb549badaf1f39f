"""Run one cell of the benchmark of ``grm_tpu_torch`` on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints progress and the compared numbers on
standard error, and one JSON result line last on standard output. Exits
2 without a result where torch sees too few CUDA devices, where a run
loaded JAX or the JAX package, or where the program is not beside this
folder.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def log(msg):
    print("[bench %.1f] %s" % (time.perf_counter() - T_START, msg),
          file=sys.stderr, flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # Caches at fixed paths inside the checkout (the kernels build into
    # grm_tpu_torch/_kernels/ of their own accord); no library may load JAX.
    # One thread for OpenMP and BLAS: spinning pools on the card machine's
    # 8 shared cores slowed the load's host copy and spread its time
    # (learn_s 1.77-1.81 s with the default pools, 1.56-1.64 s with one
    # thread, alternating in one call on an H100). The program's own copy
    # threads are its own.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = os.path.join(ROOT, ".benchcache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [ROOT, BENCH]

    from harness import runner

    try:
        cell = runner.load_cell(ROOT, args.workload, trace=bool(args.trace))
        runner.check_card(cell.chips)
        import grm_tpu_torch  # noqa: F401  (the program must be here)
    except (runner.CellError, ImportError, OSError, KeyError) as e:
        log("cannot run: %s" % e)
        return 2
    result, checks = runner.measure(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda", T_START, log)
    found = runner.forbidden_modules()
    if found:
        log("the run loaded forbidden modules: %s" % ", ".join(found))
        return 2
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    for name, value, limit in checks:
        print("check %s %r limit %r" % (name, value, limit), file=sys.stderr)
    print("correct %s" % result["correct"], file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
