#!/usr/bin/env python3
"""Time the SCM utility sweep kernel (``scm_sweep_sbmax`` and
``scm_sweep_argmax_blocks`` of ``grm_tpu_torch/ops/scm_sweep.py``) of one
checkout on one NVIDIA GPU, by CUDA events, at three shapes:

- ``shallow``: the published median, 342 genomes (W = 11) x 9,600,000
  k-mers, 120 fits;
- ``deep``: the exact engine's launch in the benchmark's
  ``scm.mtb-isoniazid-5022`` cell, 5022 genomes (W = 157 words) x
  11,700,000 k-mers, 120 fits (2 model types x 10 p x 6 fits);
- ``chunk``: the same fits over one chunk of the streamed engine (2^21
  columns), one launch a chunk.

Superblocks of 8192 columns (the exact engine's) and blocks of 4096 (the
argmax engine's). The matrix and the fits are random words from a seed,
made on the card. Each launch is first held to its plain version on the
first 2^20 columns, exactly. Prints one JSON line a row: device ms a
launch (the mean of ``--reps`` launches between two CUDA events), the
least time (one read of the matrix at 3.35 TB/s, or 2 F W K word ANDs as a
1-bit product at 5.14e15 bit-ANDs/s, the larger; ``benchmark/harness/
peaks.py``'s constants), the share of it, the wrapper's launch counts, the
card's ``nvidia-smi`` name and power limit. Then the ``ptxas`` lines of
``scm_sweep_kernel`` (registers, spills) when this process built it.

    python3 scripts/time_scm_sweep.py [--repo DIR] [--reps N]

``--repo`` names the checkout whose package is timed (default: the one
holding this script), so that two versions compare inside one machine:
parent, change, change, parent.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

# The shallow case first: timed after the deep ones, in one process, it
# read up to 25% slower than in a fresh process, on either version.
CASES = [("shallow", 11, 9_600_000, 120), ("deep", 157, 11_700_000, 120),
         ("chunk", 157, 1 << 21, 120)]
SB, BLOCK = 8192, 4096
CHECK_COLS = 1 << 20
P_GRID = [0.1, 0.178, 0.316, 0.562, 1.0, 1.778, 3.162, 5.623, 10.0, 999999.0]
HBM_BYTES_PER_S = 3.35e12
B1_BIT_ANDS_PER_S = 5.14e15


def bound_ms(w, k, f, n_blocks, out_bytes):
    nbytes = 4 * w * k + f * (8 * w + 12) + out_bytes * n_blocks * f
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_b1 = 32.0 * 2 * f * w * k / B1_BIT_ANDS_PER_S
    return max(by_bytes, by_b1) * 1e3, "bytes" if by_bytes > by_b1 else "b1"


def fits(torch, w, f, n_genomes, seed, device):
    rng = np.random.RandomState(seed)
    neg = rng.randint(0, 2**32, size=(f, w), dtype=np.uint64).astype(np.uint32)
    pos = neg ^ np.uint32(0xFFFFFFFF)
    tail = n_genomes - 32 * (w - 1)
    keep = np.uint32((0xFFFFFFFF << (32 - tail)) & 0xFFFFFFFF)
    neg[:, -1] &= keep
    pos[:, -1] &= keep
    popc = lambda a: np.unpackbits(a.view(np.uint8), axis=1).sum(1)
    ps = np.array(P_GRID, np.float32)[np.arange(f) % len(P_GRID)]
    return [torch.from_numpy(a).to(device) for a in (
        neg.view(np.int32), pos.view(np.int32),
        popc(neg).astype(np.int32), popc(pos).astype(np.int32), ps)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_scm_sweep: CUDA is not available", file=sys.stderr)
        return 2
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    os.chdir(repo)
    from grm_tpu_torch.ops import _build
    from grm_tpu_torch.ops import scm_sweep as sw

    _build.build_all()
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=device)
    for case, w, k, f in CASES:
        gen.manual_seed(w * 1000 + f)
        matrix = torch.randint(-2**31, 2**31 - 1, (w, k), dtype=torch.int32,
                               device=device, generator=gen)
        fit = fits(torch, w, f, 32 * w - 2, w + f, device)
        head = matrix[:, :CHECK_COLS].contiguous()
        for name, kernel, plain, block, out_bytes in (
                ("scm_sweep_sbmax", sw.scm_sweep_sbmax,
                 sw.scm_sweep_sbmax_plain, SB, 4),
                ("scm_sweep_argmax", sw.scm_sweep_argmax_blocks,
                 sw.scm_sweep_argmax_blocks_plain, BLOCK, 8)):
            nb = -(-CHECK_COLS // block)
            got = kernel(matrix, *fit, k, block)
            want = plain(head, *fit, CHECK_COLS, block)
            for g, p in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                g = g[:, :nb] if name == "scm_sweep_sbmax" else g[:nb]
                if not torch.equal(g, p):
                    raise AssertionError("%s differs from its plain version "
                                         "(%s)" % (name, case))
            torch.cuda.synchronize()
            before = dict(_build.launches)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                kernel(matrix, *fit, k, block)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / args.reps
            least, by = bound_ms(w, k, f, -(-k // block), out_bytes)
            launches = {key: _build.launches[key] - before.get(key, 0)
                        for key in _build.launches
                        if key.startswith("scm_sweep")}
            print(json.dumps({
                "repo": repo, "case": case, "kernel": name, "W": w, "K": k,
                "F": f, "block": block, "ms": ms, "bound_ms": least,
                "bound_by": by, "share": least / ms, "reps": args.reps,
                "launches": launches, "card": card}), flush=True)
        del matrix, head
        torch.cuda.empty_cache()
    log = _build.BUILD_LOG.get("scm_sweep", "")
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "scm_sweep_kernel" in line:
            print(json.dumps({"ptxas": [line.strip()] + [
                x.strip() for x in lines[i + 1:i + 4]
                if "Compiling" not in x]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
