#!/usr/bin/env python3
"""Time the device ingest's per-batch kernels (``kmer_canon``'s sort key,
``build_columns``) of one checkout on one NVIDIA GPU at ``chip_smoke.py``
phase 6's shapes: the first batch of ``ingest-device`` (32 of the 342
genomes of 4.4 Mbp that ``chip_smoke.ingest_genomes`` makes from seed 0,
padded with 4s to a multiple of 4096 codes as the batched builder pads
them: 140.9M windows, k = 31), then that batch's windows sorted and built
into columns with a budget of 2^24 (``build_columns``, one launch of
``build_columns_tile_kernel``). Each kernel is held against its plain
version first (exact), and the build's ``ptxas`` registers and spills of
the ``kmer`` and ``device_build`` libraries are printed.

    python3 scripts/time_ingest_kernels.py [--repo DIR]

``--repo`` names the checkout whose package and ``chip_smoke.py`` helpers
are used (default: the one holding this script), so that two versions of
the kernels compare inside one machine: parent, change, change, parent.
Prints one JSON line per kernel: device ms per call from torch.profiler
(the kernel functions' own time), CUDA events around the wrapper beside
it, ``bound_ms`` (inputs read once and outputs written once at 3.35
TB/s) and the card's ``nvidia-smi`` name and power limit.
"""

import argparse
import json
import os
import sys

REPS = {"kmer_canon": 20, "build_columns": 5}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_ingest_kernels: CUDA is not available", file=sys.stderr)
        return 2
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    os.chdir(repo)
    import chip_smoke as cs

    from grm_tpu_torch.ops import _build
    from grm_tpu_torch.ops import device_build as db
    from grm_tpu_torch.ops import kmer as km

    _build.build_all()
    for source in ("kmer", "device_build"):
        for function, regs, spills in cs.ptxas_summary(
                _build.BUILD_LOG.get(source, "")):
            print(json.dumps({"repo": repo, "source": source,
                              "ptxas": function, "registers": int(regs),
                              "spills": spills}), flush=True)
    device = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    k = cs.INGEST_K
    codes_list, _, _ = cs.ingest_genomes(
        cs.INGEST_GENOMES, cs.INGEST_LENGTH, cs.INGEST_SNPS, cs.INGEST_POOL, 0)
    batch = codes_list[:cs.INGEST_BATCH]
    del codes_list
    n_cols = -(-max(max(len(c) for c in batch), k) // 4096) * 4096
    codes = torch.full((len(batch), n_cols), 4, dtype=torch.int8)
    for i, c in enumerate(batch):
        codes[i, :len(c)] = torch.from_numpy(c)
    codes = codes.to(device)
    n = codes.numel()

    def row(name, kernel, plain, nbytes, shape):
        err = cs.exact_err(kernel(), plain())
        if err != 0.0:
            raise AssertionError("%s differs from its plain version (%r)"
                                 % (name, err))
        ms, timed_by = cs.device_ms(kernel, REPS[name],
                                    cs.KERNEL_FUNCTIONS[name])
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        print(json.dumps({"repo": repo, "kernel": name, "shape": shape,
                          "ms": ms, "timed_by": timed_by,
                          "event_ms": cs.time_cuda(kernel, REPS[name]),
                          "bound_ms": bound, "share": bound / ms,
                          "max_abs_err": err, "card": card}), flush=True)

    row("kmer_canon", lambda: km.kmer_canon(codes, k, key=True),
        lambda: km.kmer_canon_plain(codes, k, key=True), n * (1 + 8),
        "G=%d L=%d k=%d (the sort key)" % (len(batch), n_cols, k))
    keys, _ = km.window_keys(codes, k)
    del codes
    keys, perm, _ = km.sort_keys(keys)
    nw, bucket = km.n_words_for_k(k), cs.INGEST_BUDGET
    row("build_columns",
        lambda: db.build_columns(keys, perm, None, nw, n_cols, bucket),
        lambda: db.build_columns_plain(keys, perm, None, nw, n_cols, bucket),
        16 * n + 4 * bucket * (-(-len(batch) // 32) + nw) + 4,
        "%d sorted rows, k_budget %d" % (n, bucket))
    return 0


if __name__ == "__main__":
    sys.exit(main())
