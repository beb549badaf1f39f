#!/usr/bin/env python3
"""Time dataset creation from contigs on one NVIDIA GPU, with glibc's
allocator thresholds raised (``grm_tpu_torch.hostmem``, as the k-mer
counters raise them) and without (``GRM_NO_MALLOC_TUNE=1``).

The input is ``chip_smoke.py``'s ``create-contigs`` path: ``ingest-device``'s
genomes (342 of 4.4 Mbp that ``chip_smoke.ingest_genomes`` makes from
``--seed``), written once as one-contig FASTA files with their labels as a
metadata TSV (set-up, in no number). Each run is a fresh process that
counts one genome to warm the card, then calls ``from_contigs`` (k = 31,
the singleton filter) into a ``MemoryArtifact`` ``--reps`` times. The
runs alternate: tuned, untuned, untuned, tuned.

    python3 scripts/time_create.py [--seed 0] [--reps 2] [--genomes 342]

Prints one JSON line per ``from_contigs`` call: whether the thresholds
were raised, the stage walls (FASTA encode, counting on the card with its
transfers, host merge, artifact write) and the whole call's, the union's
size, the process's peak RSS before the first call and after this one,
and the card's ``nvidia-smi`` name and power limit.
"""

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = (True, False, False, True)  # tuned, untuned, untuned, tuned


def child(args):
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from grm_tpu_torch import hostmem
    from grm_tpu_torch.dataset import MemoryArtifact, from_contigs
    from grm_tpu_torch.kmer.counter import count_fasta

    tuned = hostmem.tune_host_allocator()
    card = cs.nvidia_smi("name,power.limit")
    with open(args.listing) as f:
        first = f.readline().split()[1]
    count_fasta(first, cs.INGEST_K, device="cuda")  # build, warm the card
    torch.cuda.synchronize()
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    for rep in range(args.reps):
        timings = {}
        t0 = time.perf_counter()
        mem = from_contigs(args.listing, MemoryArtifact(), cs.INGEST_K,
                           filter_singleton=True,
                           phenotype_description="planted markers",
                           phenotype_metadata_path=args.meta,
                           device="cuda", timings=timings)
        wall = time.perf_counter() - t0
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        print(json.dumps({
            "tuned": tuned, "rep": rep, "from_contigs_s": wall,
            "encode_s": timings["encode"], "count_s": timings["count"],
            "merge_s": timings["merge"], "write_s": timings["write"],
            "n_kmers": int(mem["kmer_sequences"].shape[0]),
            "peak_rss_gb_before": rss0 / 1e6, "peak_rss_gb": rss / 1e6,
            "card": card}), flush=True)
        del mem


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--genomes", type=int, default=None)
    parser.add_argument("--listing", help=argparse.SUPPRESS)
    parser.add_argument("--meta", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.listing:
        child(args)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_create: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    n_genomes = args.genomes or cs.INGEST_GENOMES
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        codes_list, labels, _ = cs.ingest_genomes(
            n_genomes, cs.INGEST_LENGTH, cs.INGEST_SNPS, cs.INGEST_POOL,
            args.seed)
        specs = cs.write_fasta(tmp, codes_list, cut=False)
        listing, meta = cs.write_lists(tmp, specs, labels, "contigs")
        del codes_list
        print("time_create: %d genomes x %d bp written in %.1f s (set-up)"
              % (n_genomes, cs.INGEST_LENGTH, time.time() - t0), flush=True)
        for tuned in ORDER:
            env = dict(os.environ)
            env.pop("GRM_NO_MALLOC_TUNE", None)
            if not tuned:
                env["GRM_NO_MALLOC_TUNE"] = "1"
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--reps", str(args.reps), "--listing", listing,
                            "--meta", meta], env=env, check=True,
                           timeout=1800)
    return 0


if __name__ == "__main__":
    sys.exit(main())
