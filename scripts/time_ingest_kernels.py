#!/usr/bin/env python3
"""Time the device ingest's hand kernels of one checkout on one NVIDIA GPU
at ``chip_smoke.py`` phase 6's shapes: ``ingest-device``'s genomes (342 of
4.4 Mbp that ``chip_smoke.ingest_genomes`` makes from seed 0), k = 31,
batches of 32 padded with 4s to a multiple of 4096 codes as the batched
builder pads them, budgets of 2^24:

- ``kmer_canon``'s sort key on the first batch (140.9M windows);
- ``radix_sort`` on those keys, on the first genome's alone (4.4M keys,
  the sort ``create-contigs`` runs a genome) and on the batch's k = 33
  keys (two planes with validity); the union merge of the 11 batches'
  unions (184.5M rows in 11 segments, 96.4M valid) by ``merge_keys``, or
  by ``radix_sort`` with segments in a checkout without it; each beside
  torch.sort of the same keys (``library_ms``, none at k = 33), its bytes
  bound and the bytes of its design (``bound_ms_design``:
  ``chip_smoke.sort_design_bytes`` and ``merge_bytes``, or the older
  ``sort_pass_bytes``);
- ``build_columns`` on the batch's sorted windows;
- ``merge_columns`` on the merge sort of the 11 batches' unions (184.5M
  rows, most of them bucket padding), to the final (11, 2^24) matrix;
- ``compact_columns`` (the singleton filter) on that merged matrix.

Each kernel is held against its plain version first (exact), and the
build's ``ptxas`` registers and spills of the ``kmer``, ``sort`` and
``device_build`` libraries are printed. Last, ``ingest-device``'s batched
build itself (``build_matrix_device_batched`` as ``chip_smoke.ingest_path``
calls it, the singleton filter on): its wall three times, each ending in a
synchronize, then one profiled build's device time, that of the sorts
(every kernel whose name holds "sort", the hand sort's or torch.sort's,
and the merge's kernels) and the busy share.

    python3 scripts/time_ingest_kernels.py [--repo DIR]

``--repo`` names the checkout whose package and ``chip_smoke.py`` helpers
are used (default: the one holding this script), so that two versions of
the kernels compare inside one machine: parent, change, change, parent. A
checkout whose ``ops/device_build`` has no ``merge_columns`` entry is
timed the way its own phase 6 timed it: ``merge_ranks``, a zeroed final
matrix and one ``scatter_batch_columns`` a batch; one whose ``ops/kmer``
has no ``sort_keys_plain`` sorts with torch.sort (timed by CUDA events
under the name ``radix_sort``, against itself).
Prints one JSON line per kernel: device ms per call from torch.profiler
(the kernel functions' own time), CUDA events around the wrapper beside
it (output fills and scratch zeroing included), ``bound_ms`` (the bytes
the inputs need read once and the outputs written once, at 3.35 TB/s:
the merge's valid rows, the filter's live columns; ``bound_ms_whole``
counts every row or column instead) and the card's ``nvidia-smi`` name
and power limit.
"""

import argparse
import json
import os
import sys

REPS = {"kmer_canon": 20, "radix_sort": 5, "radix_sort:genome": 20,
        "radix_sort:k33": 3, "radix_sort:merge": 3, "merge_keys": 5,
        "build_columns": 5, "merge_columns": 5, "compact_columns": 20}
# The union merge's kernels (named apart from the sort's).
MERGE_FUNCTIONS = ("merge_setup_kernel", "merge_corank_kernel",
                   "merge_tile_kernel")


def merge_entry(db, keys, perm, batches, nw, k_budget, w_total):
    """(kernel, plain) callables of the union merge of ``batches``
    ((matrix, union, count, first genome) each) for this checkout's
    ``ops/device_build``."""
    import torch

    if hasattr(db, "merge_columns"):
        merged = [(b[0], b[3] // 32) for b in batches]
        return (lambda: db.merge_columns(keys, perm, None, merged, nw,
                                         k_budget, w_total),
                lambda: db.merge_columns_plain(keys, perm, None, merged, nw,
                                               k_budget, w_total))

    def composed(ranks, scatter):
        dest, union, n_merged = ranks(keys, perm, None, nw, k_budget)
        final = torch.zeros((w_total, k_budget), dtype=torch.int32,
                            device=keys.device)
        off = 0
        for b_matrix, _, _, lo in batches:
            bucket = b_matrix.shape[1]
            scatter(final, b_matrix, dest[off:off + bucket], lo // 32)
            off += bucket
        return final, union, n_merged

    return (lambda: composed(db.merge_ranks, db.scatter_batch_columns),
            lambda: composed(db.merge_ranks_plain,
                             db.scatter_batch_columns_plain))


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

    _build.build_all()
    for source in ("kmer", "sort", "device_build"):
        for function, regs, spills in cs.ptxas_summary(
                _build.BUILD_LOG.get(source, "")):
            print(json.dumps({"repo": repo, "source": source,
                              "ptxas": function, "registers": int(regs),
                              "spills": spills}), flush=True)
    card = cs.nvidia_smi("name,power.limit")
    codes_list = time_rows(cs, torch.device("cuda"), card, repo)
    time_build(cs, codes_list, torch.device("cuda"), card, repo)
    return 0


def time_build(cs, codes_list, device, card, repo):
    """``ingest-device``'s batched build: three walls, then one profiled
    build's device time (all, the sorts', busy share of its wall)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from grm_tpu_torch.parallel.device_build import build_matrix_device_batched

    def build():
        torch.cuda.synchronize()
        t0 = time.time()
        dm = build_matrix_device_batched(
            codes_list, cs.INGEST_K, k_budget=cs.INGEST_BUDGET,
            genome_batch=cs.INGEST_BATCH, batch_budget=cs.INGEST_BUDGET,
            filter_singleton=True, device=device)
        torch.cuda.synchronize()
        return time.time() - t0, dm.n_kmers

    walls = [build() for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, n_kmers = build()
    rows = [(cs._device_us(e) / 1e3, e.key) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and cs._device_us(e) > 0]
    total = sum(ms for ms, _ in rows)
    sorts = sum(ms for ms, key in rows if "sort" in key.lower()
                or any(f + "(" in key or f + "<" in key
                       for f in MERGE_FUNCTIONS))
    print(json.dumps({"repo": repo, "build_walls_s": [w for w, _ in walls],
                      "n_kmers": n_kmers, "profiled_wall_s": wall,
                      "device_ms": total, "sorts_ms": sorts,
                      "busy": total / 1e3 / wall, "card": card}),
          flush=True)


def time_rows(cs, device, card, repo):
    """The kernel rows, with ``cs`` the checkout's ``chip_smoke`` module;
    returns the genomes' codes."""
    import torch

    from grm_tpu_torch.ops import device_build as db
    from grm_tpu_torch.ops import kmer as km
    from grm_tpu_torch.parallel import device_build as pdb

    k = cs.INGEST_K
    codes_list, _, _ = cs.ingest_genomes(
        cs.INGEST_GENOMES, cs.INGEST_LENGTH, cs.INGEST_SNPS, cs.INGEST_POOL, 0)
    batch = codes_list[:cs.INGEST_BATCH]
    n_cols = -(-max(max(len(c) for c in batch), k) // 4096) * 4096
    codes = torch.full((len(batch), n_cols), 4, dtype=torch.int8)
    for i, c in enumerate(batch):
        codes[i, :len(c)] = torch.from_numpy(c)
    codes = codes.to(device)
    n = codes.numel()

    def row(name, kernel, plain, nbytes, shape, library=None, **more):
        err = cs.exact_err(kernel(), plain())
        if err != 0.0:
            raise AssertionError("%s differs from its plain version (%r)"
                                 % (name, err))
        function = cs.KERNEL_FUNCTIONS.get(name.split(":")[0])
        if function is None:  # a checkout that sorts with torch.sort
            ms, timed_by = cs.time_cuda(kernel, REPS[name]), "cuda events"
        else:
            ms, timed_by = cs.device_ms(kernel, REPS[name], function)
        if library is not None:
            more["library_ms"] = cs.time_cuda(library, REPS[name])
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        more = {key: (v / cs.HBM_BYTES_PER_S * 1e3 if key.startswith("bound")
                      else v) for key, v in more.items()}
        print(json.dumps({"repo": repo, "kernel": name, "shape": shape,
                          "ms": ms, "timed_by": timed_by,
                          "event_ms": cs.time_cuda(kernel, REPS[name]),
                          "bound_ms": bound, "share": bound / ms, **more,
                          "max_abs_err": err, "card": card}), flush=True)

    row("kmer_canon", lambda: km.kmer_canon(codes, k, key=True),
        lambda: km.kmer_canon_plain(codes, k, key=True), n * (1 + 8),
        "G=%d L=%d k=%d (the sort key)" % (len(batch), n_cols, k))
    keys, _ = km.window_keys(codes, k)
    plain_sort = getattr(km, "sort_keys_plain", km.sort_keys)

    def design(n_pairs, rows, with_valid):
        if hasattr(cs, "sort_design_bytes"):
            return cs.sort_design_bytes(n_pairs, rows, with_valid)
        return cs.sort_pass_bytes(k, rows, rows) \
            if hasattr(cs, "sort_pass_bytes") else 0

    row("radix_sort", lambda: km.sort_keys(keys), lambda: plain_sort(keys),
        24 * n, "%d int64 keys (one batch)" % n,
        library=lambda: torch.sort(keys[0], stable=True),
        bound_ms_design=design(1, n, False))
    gkeys, _ = km.window_keys(torch.from_numpy(codes_list[0][None]).to(device),
                              k)
    g = gkeys.shape[1]
    row("radix_sort:genome", lambda: km.sort_keys(gkeys),
        lambda: plain_sort(gkeys), 24 * g, "%d int64 keys (one genome)" % g,
        library=lambda: torch.sort(gkeys[0], stable=True),
        bound_ms_design=design(1, g, False))
    del gkeys
    k33, v33 = km.window_keys(codes, 33)
    row("radix_sort:k33", lambda: km.sort_keys(k33, v33),
        lambda: plain_sort(k33, v33), 42 * n,
        "%d keys of two int64 planes with validity (k = 33)" % n,
        bound_ms_design=design(2, n, True))
    del k33, v33, codes
    keys, perm, _ = km.sort_keys(keys)
    nw, bucket = km.n_words_for_k(k), cs.INGEST_BUDGET
    row("build_columns",
        lambda: db.build_columns(keys, perm, None, nw, n_cols, bucket),
        lambda: db.build_columns_plain(keys, perm, None, nw, n_cols, bucket),
        16 * n + 4 * bucket * (-(-len(batch) // 32) + nw) + 4,
        "%d sorted rows, k_budget %d" % (n, bucket))
    del keys, perm

    batches = [pdb._build_codes(codes_list[lo:lo + cs.INGEST_BATCH], k,
                                bucket, device) + (lo,)
               for lo in range(0, len(codes_list), cs.INGEST_BATCH)]
    words = torch.cat([b[1] for b in batches])
    valids = torch.cat([torch.arange(bucket, device=device) < b[2]
                        for b in batches])
    mkeys = km.pair_keys(words.T, valids)
    del words, valids
    r = mkeys.shape[1]
    valid_rows = sum(int(b[2]) for b in batches)
    segments = [(bucket, b[2]) for b in batches]
    shape = "%d batches x %d union rows, %d valid" % (len(batches), bucket,
                                                      valid_rows)
    if hasattr(km, "merge_keys"):
        merge_sort = lambda: km.merge_keys(mkeys, segments)
        row("merge_keys", merge_sort,
            lambda: km.merge_keys_plain(mkeys, segments),
            cs.merge_bytes(1, r, valid_rows), shape,
            library=lambda: torch.sort(mkeys[0], stable=True),
            bound_ms_all_rows=cs.merge_bytes(1, r, r),
            bound_ms_design=cs.merge_bytes(1, r, valid_rows))
    else:
        if hasattr(km, "sort_keys_plain"):
            merge_sort = lambda: km.sort_keys(mkeys, segments=segments)
        else:
            merge_sort = lambda: km.sort_keys(mkeys)
        row("radix_sort:merge", merge_sort, lambda: plain_sort(mkeys),
            24 * valid_rows + 16 * (r - valid_rows), shape + ", by segments",
            library=lambda: torch.sort(mkeys[0], stable=True),
            bound_ms_all_rows=24 * r,
            bound_ms_design=(cs.sort_pass_bytes(k, r, valid_rows)
                             if hasattr(cs, "sort_pass_bytes") else 0))
    mkeys, mperm, _ = merge_sort()
    w_total = -(-len(codes_list) // 32)
    kernel, plain = merge_entry(db, mkeys, mperm, batches, nw, bucket,
                                w_total)
    out_bytes = 4 * bucket * (nw + w_total) + 4
    word_bytes = sum(4 * b[0].shape[0] * int(b[2]) for b in batches)
    row("merge_columns", kernel, plain,
        16 * valid_rows + word_bytes + out_bytes,
        "%d batches x %d union rows, %d valid, k_budget %d"
        % (len(batches), bucket, valid_rows, bucket),
        bound_ms_whole=20 * r + out_bytes)
    final, union, n_merged = kernel()
    del batches, mkeys, mperm, kernel, plain
    live, width = int(n_merged.item()), w_total + nw
    row("compact_columns", lambda: db.compact_columns(final, union, n_merged),
        lambda: db.compact_columns_plain(final, union, n_merged),
        4 * width * live + 4 * bucket * width + 8,
        "W=%d K=%d, %d live columns" % (w_total, bucket, live),
        bound_ms_whole=2 * 4 * bucket * width + 8)
    return codes_list


if __name__ == "__main__":
    sys.exit(main())
