#!/usr/bin/env python3
"""Time variants of the hybrid radix sort and the multiway merge
(``grm_tpu_torch/csrc/sort.cu``) on one NVIDIA GPU. A variant is a copy of
the source, in a temporary directory, with one or more of its lines changed
(the local sort's threads, blocks an SM and rows a thread, the scatter's
tiles a chunk and blocks an SM, the count's histogram copies, the merge's
tile), built by ``nvcc`` with the port's flags. ``no-local-passes``
skips the local sort's passes and so sorts wrongly: it is timed, never
checked. Every other variant is first held exactly against
``sort_keys_plain`` / ``merge_keys_plain``, then timed at three shapes:

- one batch of ``ingest-device``: 32 genomes of 4,403,200 random codes
  (the last 4096 invalid), their k = 31 sort keys: 140.9M keys;
- one genome of them (4,403,200 keys), the sort ``create-contigs`` runs
  342 times;
- the union merge: 11 segments of 2^24 rows, 8,763,561 + s valid in
  segment s, random sorted k-mers of k = 31 (96.4M of 184.5M rows), by
  ``merge_keys`` (by ``sort_keys(segments=)`` in a checkout without it).

    python3 scripts/time_sort_variants.py [NAME ...]

With no argument every variant of VARIANTS runs. Prints one JSON line per
variant: ms a call by CUDA events at each shape beside torch.sort of the
same keys (measured in the same process), the device ms of the kernels by
torch.profiler, the local and scatter kernels' registers and spills
(``ptxas``), and the card's ``nvidia-smi`` name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Each variant: the source's lines it changes, (old, new), each old line
# found exactly once.
LOCAL_THREADS = "constexpr int kLocalThreads = 1024;"
LOCAL_BLOCKS = "constexpr int kLocalBlocks = 1;"
LOCAL_STEPS = "return P == 1 ? 12 : (P == 2 ? 8 : (P == 3 ? 6 : 4));"
CHUNK = "constexpr int kChunkTiles = 4;"
COPIES = "constexpr int kCountCopies = 4;"
SCATTER_BLOCKS = "constexpr int kScatterBlocks = 3;"
MERGE_TILE = "return P == 1 ? 4096 : (P == 4 ? 1024 : 2048);"
VARIANTS = {
    "default": [],
    "local-512x2": [(LOCAL_THREADS, LOCAL_THREADS.replace("1024", "512")),
                    (LOCAL_BLOCKS, LOCAL_BLOCKS.replace("1", "2"))],
    "local-steps-10": [(LOCAL_STEPS, LOCAL_STEPS.replace("12", "10"))],
    "chunk-tiles-8": [(CHUNK, CHUNK.replace("4", "8"))],
    "count-copies-16": [(COPIES, COPIES.replace("4", "16"))],
    "scatter-blocks-2": [(SCATTER_BLOCKS, SCATTER_BLOCKS.replace("3", "2"))],
    "merge-tile-2048": [(MERGE_TILE, MERGE_TILE.replace("4096", "2048"))],
    "no-local-passes": [("    for (int j = 0; j <= top; ++j) {\n",
                         "    for (int j = 0; j < 0; ++j) {\n")],
}
FUNCTIONS = ("sort_count_kernel", "sort_scan_kernel", "sort_scatter_kernel",
             "sort_local_kernel", "merge_setup_kernel", "merge_corank_kernel",
             "merge_tile_kernel")


def build(names, out_dir):
    """The variants' libraries, compiled in parallel: {name: (path, log)}."""
    from grm_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    source = (_build.CSRC / "sort.cu").read_text()
    jobs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise ValueError("%s: %r is not in sort.cu once" % (name, old))
            text = text.replace(old, new)
        src = os.path.join(out_dir, "sort-%s.cu" % name)
        with open(src, "w") as f:
            f.write(text)
        path = os.path.join(out_dir, "libsort-%s.so" % name)
        # The copy includes nothing from csrc/ (sort.cu includes no header of
        # its own), so it builds from anywhere.
        jobs[name] = (path, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", path, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, log))
        built[name] = (path, log)
    return built


def use(path):
    """Make ``sort_keys`` and ``merge_keys`` launch the library at
    ``path``."""
    from grm_tpu_torch.ops import _build
    from grm_tpu_torch.ops import kmer as km

    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in km._SORT_SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _build._LIBS["sort"] = lib


def merge_call(km, keys, segments):
    """The union merge's call of this checkout's ``ops/kmer``."""
    if hasattr(km, "merge_keys"):
        return lambda: km.merge_keys(keys, segments)
    return lambda: km.sort_keys(keys, segments=segments)


def shapes(device):
    """(batch keys, one genome's keys, (merge keys, segments)) on the
    card, the merge's valid prefixes sorted."""
    import numpy as np
    import torch

    from grm_tpu_torch.ops import kmer as km

    gen = torch.Generator(device=device).manual_seed(0)
    codes = torch.randint(0, 4, (32, 4_403_200), dtype=torch.int8,
                          device=device, generator=gen)
    codes[:, -4096:] = 4
    batch = km.kmer_canon(codes, 31, key=True).view(1, -1)
    genome = batch[:, :4_403_200].contiguous()
    del codes
    parts, segments = [], []
    for s in range(11):
        w = torch.randint(-2**31, 2**31, (2**24, 2), dtype=torch.int64,
                          device=device, generator=gen).to(torch.int32)
        w[:, 1] &= int(np.int32(np.uint32(0xFFFFFFFC)))  # k = 31: 62 bits
        count = 8_763_561 + s
        keys = km.pair_keys(w.T, torch.arange(2**24, device=device) < count)
        keys[0, :count] = torch.sort(keys[0, :count])[0]
        parts.append(keys)
        segments.append((2**24, torch.tensor([count], dtype=torch.int32,
                                             device=device)))
    return batch, genome, (torch.cat(parts, 1), segments)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    import torch

    if not torch.cuda.is_available():
        print("time_sort_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    from grm_tpu_torch.ops import kmer as km

    names = argv or list(VARIANTS)
    device = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    with tempfile.TemporaryDirectory() as tmp:
        built = build(names, tmp)
        batch, genome, (merge, segments) = shapes(device)
        valid = km._segment_valid(merge, segments)
        want = {"batch": km.sort_keys_plain(batch),
                "genome": km.sort_keys_plain(genome),
                "merge": km.sort_keys_plain(merge, valid)}
        del valid
        library = {"batch": cs.time_cuda(
                       lambda: torch.sort(batch[0], stable=True), 5),
                   "genome": cs.time_cuda(
                       lambda: torch.sort(genome[0], stable=True), 20),
                   "merge": cs.time_cuda(
                       lambda: torch.sort(merge[0], stable=True), 3)}
        for name, (path, log) in built.items():
            use(path)
            calls = {"batch": (lambda: km.sort_keys(batch), 5),
                     "genome": (lambda: km.sort_keys(genome), 20),
                     "merge": (merge_call(km, merge, segments), 5)}
            row = {"variant": name, "changes": VARIANTS[name]}
            for shape, (call, reps) in calls.items():
                if name != "no-local-passes":
                    err = cs.exact_err(call(), want[shape])
                    if err != 0.0:
                        raise AssertionError("%s differs from the plain "
                                             "version at %s" % (name, shape))
                ms = cs.time_cuda(call, reps)
                kernel_ms, _ = cs.device_ms(call, reps, FUNCTIONS)
                row[shape] = {"ms": ms, "kernel_ms": kernel_ms,
                              "torch_sort_ms": library[shape],
                              "share_of_torch_sort": ms / library[shape]}
            row["ptxas"] = [list(r) for r in cs.ptxas_summary(log)
                            if r[0] in ("sort_local_kernel<1>",
                                        "sort_scatter_kernel<1, 0>")]
            row["card"] = card
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
