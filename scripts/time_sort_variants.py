#!/usr/bin/env python3
"""Time variants of the radix sort (``grm_tpu_torch/csrc/sort.cu``) on one
NVIDIA GPU. A variant is a copy of the source, in a temporary directory,
with one or more of its constants changed (the digit width, the look-back's
window, the rows a thread takes, the blocks an SM), built by ``nvcc``
with the port's flags. ``no-lookback`` skips the look-back and so sorts
wrongly: it is timed, never checked. Every other variant is first held
exactly against ``sort_keys_plain``, then timed at two shapes:

- one batch of ``ingest-device``: 32 genomes of 4,403,200 random codes
  (the last 4096 invalid), their k = 31 sort keys: 140.9M keys;
- the union merge: 11 segments of 2^24 rows, 8,763,561 + s valid in
  segment s, random k-mers of k = 31, sorted by segments (96.4M of
  184.5M rows).

    python3 scripts/time_sort_variants.py [NAME ...]

With no argument every variant of VARIANTS runs (the port's source, wider
digits, other look-back windows, tiles and blocks an SM, no look-back).
Prints one JSON line per variant: ms a call by CUDA events at each shape
beside torch.sort of the same keys (measured in the same process), the
device ms of the sort's kernels by torch.profiler, the pass kernel's
registers and spills (``ptxas``), and the card's ``nvidia-smi`` name and
power limit.
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
DIGITS = "constexpr int kDigitBits = 8;"
WINDOW = "constexpr int kLookback = 1;"
BLOCKS = "constexpr int kSortBlocks = 3;"
ITEMS = "return P == 1 ? 16 : (P == 2 ? 8 : 4);"
VARIANTS = {
    "default": [],
    "digits-9": [(DIGITS, DIGITS.replace("8", "9"))],
    "digits-10": [(DIGITS, DIGITS.replace("8", "10"))],
    "digits-11": [(DIGITS, DIGITS.replace("8", "11"))],
    "lookback-2": [(WINDOW, WINDOW.replace("1;", "2;"))],
    "lookback-8": [(WINDOW, WINDOW.replace("1;", "8;"))],
    "lookback-32": [(WINDOW, WINDOW.replace("1;", "32;"))],
    "blocks-2": [(BLOCKS, BLOCKS.replace("3", "2"))],
    "items-12": [(ITEMS, "return P == 1 ? 12 : (P == 2 ? 8 : 4);")],
    "no-lookback": [("bool any = tile > 0;", "bool any = false;")],
}
FUNCTIONS = ("sort_hist_kernel", "sort_scan_kernel", "sort_pass_kernel",
             "sort_tail_kernel")


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
    """Make ``sort_keys`` launch the library at ``path``."""
    from grm_tpu_torch.ops import _build
    from grm_tpu_torch.ops import kmer as km

    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in km._SORT_SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _build._LIBS["sort"] = lib


def shapes(device):
    """(batch keys, (merge keys, segments)) on the card."""
    import numpy as np
    import torch

    from grm_tpu_torch.ops import kmer as km

    gen = torch.Generator(device=device).manual_seed(0)
    codes = torch.randint(0, 4, (32, 4_403_200), dtype=torch.int8,
                          device=device, generator=gen)
    codes[:, -4096:] = 4
    batch = km.kmer_canon(codes, 31, key=True).view(1, -1)
    del codes
    words, segments = [], []
    for s in range(11):
        w = torch.randint(-2**31, 2**31, (2**24, 2), dtype=torch.int64,
                          device=device, generator=gen).to(torch.int32)
        w[:, 1] &= int(np.int32(np.uint32(0xFFFFFFFC)))  # k = 31: 62 bits
        words.append(w)
        segments.append((2**24, torch.tensor([8_763_561 + s],
                                             dtype=torch.int32,
                                             device=device)))
    words = torch.cat(words)
    valid = torch.cat([torch.arange(2**24, device=device) < c
                       for _, c in segments])
    return batch, (km.pair_keys(words.T, valid), segments)


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
        batch, (merge, segments) = shapes(device)
        want_batch = km.sort_keys_plain(batch)
        want_merge = km.sort_keys_plain(merge)
        library = {"batch": cs.time_cuda(
                       lambda: torch.sort(batch[0], stable=True), 5),
                   "merge": cs.time_cuda(
                       lambda: torch.sort(merge[0], stable=True), 3)}
        for name, (path, log) in built.items():
            use(path)
            calls = {"batch": (lambda: km.sort_keys(batch), want_batch, 5),
                     "merge": (lambda: km.sort_keys(merge,
                                                    segments=segments),
                               want_merge, 3)}
            row = {"variant": name, "changes": VARIANTS[name]}
            for shape, (call, want, reps) in calls.items():
                if name != "no-lookback":
                    err = cs.exact_err(call(), want)
                    if err != 0.0:
                        raise AssertionError("%s differs from the plain "
                                             "version at %s" % (name, shape))
                ms = cs.time_cuda(call, reps)
                kernel_ms, _ = cs.device_ms(call, reps, FUNCTIONS)
                row[shape] = {"ms": ms, "kernel_ms": kernel_ms,
                              "torch_sort_ms": library[shape],
                              "share_of_torch_sort": ms / library[shape]}
            row["ptxas"] = [list(r) for r in cs.ptxas_summary(log)
                            if r[0] == "sort_pass_kernel<1>"]
            row["card"] = card
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
