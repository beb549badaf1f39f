"""ctypes bindings of the port's host library ``native/grmio.cpp``.

Port of the part of ``grm_tpu/native/bindings.py`` that the port's ingest
calls (FASTA/FASTQ encoding and the fused union merge), under the same
names, with two differences:

- The library is built with ``g++`` (the flags of
  ``grm_tpu/native/Makefile``) at first use into ``grm_tpu_torch/_kernels/``
  (listed in ``.gitignore``), under a name keyed by a hash of the source,
  the flags, the compiler's version and the target that ``-march=native``
  resolves to, so an edited source, another compiler or another host CPU
  rebuilds. It is written under a unique temporary name and moved into
  place, and a lock serialises the build within a process, so several
  processes and threads may ask for it at once. ``grm_tpu``'s
  ``libgrmio.so`` is never loaded.
- There is no silent fallback. A failed build raises with the compiler's
  output wherever the native route is taken; the numpy versions run only
  when a caller asks for them (``engine="numpy"``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


__all__ = [
    "library",
    "encode_fasta_native",
    "merge_union_bits_native",
    "merge_union_bits_parallel",
]

SOURCE = Path(__file__).resolve().parent / "grmio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_kernels"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")
_lib = None
_lib_lock = threading.Lock()


def _cxx():
    return os.environ.get("CXX") or "g++"


def _run(cmd):
    """(returncode, stdout + stderr) of ``cmd``; a missing program raises."""
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError("cannot run %s: %s (the port's host library "
                           "needs a C++ compiler; set CXX)" % (cmd[0], e))
    return r.returncode, r.stdout + r.stderr


def _lib_path():
    """Where the library of this source, compiler, flags and target lives."""
    cxx = _cxx()
    digest = hashlib.sha256(SOURCE.read_bytes())
    for probe in ([cxx, "--version"],
                  [cxx, *CXX_FLAGS[:2], "-Q", "--help=target"]):
        rc, out = _run(probe)
        if rc != 0:
            raise RuntimeError("%s failed (exit %d):\n%s"
                               % (" ".join(probe), rc, out))
        digest.update(out.encode())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / ("libgrmio-%s.so" % digest.hexdigest()[:16])


def library():
    """The loaded library, built first if this source, compiler, flags and
    target have no build yet. Raises RuntimeError with the compiler's
    output if the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            _lib = _build_and_load()
    return _lib


def _build_and_load():
    path = _lib_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=path.name + ".", suffix=".tmp",
                                   dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [_cxx(), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
            rc, out = _run(cmd)
            if rc != 0:
                raise RuntimeError("building the host library failed "
                                   "(exit %d):\n%s\n%s"
                                   % (rc, " ".join(cmd), out))
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(path))
    _register(lib)
    return lib


def _register(lib):
    u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    long_, int_ = ctypes.c_long, ctypes.c_int
    signatures = {
        "grm_encode_fasta": ([ctypes.c_char_p, long_, i8], long_),
        "grm_encode_fastq": ([ctypes.c_char_p, long_, i8], long_),
        # list addresses, sizes, n lists, nw, union, counts, matrix,
        # capacity, matrix row stride
        "grm_merge_union_bits64": ([u64, i64, int_, int_, u32, i32, u64,
                                    long_, long_], long_),
        "grm_merge_union_bits_rows": ([u64, i64, int_, int_, u32, i32, u64,
                                       long_, long_], long_),
        "grm_compact_rows": ([u64, long_, long_, long_, long_], None),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def encode_fasta_native(text, fastq=False):
    """FASTA/FASTQ text (str or bytes) -> int8 codes with separators."""
    lib = library()
    if isinstance(text, str):
        text = text.encode("ascii")
    out = np.empty(len(text), dtype=np.int8)
    fn = lib.grm_encode_fastq if fastq else lib.grm_encode_fasta
    n = fn(text, len(text), out)
    return out[:n].copy()


def _rows(kmer_lists, nw):
    return [np.ascontiguousarray(np.asarray(a, np.uint32).reshape(-1, nw))
            for a in kmer_lists]


def _bits_kernel(lib, nw):
    if nw <= 2:
        return lib.grm_merge_union_bits64, "grm_merge_union_bits64"
    return lib.grm_merge_union_bits_rows, "grm_merge_union_bits_rows"


def merge_union_bits_native(kmer_lists, nw):
    """Fully fused dsk2kover role for nw in [1, 8]: one loser-tree pass
    emits the sorted distinct union, per-union genome counts and the packed
    uint64 presence matrix. Outputs are views over capacity-sized buffers
    whose untouched pages cost nothing.

    Returns (union (U, nw) uint32, genome_counts (U,) int32,
             matrix (ceil(G/64), U) uint64).
    """
    lib = library()
    if not 1 <= nw <= 8:
        raise ValueError("merge_union_bits_native requires nw in [1, 8]")
    arrays = _rows(kmer_lists, nw)
    sizes = np.array([a.shape[0] for a in arrays], dtype=np.int64)
    total = int(sizes.sum())
    if total >= 2 ** 31:
        raise ValueError("merge_union_bits_native: total k-mers >= 2^31; "
                         "merge a smaller set of genomes")
    addrs = np.array([a.ctypes.data for a in arrays], dtype=np.uint64)
    n_genomes = len(arrays)
    n_words64 = -(-n_genomes // 64)
    cap = max(total, 1)
    out_union = np.empty((cap, nw), dtype=np.uint32)
    out_counts = np.empty(cap, dtype=np.int32)
    matrix_buf = np.empty(n_words64 * cap, dtype=np.uint64)
    kernel, kname = _bits_kernel(lib, nw)
    n = kernel(addrs, sizes, n_genomes, nw, out_union, out_counts,
               matrix_buf, cap, cap)
    if n == -1:
        raise RuntimeError("fused union merge capacity exceeded")
    if n < 0:
        raise RuntimeError("%s failed (code %d)" % (kname, n))
    lib.grm_compact_rows(matrix_buf, n_words64, n, cap, n)
    matrix = matrix_buf[: n_words64 * n].reshape(n_words64, n)
    return out_union[:n], out_counts[:n], matrix


def merge_union_bits_parallel(kmer_lists, nw, n_threads=None,
                              min_total=1 << 22):
    """Partition-parallel fused dsk2kover merge (nw in [1, 8], k up to 128).

    The canonical key space is split into balanced ranges on the leading
    uint32 word (every per-genome list is sorted, so a range is a
    contiguous slice found by binary search), and each range is merged by
    :func:`merge_union_bits_native`'s kernel on its own thread (ctypes
    releases the GIL). Ranges are disjoint and ordered, so the output is
    the serial merge's, bit for bit.
    """
    lib = library()
    if not 1 <= nw <= 8:
        raise ValueError("merge_union_bits_parallel requires nw in [1, 8]")
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    arrays = _rows(kmer_lists, nw)
    sizes = np.array([a.shape[0] for a in arrays], dtype=np.int64)
    total = int(sizes.sum())
    if n_threads <= 1 or total < min_total or len(arrays) < 2:
        return merge_union_bits_native(arrays, nw)
    if total >= 2 ** 31:
        raise ValueError("merge_union_bits_parallel: total k-mers >= 2^31")

    n_genomes = len(arrays)
    n_words64 = -(-n_genomes // 64)

    # Balanced range boundaries on the leading word, from a global sample.
    n_parts = min(4 * n_threads, max(total // (1 << 20), n_threads), 256)
    n_parts = max(n_parts, 2)
    samples = [np.ascontiguousarray(a[::max(a.shape[0] // 512, 1), 0])
               for a in arrays if a.shape[0]]
    sample = np.sort(np.concatenate(samples))
    q = (np.arange(1, n_parts) * len(sample)) // n_parts
    boundaries = np.unique(sample[q])  # ascending interior boundaries
    n_parts = len(boundaries) + 1

    # Per-array range starts: word 0 is the primary sort key, so
    # searchsorted on the word-0 column slices exactly.
    starts = np.zeros((len(arrays), n_parts + 1), dtype=np.int64)
    for i, a in enumerate(arrays):
        if a.shape[0]:
            w0 = np.ascontiguousarray(a[:, 0])
            starts[i, 1:-1] = np.searchsorted(w0, boundaries, side="left")
            starts[i, -1] = a.shape[0]

    kernel, kname = _bits_kernel(lib, nw)
    part_out = [None] * n_parts

    def run_part(p):
        sub_sizes = np.ascontiguousarray(starts[:, p + 1] - starts[:, p])
        cap = max(int(sub_sizes.sum()), 1)
        addrs = np.array([a.ctypes.data + int(starts[i, p]) * nw * 4
                          for i, a in enumerate(arrays)], dtype=np.uint64)
        out_union = np.empty((cap, nw), dtype=np.uint32)
        out_counts = np.empty(cap, dtype=np.int32)
        matrix_buf = np.empty(n_words64 * cap, dtype=np.uint64)
        n = kernel(addrs, sub_sizes, n_genomes, nw, out_union, out_counts,
                   matrix_buf, cap, cap)
        if n < 0:
            raise RuntimeError("%s failed (code %d)" % (kname, n))
        part_out[p] = (n, out_union, out_counts, matrix_buf, cap)

    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        list(pool.map(run_part, range(n_parts)))

    ns = [po[0] for po in part_out]
    n_union = int(sum(ns))
    union = np.empty((n_union, nw), dtype=np.uint32)
    counts = np.empty(n_union, dtype=np.int32)
    matrix = np.empty((n_words64, n_union), dtype=np.uint64)
    offs = np.zeros(n_parts + 1, dtype=np.int64)
    np.cumsum(ns, out=offs[1:])

    def copy_part(p):
        n, out_union, out_counts, matrix_buf, cap = part_out[p]
        lo, hi = offs[p], offs[p + 1]
        union[lo:hi] = out_union[:n]
        counts[lo:hi] = out_counts[:n]
        for w in range(n_words64):
            matrix[w, lo:hi] = matrix_buf[w * cap: w * cap + n]

    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        list(pool.map(copy_part, range(n_parts)))
    return union, counts, matrix
