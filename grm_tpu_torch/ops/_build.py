"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``grm_tpu_torch/csrc/<name>.cu`` compiles, at the first CUDA use, into
its own shared library with a plain C interface (``-gencode
arch=compute_90a,code=sm_90a``). Libraries land in
``grm_tpu_torch/_kernels/`` (listed in ``.gitignore``) under a name keyed
by a hash of the source, the headers beside it (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. One ``nvcc`` per source, all started together. A
failed build raises: there is no fallback to the plain PyTorch versions.

Every kernel wrapper adds one to its entry of :data:`launches` where it
launches its kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["library", "build_all", "check", "launches", "cart_frontiers",
           "exact_frontiers", "reset_launches", "sass_opcodes", "BUILD_LOG"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_kernels"
SOURCES = ("popcount_colsum", "scm_sweep", "cart_sweep", "cart_exact",
           "bmma_probe", "kmer", "device_build", "deinterleave", "sort")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches = {
    "popcount_colsum": 0,
    "popcount_colsum_pairs": 0,
    "scm_sweep_argmax": 0,
    "scm_sweep_sbmax": 0,
    "scm_sweep_deep": 0,  # either epilogue past 512 genomes (16 words)
    "cart_sweep": 0,
    "cart_exact_tuples": 0,
    "cart_exact_select": 0,
    "cart_exact_deep": 0,  # either exact sweep past 512 genomes (16 words)
    "cart_exact_matrix_reads": 0,  # the reads of the matrix their plans make
    "kmer_canon": 0,
    "build_columns": 0,
    "merge_columns": 0,
    "compact_columns": 0,
    "deinterleave_u64": 0,
    "radix_sort": 0,
    "merge_keys": 0,
}
# (nodes, criterion) of the latest cart_sweep launches, one entry beside
# each count: the frontier sizes a path really gave the kernel.
cart_frontiers = collections.deque(maxlen=4096)
# (kernel, nodes, classes) of the latest exact CART launches, likewise.
exact_frontiers = collections.deque(maxlen=4096)
BUILD_LOG = {}  # source name -> nvcc/ptxas output of its last build
_LIBS = {}


def reset_launches():
    for name in launches:
        launches[name] = 0
    cart_frontiers.clear()
    exact_frontiers.clear()


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels of grm_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name):
    digest = hashlib.sha256((CSRC / (name + ".cu")).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include any
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("lib%s-%s.so" % (name, digest.hexdigest()[:16]))


def build_all():
    """Compile every kernel library that is not built yet, in parallel.

    Returns the names that were compiled. Raises RuntimeError with the
    compiler's output if any build fails.
    """
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return []
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / (name + ".cu"))]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append("%s (exit %d):\n%s" % (name, proc.returncode, log))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return todo


def library(name, signatures):
    """The loaded ctypes library of kernel source ``name``, built if needed.

    ``signatures`` maps each C entry point to ``(argtypes, restype)``; they
    are declared when the library is first loaded.
    """
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib


def sass_opcodes(name, opcodes):
    """How often each of ``opcodes`` (prefixes such as "BMMA") occurs in the
    machine code of the built library ``name``, by ``cuobjdump -sass`` from
    the toolkit that holds nvcc; None where the toolkit has no cuobjdump."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    text = subprocess.run([str(tool), "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return {op: len(re.findall(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?%s\b"
                               % re.escape(op), text, re.M))
            for op in opcodes}


def check(status, what):
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError("%s: CUDA error %d" % (what, status))
