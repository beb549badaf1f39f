"""Host allocator tuning for dataset creation (port of
``grm_tpu/hostmem.py``).

Per-genome counting downloads each genome's k-mer words and flags (tens of
MB) into fresh host buffers and keeps its distinct rows with numpy, genome
after genome. glibc serves allocations above M_MMAP_THRESHOLD (128 KB,
growing to at most 32 MB as blocks are freed) with fresh mmap()s and
returns them to the kernel on free, so every genome pays first-touch page
faults for its working set again.

``tune_host_allocator()`` raises M_MMAP_THRESHOLD and M_TRIM_THRESHOLD so
large freed blocks stay in the heap arena and are reused warm. The
counters of :mod:`grm_tpu_torch.kmer.counter` call it; importing the
package does not. On the H100 machine's host it cut the counting of
``from_contigs`` by about a third at 342 genomes of 4.4 Mbp, and left the
host merge and the peak RSS as they were (``scripts/time_create.py`` runs
both settings; its readings are in PERF.md). The
setting is process-wide and stays for the rest of the process; the arena
retains the high-water mark of freed space. GRM_NO_MALLOC_TUNE=1 turns it
off.
"""

from __future__ import annotations

import ctypes
import os
import sys

_done = False

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def tune_host_allocator(threshold_bytes: int = 1 << 30) -> bool:
    """Idempotently raise glibc's mmap/trim thresholds. Returns True if set."""
    global _done
    if _done:
        return True
    if os.environ.get("GRM_NO_MALLOC_TUNE") == "1":
        return False
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, threshold_bytes)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, threshold_bytes)
    except OSError:
        return False
    _done = bool(ok1) and bool(ok2)
    return _done
