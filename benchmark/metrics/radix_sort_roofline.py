"""radix_sort_roofline: the ingest's radix sort's share of its least time,
in percent: the least times of its calls in the window (shapes recorded at
the op wrapper ``sort_keys`` of ``grm_tpu_torch/ops/kmer.py``) over the
device time of the sort's kernels (``csrc/sort.cu``: count, scan, scatter,
local sort; torch.profiler).

A call's least time (``chip_smoke.py`` phase 6): n rows, each row's key
planes read and written once, its int64 position written, its validity
read and written where there is one: 24 bytes a row for one key plane."""

from harness.peaks import bound_s

KERNELS = (r"sort_count_kernel", r"sort_scan_kernel", r"sort_scatter_kernel",
           r"sort_local_kernel")


def record(args, kwargs):
    keys = args[0]
    valid = args[1] if len(args) > 1 else kwargs.get("valid")
    if keys.device.type != "cuda":
        return 0.0
    n_pairs, n = keys.shape
    v = 0 if valid is None else 1
    return bound_s(n * (16 * n_pairs + 8 + 2 * v))


WRAPS = {"grm_tpu_torch.ops.kmer:sort_keys": record}


def read(run):
    if run.timeline is None:
        return None
    least = sum(run.calls.get("grm_tpu_torch.ops.kmer:sort_keys", ()))
    device_s, launches = run.timeline.kernel_s(KERNELS)
    if launches == 0 or device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s
