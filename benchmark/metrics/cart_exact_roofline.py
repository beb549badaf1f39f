"""cart_exact_roofline: the exact CART kernels' share of their least time,
in percent: the least times of their calls in the window (shapes recorded
at the op wrappers ``cart_exact_tuples`` and ``cart_exact_select`` of
``grm_tpu_torch/ops/cart_exact.py``) over the device time of their four
kernels (the pass bitmaps, the tuple sweep, the select sweep and its
write; torch.profiler).

A call's least time (``chip_smoke.py`` phase 6, ``time_exact_kernels``):
the matrix read once, each node's class and train masks, counts and
scales read once; N (C + 1) W K word ANDs and POPCs as a 1-bit product;
the tuple tables written once (12 bytes an entry, an entry a key of each
node's count lattice, prod(n_c + 1)) and two divisions for each of the
frontier's distinct splits (min(lattice, K) a node). The select's output
depends on the data and is left out, so its least time is a lower one."""

import numpy as np

from harness.peaks import bound_s

KERNELS = (r"cart_exact_tuples_kernel", r"cart_exact_bitmap_kernel",
           r"cart_exact_select_kernel", r"cart_exact_write_kernel")


def _record(tuples):
    def record(args, kwargs):
        matrix, n_node = args[0], args[3]
        if matrix.device.type != "cuda":
            return None
        # The node counts stay on the card until the window has closed.
        return (tuples, tuple(matrix.shape), n_node.detach().clone())
    return record


WRAPS = {"grm_tpu_torch.ops.cart_exact:cart_exact_tuples": _record(True),
         "grm_tpu_torch.ops.cart_exact:cart_exact_select": _record(False)}


def least_s(tuples, shape, n_node):
    w, k = shape
    n_node = np.asarray(n_node, np.int64)
    n, c = n_node.shape
    nbytes = 4 * w * k + n * (c + 1) * 4 * w + 8 * n * c
    special = 0
    if tuples:
        lattice = np.prod(n_node.astype(np.float64) + 1, axis=1)
        nbytes += 12 * lattice.sum()
        special = 2 * np.minimum(lattice, k).sum()
    return bound_s(nbytes, popc_words=n * (c + 1) * w * k, special=special)


def read(run):
    if run.timeline is None:
        return None
    calls = [r for key in WRAPS for r in run.calls.get(key, ()) if r]
    least = sum(least_s(t, shape, nn.cpu().numpy()) for t, shape, nn in calls)
    device_s, launches = run.timeline.kernel_s(KERNELS)
    if launches == 0 or device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s
