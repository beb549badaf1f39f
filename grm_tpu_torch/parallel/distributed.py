"""Multi-process runtime helpers (the port of
``grm_tpu/parallel/distributed.py``) on ``torch.distributed``.

The reference's only multi-process distribution is MPI for Ray Surveyor
(``mpiexec -n 4``, src/app.py:1310); ``grm_tpu`` runs one process per host
with ``jax.distributed``. The port runs the same helpers on a
``torch.distributed`` process group with the **gloo** backend, over host
tensors: what the processes exchange are host arrays (``grm_tpu``'s
``process_allgather`` of numpy arrays), so no NCCL is needed and several
processes may share one card. A single process degenerates to local
execution.

Gloo's collectives take no unsigned integers, so arrays travel as their
bytes (``uint8``), exactly.

A mesh that spans processes (:func:`grm_tpu_torch.parallel.mesh.make_mesh`
after :func:`initialize`) combines its shards' small results with the
helpers below: :func:`all_gather_fixed` and :func:`all_gather_arrays`
(results in rank order), :func:`all_reduce` (sum, max or min) and
:func:`check_agreement` (a digest of the inputs every rank must share,
checked before the work that depends on them). A collective whose peer
died or diverged raises within the group's timeout; none carries on with
local data. :data:`collectives` counts the collectives this process has
made and the host seconds they took.
"""

from __future__ import annotations

import datetime
import hashlib
import time

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "DEFAULT_TIMEOUT",
    "initialize",
    "process_index",
    "process_count",
    "all_gather_arrays",
    "all_gather_fixed",
    "all_gather_objects",
    "all_reduce",
    "check_agreement",
    "collectives",
    "reset_collectives",
    "shard_round_robin",
]

# Seconds a collective may wait for its peers before it raises: a process
# that died or diverged surfaces as an error on the others, not as a hang.
DEFAULT_TIMEOUT = 300.0
# The torch.distributed collectives this process's helpers made since
# reset_collectives(), and the host seconds they took (waits included).
collectives = {"count": 0, "seconds": 0.0}


def reset_collectives():
    collectives.update(count=0, seconds=0.0)


def _collective(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a torch.distributed collective, counted in
    :data:`collectives`."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        collectives["count"] += 1
        collectives["seconds"] += time.perf_counter() - t0


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               timeout=DEFAULT_TIMEOUT):
    """Join the gloo process group (a no-op for one process or when joined).

    ``coordinator_address``: ``host:port`` of the rendezvous (``tcp://`` is
    added), or a ``file://`` or ``tcp://`` URL as ``init_process_group``
    takes it. ``timeout``: seconds every collective may wait.
    """
    if num_processes in (None, 1) and coordinator_address is None:
        return
    if dist.is_initialized():
        return
    url = coordinator_address
    if "://" not in url:
        url = "tcp://" + url
    dist.init_process_group(
        "gloo", init_method=url, world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=timeout))


def _joined():
    return dist.is_available() and dist.is_initialized()


def process_index():
    return dist.get_rank() if _joined() else 0


def process_count():
    return dist.get_world_size() if _joined() else 1


def shard_round_robin(items, index=None, count=None):
    """This process's share of a work list (genome data parallelism)."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    return [x for i, x in enumerate(items) if i % count == index]


def all_gather_arrays(array, dtype=None):
    """Gather variable-length 1D/2D host arrays from every process.

    Exchanges the sizes first, then the payloads padded to the largest, as
    bytes. Returns the list of per-process arrays in process order.
    """
    array = np.asarray(array)
    if dtype is not None:
        array = array.astype(dtype)
    if process_count() == 1:
        return [array]

    n = process_count()
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    _collective(dist.all_gather, sizes,
                torch.tensor([array.shape[0]], dtype=torch.int64))
    sizes = [int(s) for s in sizes]
    pad_shape = (max(sizes),) + array.shape[1:]
    padded = np.zeros(pad_shape, dtype=array.dtype)
    padded[:array.shape[0]] = array
    payload = torch.from_numpy(padded.reshape(-1).view(np.uint8))
    parts = [torch.empty_like(payload) for _ in range(n)]
    _collective(dist.all_gather, parts, payload)
    return [p.numpy().view(array.dtype).reshape(pad_shape)[:size]
            for p, size in zip(parts, sizes)]


def all_gather_fixed(array):
    """Gather an array of one shape and dtype on every process: the list of
    per-process arrays in process order (the process's own array alone
    where there is one process)."""
    array = np.ascontiguousarray(array)
    if process_count() == 1:
        return [array]
    payload = torch.from_numpy(array.reshape(-1).view(np.uint8))
    parts = [torch.empty_like(payload) for _ in range(process_count())]
    _collective(dist.all_gather, parts, payload)
    return [p.numpy().view(array.dtype).reshape(array.shape) for p in parts]


def all_gather_objects(obj):
    """Gather a small picklable object from every process, in process
    order."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    _collective(dist.all_gather_object, out, obj)
    return out


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}
_REDUCIBLE = (np.int32, np.int64, np.float32)


def all_reduce(array, op="sum"):
    """Element-wise ``op`` ("sum", "max" or "min") of an int32, int64 or
    float32 array over the processes; returns a new array (a copy of the
    input where there is one process). Integer sums are exact, and so are
    the extrema."""
    array = np.array(array, copy=True)
    if array.dtype.type not in _REDUCIBLE:
        raise ValueError("all_reduce takes int32, int64 or float32, not %s"
                         % array.dtype)
    if process_count() > 1:
        _collective(dist.all_reduce, torch.from_numpy(array),
                    op=getattr(dist.ReduceOp, _OPS[op]))
    return array


def _digest(items):
    h = hashlib.sha256()
    for item in items:
        if isinstance(item, (np.ndarray, torch.Tensor)):
            a = np.ascontiguousarray(item.cpu().numpy() if isinstance(
                item, torch.Tensor) else item)
            h.update(("%s%s" % (a.dtype.str, a.shape)).encode())
            h.update(a.tobytes())
        else:
            h.update(repr(item).encode())
        h.update(b"\0")
    return np.frombuffer(h.digest(), np.uint8).copy()


def check_agreement(what, *items):
    """Raise on every process, naming the ones that differ, unless every
    process passed the same ``items`` (arrays, tensors or values with a
    stable ``repr``): the inputs of a run that every process must share
    (``what`` names them). One gather of a 32-byte digest; nothing where
    there is one process."""
    if process_count() == 1:
        return
    digests = all_gather_fixed(_digest(items))
    bad = [i for i, d in enumerate(digests)
           if not np.array_equal(d, digests[0])]
    if bad:
        raise ValueError(
            "Distributed input mismatch: process(es) %s disagree with "
            "process 0 on %s (this is process %d). Every process must pass "
            "the same inputs." % (bad, what, process_index()))
