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
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "DEFAULT_TIMEOUT",
    "initialize",
    "process_index",
    "process_count",
    "all_gather_arrays",
    "shard_round_robin",
]

# Seconds a collective may wait for its peers before it raises: a process
# that died or diverged surfaces as an error on the others, not as a hang.
DEFAULT_TIMEOUT = 300.0


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
    dist.all_gather(sizes, torch.tensor([array.shape[0]], dtype=torch.int64))
    sizes = [int(s) for s in sizes]
    pad_shape = (max(sizes),) + array.shape[1:]
    padded = np.zeros(pad_shape, dtype=array.dtype)
    padded[:array.shape[0]] = array
    payload = torch.from_numpy(padded.reshape(-1).view(np.uint8))
    parts = [torch.empty_like(payload) for _ in range(n)]
    dist.all_gather(parts, payload)
    return [p.numpy().view(array.dtype).reshape(pad_shape)[:size]
            for p, size in zip(parts, sizes)]
