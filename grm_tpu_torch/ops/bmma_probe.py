"""Instruction-rate probes on the card (``csrc/bmma_probe.cu``): what the
GPU executes per second of the 1-bit tensor-core product (AND + POPC), of the
scalar ``POPC`` and of the special-function unit. NVIDIA publishes no 1-bit
peak for the H100, so the sweep kernels' tensor-core bound rests on the
rate measured here. Nothing on a learning path calls this module.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["MODES", "probe_ms", "probe_rates", "probe_sass"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "grm_bmma_probe": ([_I, _I, _I, _I, _P, _P], _I),
    "grm_bmma_probe_chains": ([], _I),
}
# mode -> (name, operations per thread and chained instruction): a k256
# tile product is 16 * 8 * 256 bit-ANDs per warp, a k128 one half of that;
# a scalar POPC covers one 32-bit word; "popc+sfu" runs one of each.
MODES = {
    0: ("bmma_k256", 16 * 8 * 256 // 32),
    1: ("bmma_k128", 16 * 8 * 128 // 32),
    2: ("popc", 32),
    3: ("sfu", 1),
    4: ("popc+sfu", 1),
}
_THREADS = 256


def probe_ms(mode, target_ms=40.0, blocks_per_sm=8, reps=5, device="cuda"):
    """(milliseconds of one launch of probe ``mode``, chained instructions
    per thread in it, threads): the least of ``reps`` launches timed by CUDA
    events, the launch sized by a short first one to last ``target_ms``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the rate probes run on a CUDA device only")
    lib = _build.library("bmma_probe", _SIGNATURES)
    with torch.cuda.device(device):
        blocks = blocks_per_sm * torch.cuda.get_device_properties(
            device).multi_processor_count
        out = torch.empty(blocks * _THREADS, dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream().cuda_stream

        def timed(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _build.check(lib.grm_bmma_probe(mode, blocks, _THREADS, iters,
                                            out.data_ptr(), stream),
                         "bmma_probe")
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end)

        timed(16)  # warm up
        short = 64
        iters = int(min(1 << 16, max(short, short * target_ms / timed(short))))
        best = min(timed(iters) for _ in range(reps))
    return best, iters * lib.grm_bmma_probe_chains(), blocks * _THREADS


def probe_rates(device="cuda"):
    """name -> {"ms", "per_s"} for every probe mode: bit-ANDs per second for
    the three AND + POPC modes, instructions per second and thread for "sfu",
    and for "popc+sfu" rounds (one POPC and one special function) per
    second."""
    rates = {}
    for mode, (name, ops) in MODES.items():
        ms, chained, threads = probe_ms(mode, device=device)
        rates[name] = {"ms": ms, "per_s": ops * chained * threads / (ms * 1e-3)}
    return rates


def probe_sass():
    """Counts of the tensor-core and the scalar opcodes in the probe
    library's machine code (None without ``cuobjdump``): BMMA is the 1-bit
    tensor-core instruction, IMMA an integer one, POPC the scalar count."""
    _build.library("bmma_probe", _SIGNATURES)
    return _build.sass_opcodes("bmma_probe", ("BMMA", "IMMA", "POPC", "MUFU"))
