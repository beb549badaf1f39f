"""scm_sweep_roofline: the SCM sweep kernel's share of its least time, in
percent: the least times of its launches in the window (shapes recorded at
the op wrappers ``scm_sweep_sbmax`` and ``scm_sweep_argmax_blocks`` of
``grm_tpu_torch/ops/scm_sweep.py``) over their device time
(``scm_sweep_kernel``, both epilogues, from torch.profiler).

A launch's least time (``chip_smoke.py`` phase 6): the matrix read once,
each fit's masks and counts read and its outputs written once; 2 F W K
word ANDs and POPCs as a 1-bit product; a blacklist's bytes beside."""

from harness.peaks import bound_s

KERNELS = (r"scm_sweep_kernel<",)


def _record(epilogue):
    def record(args, kwargs):
        matrix, neg = args[0], args[1]
        block = args[7] if len(args) > 7 else kwargs.get(
            "sb" if epilogue == "sbmax" else "block")
        excl = args[8] if len(args) > 8 else kwargs.get("excl")
        if matrix.device.type != "cuda":
            return 0.0
        w, k = matrix.shape
        f = neg.shape[0]
        nb = -(-k // int(block))
        out = (4 if epilogue == "sbmax" else 8) * nb * f
        nbytes = 4 * w * k + f * (8 * w + 12) + out
        if excl is not None:
            nbytes += excl.numel()
        return bound_s(nbytes, popc_words=2 * f * w * k)
    return record


WRAPS = {"grm_tpu_torch.ops.scm_sweep:scm_sweep_sbmax": _record("sbmax"),
         "grm_tpu_torch.ops.scm_sweep:scm_sweep_argmax_blocks":
             _record("argmax")}


def read(run):
    if run.timeline is None:
        return None
    least = sum(sum(run.calls.get(key, ())) for key in WRAPS)
    device_s, launches = run.timeline.kernel_s(KERNELS)
    if launches == 0 or device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s
