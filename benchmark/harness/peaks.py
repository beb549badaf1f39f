"""The H100's peaks and the least time of a kernel call, frozen.

Phase 6 of ``chip_smoke.py`` (``time_kernels``' ``bound``) times a call's
least time as the largest of three:

- its bytes (inputs read once, outputs written once) at the published
  memory rate, 3.35 TB/s (NVIDIA H100 SXM data sheet, 700 W;
  ``chip_smoke.HBM_BYTES_PER_S``);
- its AND + POPC word operations, 32 bit-ANDs each, as a 1-bit product on
  the tensor cores at 5.14e15 bit-ANDs/s, the better of the two b1 ``mma``
  shapes that ``grm_tpu_torch/csrc/bmma_probe.cu`` measured on an NVIDIA
  H100 80GB HBM3 at 700 W (PERF.md §6, PR 3-4);
- its divisions and logs (CART's distinct splits) at 4.24e12/s, the
  special-function unit's rate measured by the same probe.

The two measured rates are constants here: a later change to the probe
or the program does not move the yardstick.
"""

HBM_BYTES_PER_S = 3.35e12
B1_BIT_ANDS_PER_S = 5.14e15
SFU_PER_S = 4.24e12


def bound_s(nbytes, popc_words=0, special=0):
    """The least seconds for ``nbytes`` moved, ``popc_words`` 32-bit AND +
    POPC word operations and ``special`` divisions and logs."""
    return max(nbytes / HBM_BYTES_PER_S,
               32.0 * popc_words / B1_BIT_ANDS_PER_S,
               special / SFU_PER_S)
