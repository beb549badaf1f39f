"""GRM on PyTorch and CUDA: the port of ``grm_tpu`` to an NVIDIA H100.

A package of its own beside ``grm_tpu``, with the same module paths and
names. It imports ``torch`` and nothing of JAX or ``grm_tpu``. Entry points
take a ``device`` that defaults to ``"cuda"`` and raise when CUDA is absent
unless the caller passes ``device="cpu"``, where every hand-written kernel
(``grm_tpu_torch/csrc``) runs its plain PyTorch version.

- ``grm_tpu_torch.ops``       the CUDA kernels and their wrappers: masked
                              popcount column sums, the SCM utility sweep,
                              the CART frontier sweep.
- ``grm_tpu_torch.dataset``   the HDF5 artifact reader (or an in-memory
                              artifact), the array writer, splits.
- ``grm_tpu_torch.learning``  SCM and CART learners, models, metrics,
                              bounds and the ``learn_SCM`` / ``learn_CART``
                              experiments.
- ``grm_tpu_torch.parallel``  the device engines: SCM exact and argmax,
                              CART argmax (frontier scoring, forest growth).
"""

__version__ = "0.1.0"
