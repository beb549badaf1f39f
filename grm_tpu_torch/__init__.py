"""GRM on PyTorch and CUDA: the port of ``grm_tpu`` to an NVIDIA H100.

A package of its own beside ``grm_tpu``, with the same module paths and
names. It imports ``torch`` and nothing of JAX or ``grm_tpu``. Entry points
take a ``device`` that defaults to ``"cuda"`` and raise when CUDA is absent
unless the caller passes ``device="cpu"``, where every hand-written kernel
(``grm_tpu_torch/csrc``) runs its plain PyTorch version.

- ``grm_tpu_torch.ops``       the CUDA kernels and their wrappers: masked
                              popcount column sums, the SCM utility sweep,
                              the CART frontier sweep, the k-mer windows,
                              the device ingest's matrix build and the
                              artifact's matrix split.
- ``grm_tpu_torch.kmer``      host ingest: per-genome k-mer counting (on
                              the card) and the union merge (host C++,
                              ``grm_tpu_torch.native``).
- ``grm_tpu_torch.dataset``   the artifact (an HDF5 file or in memory):
                              creation from contigs, reads or a TSV, the
                              reader, splits.
- ``grm_tpu_torch.learning``  SCM and CART learners, models, metrics,
                              bounds and the ``learn_SCM`` / ``learn_CART``
                              experiments.
- ``grm_tpu_torch.parallel``  the device engines: SCM exact and argmax,
                              CART argmax (frontier scoring, forest growth).
- ``grm_tpu_torch.collect``   PATRIC data collection (the AMR table, the
                              FTP downloads); with ``results_site``,
                              ``settings`` and ``profiling`` the host side
                              of the CLI.
"""

__version__ = "0.1.0"
