"""The port's host C++ library (``grmio.cpp``), built with ``g++`` at first
use; port of ``grm_tpu/native``."""

from .bindings import (  # noqa: F401
    encode_fasta_native,
    library,
    merge_union_bits_parallel,
)
