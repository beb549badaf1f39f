"""Kernels of the port: masked popcount column sums and the SCM sweep."""
from .popcount import BitMatrix, masked_popcount_colsum  # noqa: F401
