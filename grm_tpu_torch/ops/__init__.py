"""Kernels of the port: masked popcount column sums and the SCM sweep."""
