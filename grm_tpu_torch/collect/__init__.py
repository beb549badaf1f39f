"""PATRIC/BV-BRC data collection (port of ``grm_tpu/collect``): the AMR
metadata table and the FTP downloads, on the host."""

from .amr import AmrDatabase  # noqa: F401
