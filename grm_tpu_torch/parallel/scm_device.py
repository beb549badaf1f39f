"""Packed example masks for the device SCM engines (the port of
``build_packed_mask`` from ``grm_tpu/parallel/scm_device.py``)."""

from __future__ import annotations

import numpy as np

from ..utils import build_row_mask

__all__ = ["build_packed_mask"]


def build_packed_mask(rows, n_genomes, n_words):
    """uint32 MSB-first packed row mask padded to n_words."""
    out = np.zeros(n_words, np.uint32)
    m = build_row_mask(np.asarray(rows, dtype=np.int64), n_genomes, 32)
    out[: len(m)] = m
    return out
