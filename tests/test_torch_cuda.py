"""Each CUDA kernel of grm_tpu_torch against its plain PyTorch version.

These tests need an NVIDIA GPU and skip without one. This file imports no
JAX, so it also runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX). Every
comparison is exact: the kernels round as the plain versions do.
"""

import numpy as np
import pytest
import torch

from grm_tpu_torch.ops import popcount as pc
from grm_tpu_torch.ops import scm_sweep as sw

pytestmark = pytest.mark.cuda

P_GRID = [0.1, 0.178, 0.316, 0.562, 1.0, 1.778, 3.162, 5.623, 10.0, 999999.0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _words(rng, shape):
    return torch.from_numpy(
        rng.randint(0, 2**32, size=shape, dtype=np.uint64)
        .astype(np.uint32).view(np.int32))


def _fits(rng, f, w, n_genomes, dyadic):
    neg = rng.randint(0, 2**32, size=(f, w), dtype=np.uint64).astype(np.uint32)
    pos = neg ^ np.uint32(0xFFFFFFFF)
    tail = n_genomes - 32 * (w - 1)
    keep = np.uint32((0xFFFFFFFF << (32 - tail)) & 0xFFFFFFFF)
    neg[:, -1] &= keep
    pos[:, -1] &= keep
    popc = lambda a: np.unpackbits(a.view(np.uint8), axis=1).sum(1)
    ps = (np.array([0.5, 1.0, 2.0, 4.0])[np.arange(f) % 4] if dyadic
          else np.array(P_GRID)[np.arange(f) % len(P_GRID)])
    return (torch.from_numpy(neg.view(np.int32)),
            torch.from_numpy(pos.view(np.int32)),
            torch.from_numpy(popc(neg).astype(np.int32)),
            torch.from_numpy(popc(pos).astype(np.int32)),
            torch.from_numpy(ps.astype(np.float32)))


def _same(a, b):
    a, b = a.cpu(), b.cpu()
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), (a - b).abs().max()


@pytest.mark.parametrize("c", [1, 2, 10, 12])
def test_popcount_colsum_kernel(cuda, c):
    rng = np.random.RandomState(c)
    matrix = _words(rng, (11, 100003)).to(cuda)
    masks = _words(rng, (c, 11)).to(cuda)
    _same(pc.popcount_colsum(matrix, masks),
          pc.popcount_colsum_plain(matrix, masks))


def test_popcount_colsum_pairs_kernel(cuda):
    rng = np.random.RandomState(1)
    k, width = 50001, 8192
    matrix = _words(rng, (11, k)).to(cuda)
    offsets = torch.tensor([0, 8192, 40960, 49152, 3, k - 1, k + 5, -100],
                           dtype=torch.int64, device=cuda)
    masks = _words(rng, (len(offsets), 2, 11)).to(cuda)
    _same(pc.popcount_colsum_pairs(matrix, masks, offsets, width),
          pc.popcount_colsum_pairs_plain(matrix, masks, offsets, width))


def _sweep_case(cuda, f, k, dyadic, excl_on, seed):
    rng = np.random.RandomState(seed)
    n_genomes = 342
    w = -(-n_genomes // 32)
    matrix = _words(rng, (w, k))
    matrix[-1] &= torch.tensor(np.uint32(0xFFFFFFFF << 10 & 0xFFFFFFFF)
                               .view(np.int32))
    neg, pos, nn, np_, ps = _fits(rng, f, w, n_genomes, dyadic)
    excl = None
    if excl_on:
        excl = torch.from_numpy((rng.rand(2, k) < 0.3).astype(np.uint8))
    t = [x.to(cuda) for x in (matrix, neg, pos, nn, np_, ps)]
    return t, None if excl is None else excl.to(cuda)


CASES = [(f, k, dyadic, excl_on)
         for f in (100, 128)
         for k in (100003, 3001)
         for dyadic in (False, True)
         for excl_on in (False, True)]


@pytest.mark.parametrize("f,k,dyadic,excl_on", CASES)
def test_scm_sweep_argmax_kernel(cuda, f, k, dyadic, excl_on):
    t, excl = _sweep_case(cuda, f, k, dyadic, excl_on, f + k)
    limit = k - 7
    got = sw.scm_sweep_argmax_blocks(*t, limit, min(4096, k), excl)
    want = sw.scm_sweep_argmax_blocks_plain(*t, limit, min(4096, k), excl)
    _same(got[0], want[0])
    _same(got[1], want[1])
    cpu = [x.cpu() for x in t]
    got = sw.scm_utility_argmax(*t, limit, excl=excl)
    want = sw.scm_utility_argmax(*cpu, limit,
                                 excl=None if excl is None else excl.cpu())
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("f,k,dyadic,excl_on", CASES)
def test_scm_sweep_sbmax_kernel(cuda, f, k, dyadic, excl_on):
    t, excl = _sweep_case(cuda, f, k, dyadic, excl_on, 7 * f + k)
    limit = k - 7
    _same(sw.scm_sweep_sbmax(*t, limit, 8192, excl),
          sw.scm_sweep_sbmax_plain(*t, limit, 8192, excl))


def test_kernels_at_the_largest_genome_count(cuda):
    """5022 genomes (W = 157): masks over several launches, fits over grid
    rows, more than 48 KB of shared memory."""
    rng = np.random.RandomState(5)
    n_genomes, k = 5022, 20001
    w = -(-n_genomes // 32)
    matrix = _words(rng, (w, k)).to(cuda)
    masks = _words(rng, (100, w)).to(cuda)
    _same(pc.popcount_colsum(matrix, masks),
          pc.popcount_colsum_plain(matrix, masks))
    fits = [t.to(cuda) for t in _fits(rng, 128, w, n_genomes, False)]
    excl = torch.from_numpy((rng.rand(2, k) < 0.2).astype(np.uint8)).to(cuda)
    got = sw.scm_sweep_argmax_blocks(matrix, *fits, k, 4096, excl)
    want = sw.scm_sweep_argmax_blocks_plain(matrix, *fits, k, 4096, excl)
    _same(got[0], want[0])
    _same(got[1], want[1])
    _same(sw.scm_sweep_sbmax(matrix, *fits, k, 8192, excl),
          sw.scm_sweep_sbmax_plain(matrix, *fits, k, 8192, excl))
