"""The port's argmax engine (``scm_cv_grid_device``, ``scm_fit_batch_device``)
on the CPU against ``grm_tpu``'s, through both JAX sweeps (the XLA block
scan and the Pallas kernel in interpret mode), with and without a
blacklist. p values keep every ``p * count`` exact in float32, so the f32
tie rules (lowest block, then lowest column, presence beats absence) decide
identically and the comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grm_tpu.parallel.mesh import scm_fit_batch_device as jax_fit_batch
from grm_tpu.parallel.scm_grid import scm_cv_grid_device as jax_grid
from grm_tpu.utils import pack_binary_bytes_to_ints

from grm_tpu_torch.ops.popcount import masks_to_tensor
from grm_tpu_torch.parallel.mesh import scm_fit_batch_device
from grm_tpu_torch.parallel.scm_grid import scm_cv_grid_device

from helpers_scm import make_cv_fits


def _data(seed, n_genomes=70, n_kmers=531):
    rng = np.random.RandomState(seed)
    dense = (rng.rand(n_genomes, n_kmers) > 0.6).astype(np.uint8)
    y = (rng.rand(n_genomes) > 0.5).astype(np.uint8)
    dense[:, 17] = y  # a perfect marker
    dense[:, 300] = y  # its duplicate: an exact utility tie
    dense[:, 401] = 1 - dense[:, 40]  # presence/absence tie pair
    return dense, y, pack_binary_bytes_to_ints(dense, 32)


@pytest.mark.parametrize("blacklist", [False, True])
@pytest.mark.parametrize("sweep", ["xla", "pallas_interpret"])
def test_scm_cv_grid_device_matches_jax(sweep, blacklist):
    dense, y, packed = _data(3 + blacklist)
    n_genomes, n_kmers = dense.shape
    fits = make_cv_fits(y, n_genomes, packed.shape[0],
                        ps=(0.5, 1.0, 2.0, 4.0))
    excl = [17, 17 + n_kmers, 200, 400 + n_kmers] if blacklist else None
    want = jax_grid(packed, fits, n_kmers, 6, sweep=sweep, excl_rules=excl)
    got = scm_cv_grid_device(masks_to_tensor(packed, "cpu"), fits, n_kmers,
                             6, excl_rules=excl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if blacklist:
        assert not np.isin(got[0], excl).any()


def test_scm_fit_batch_device_matches_jax():
    dense, y, packed = _data(8)
    n_genomes, n_kmers = dense.shape
    fits = make_cv_fits(y, n_genomes, packed.shape[0],
                        ps=(0.5, 1.0, 4.0), n_folds=2)
    pos = np.stack([f["pos_mask"] for f in fits])
    neg = np.stack([f["neg_mask"] for f in fits])
    ps = np.array([f["p"] for f in fits], np.float32)
    want = jax_fit_batch(jnp.asarray(packed), jnp.asarray(pos),
                         jnp.asarray(neg), jnp.asarray(ps), n_kmers, 5)
    got = scm_fit_batch_device(
        masks_to_tensor(packed, "cpu"), masks_to_tensor(pos, "cpu"),
        masks_to_tensor(neg, "cpu"), torch.from_numpy(ps), n_kmers, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
