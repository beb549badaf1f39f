"""The port's device mesh (``grm_tpu_torch.parallel.mesh``) and its sharded
engines on the CPU, against ``grm_tpu``'s on its 8 virtual CPU devices and
against the port's own unsharded runs: ``make_mesh``'s shapes and errors,
``sharded_presence_counts`` at 1, 2 and 4 row devices, ``scm_device_step``,
``scm_fit_batch_device``, ``scm_cv_grid_sharded`` (with and without a
blacklist), ``scm_cv_batch_device`` on a (2, 4) mesh and
``cart_frontier_splits_sharded`` (with and without a blacklist). The port's
meshes name the CPU 8 times, its stand-in for 8 devices. K = 531 over 8
shards leaves the last shard 5 padding columns; K = 5 leaves three shards
with no real column. Everything is compared exactly, apart from
``scm_cv_batch_device``'s float32 risks and the CART scorer's float32
scores against ``grm_tpu``'s (``atol=1e-6``, as
``tests/test_distributed_build.py`` holds the risks); the port's sharded
scores equal its unsharded ones exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grm_tpu.ops.popcount import BitMatrix as JaxBitMatrix
from grm_tpu.parallel import mesh as jmesh
from grm_tpu.parallel.cart_device import (
    cart_frontier_splits_sharded as jax_cart_sharded,
)
from grm_tpu.parallel.scm_device import scm_cv_batch_device as jax_scan
from grm_tpu.parallel.scm_grid import scm_cv_grid_sharded as jax_grid_sharded
from grm_tpu.utils import build_row_mask, pack_binary_bytes_to_ints

from grm_tpu_torch.ops.popcount import BitMatrix, masks_to_tensor
from grm_tpu_torch.parallel import mesh as tmesh
from grm_tpu_torch.parallel.cart_device import (
    cart_frontier_splits_device,
    cart_frontier_splits_sharded,
)
from grm_tpu_torch.parallel.scm_device import scm_cv_batch_device
from grm_tpu_torch.parallel.scm_grid import (
    scm_cv_grid_device,
    scm_cv_grid_sharded,
)

from helpers_scm import make_cv_fits

CPU8 = [torch.device("cpu")] * 8


def _mesh(row_devices=1, n=8):
    return tmesh.make_mesh(n, row_devices=row_devices, devices=CPU8[:n])


def _data(seed, n_genomes=70, n_kmers=531, density=0.6):
    rng = np.random.RandomState(seed)
    dense = (rng.rand(n_genomes, n_kmers) > density).astype(np.uint8)
    y = (rng.rand(n_genomes) > 0.5).astype(np.uint8)
    if n_kmers > 401:
        dense[:, 17] = y  # a perfect marker
        dense[:, 300] = y  # its duplicate, in another shard: a tie
        dense[:, 401] = 1 - dense[:, 40]  # presence/absence tie pair
    return dense, y, pack_binary_bytes_to_ints(dense, 32)


@pytest.mark.parametrize("row_devices", [1, 2, 4, 8])
def test_make_mesh_shapes_equal_jax(row_devices):
    got = _mesh(row_devices)
    want = jmesh.make_mesh(8, row_devices=row_devices)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.size == 8
    assert len(got.devices) == row_devices
    assert all(d == torch.device("cpu") for row in got.devices for d in row)


def test_make_mesh_errors_and_identity():
    with pytest.raises(ValueError, match="row_devices must divide"):
        _mesh(3)
    with pytest.raises(ValueError):
        jmesh.make_mesh(8, row_devices=3)
    with pytest.raises(ValueError, match="needs that many"):
        tmesh.make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError):
        tmesh.Mesh([])
    assert _mesh(2) == _mesh(2) and hash(_mesh(2)) == hash(_mesh(2))
    assert _mesh(2) != _mesh(1)
    assert tmesh.MeshSharding(_mesh()) == tmesh.MeshSharding(_mesh())
    # A mesh of another device type than the run's raises.
    cuda = tmesh.Mesh([[torch.device("cuda", 0)] * 2])
    with pytest.raises(ValueError, match="not cpu devices"):
        tmesh.check_mesh(cuda, "cpu")
    tmesh.check_mesh(_mesh(), "cpu")


@pytest.mark.parametrize("n_kmers", [531, 5])
@pytest.mark.parametrize("row_devices", [1, 2, 4])
def test_sharded_counts_equal_jax(row_devices, n_kmers):
    rng = np.random.RandomState(31 + row_devices)
    n_genomes = 100
    dense = (rng.rand(n_genomes, n_kmers) > 0.5).astype(np.uint8)
    packed = pack_binary_bytes_to_ints(dense, 32)
    mesh = _mesh(row_devices)
    m_sharded, k = tmesh.shard_bit_matrix(packed, mesh)
    jm = jmesh.make_mesh(8, row_devices=row_devices)
    j_sharded, jk = jmesh.shard_bit_matrix(packed, jm)
    assert k == jk == n_kmers
    assert m_sharded.shape == tuple(j_sharded.shape)

    rows_a = rng.choice(n_genomes, 40, replace=False)
    rows_b = rng.choice(n_genomes, 13, replace=False)
    masks = np.zeros((2, m_sharded.shape[0]), np.uint32)
    for i, rows in enumerate([rows_a, rows_b]):
        m = build_row_mask(rows, n_genomes, 32)
        masks[i, :len(m)] = m
    got = tmesh.sharded_presence_counts(m_sharded, masks, mesh)
    want = jmesh.sharded_presence_counts(j_sharded, masks, jm)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :k], dense[rows_a].sum(axis=0))
    # The BitMatrix over the mesh slices the padding off, as grm_tpu's.
    bm = BitMatrix(packed, n_genomes, columns_sharding=tmesh.MeshSharding(
        mesh))
    assert bm.n_columns == n_kmers and bm.sharded
    np.testing.assert_array_equal(bm.presence_counts([rows_a, rows_b]),
                                  got[:, :k].astype(np.int64))
    np.testing.assert_array_equal(bm.sum_rows(rows_b), BitMatrix.from_dense(
        dense, device="cpu").sum_rows(rows_b))
    cols = np.array([0, n_kmers - 1, n_kmers // 2])
    np.testing.assert_array_equal(bm.get_columns_dense(cols), dense[:, cols])


@pytest.mark.parametrize("row_devices", [0, 1, 2])
def test_scm_device_step_equals_jax(row_devices):
    """0: unsharded on both sides; 1 and 2: the (1, 8) and (2, 4) meshes."""
    dense, y, packed = _data(5, n_kmers=300)
    n_genomes = dense.shape[0]
    if row_devices:
        matrix, k = tmesh.shard_bit_matrix(packed, _mesh(row_devices))
        jmat, _ = jmesh.shard_bit_matrix(
            packed, jmesh.make_mesh(8, row_devices=row_devices))
    else:
        matrix, k = masks_to_tensor(packed, "cpu"), dense.shape[1]
        jmat = jnp.asarray(packed)
    w = matrix.shape[0]
    pos = build_row_mask(np.where(y == 1)[0], n_genomes, 32)
    neg = build_row_mask(np.where(y == 0)[0], n_genomes, 32)
    pos_mask = np.zeros(w, np.uint32)
    neg_mask = np.zeros(w, np.uint32)
    pos_mask[:len(pos)] = pos
    neg_mask[:len(neg)] = neg
    jpos, jneg = pos_mask.copy(), neg_mask.copy()
    steps = 0
    for p in (1.0, 0.5, 2.0, 1.0):
        best, util, pos_mask, neg_mask, n_neg = tmesh.scm_device_step(
            matrix, pos_mask, neg_mask, p, k)
        jbest, jutil, jpos, jneg, jn_neg = jmesh.scm_device_step(
            jmat, jpos, jneg, p, k)
        assert int(best) == int(jbest)
        assert float(util) == float(jutil)
        np.testing.assert_array_equal(
            pos_mask.numpy().view(np.uint32), np.asarray(jpos))
        np.testing.assert_array_equal(
            neg_mask.numpy().view(np.uint32), np.asarray(jneg))
        assert int(n_neg) == int(jn_neg)
        steps += 1
        if int(n_neg) == 0:
            break
    assert steps >= 2


@pytest.mark.parametrize("row_devices", [1, 2])
def test_scm_fit_batch_device_sharded_equals_jax(row_devices):
    dense, y, packed = _data(8)
    n_genomes, n_kmers = dense.shape
    fits = make_cv_fits(y, n_genomes, packed.shape[0],
                        ps=(0.5, 1.0, 4.0), n_folds=2)
    pos = np.stack([f["pos_mask"] for f in fits])
    neg = np.stack([f["neg_mask"] for f in fits])
    ps = np.array([f["p"] for f in fits], np.float32)
    want = jmesh.scm_fit_batch_device(jnp.asarray(packed), jnp.asarray(pos),
                                      jnp.asarray(neg), jnp.asarray(ps),
                                      n_kmers, 5)
    matrix, _ = tmesh.shard_bit_matrix(packed, _mesh(row_devices))
    got = tmesh.scm_fit_batch_device(
        matrix, masks_to_tensor(pos, "cpu"), masks_to_tensor(neg, "cpu"),
        torch.from_numpy(ps), n_kmers, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("blacklist", [False, True])
@pytest.mark.parametrize("n_kmers", [531, 5])
def test_scm_cv_grid_sharded_equals_jax_and_unsharded(n_kmers, blacklist):
    dense, y, packed = _data(3 + blacklist, n_kmers=n_kmers, density=0.5)
    n_genomes = dense.shape[0]
    fits = make_cv_fits(y, n_genomes, packed.shape[0],
                        ps=(0.5, 1.0, 2.0, 4.0))
    excl = None
    if blacklist:
        excl = ([17, 17 + n_kmers, 200, 400 + n_kmers] if n_kmers > 401
                else [1, 3 + n_kmers])
    want = jax_grid_sharded(packed, fits, n_kmers, 6, jmesh.make_mesh(8),
                            block=64, sweep="xla", excl_rules=excl)
    got = scm_cv_grid_sharded(packed, fits, n_kmers, 6, _mesh(),
                              excl_rules=excl)
    unsharded = scm_cv_grid_device(masks_to_tensor(packed, "cpu"), fits,
                                   n_kmers, 6, excl_rules=excl)
    for g, w, u in zip(got, want, unsharded):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, u)
    if blacklist:
        assert not np.isin(got[0], excl).any()
    with pytest.raises(ValueError, match="shards columns only"):
        scm_cv_grid_sharded(packed, fits, n_kmers, 6, _mesh(2))


def test_scm_cv_batch_device_on_a_row_mesh_equals_jax():
    dense, y, packed = _data(12)
    n_genomes, n_kmers = dense.shape
    fits = make_cv_fits(y, n_genomes, packed.shape[0])
    jm = jmesh.make_mesh(8, row_devices=2)
    jmat, _ = jmesh.shard_bit_matrix(packed, jm)
    w = jmat.shape[0]
    for f in fits:  # masks over the row-padded width, as grm_tpu needs
        for key in ("pos_mask", "neg_mask", "test_pos_mask",
                    "test_neg_mask"):
            f[key] = np.pad(f[key], (0, w - len(f[key])))
    want = jax_scan(jmat, fits, n_kmers, 6)
    matrix, _ = tmesh.shard_bit_matrix(packed, _mesh(2))
    got = scm_cv_batch_device(matrix, fits, n_kmers, 6)
    unsharded = scm_cv_batch_device(
        masks_to_tensor(np.pad(packed, ((0, w - packed.shape[0]), (0, 0))),
                        "cpu"), fits, n_kmers, 6)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=1e-6)
    for g, u in zip(got, unsharded):
        np.testing.assert_array_equal(g, u)
    # The scan engine's fits equal the grid engine's (pure argmax both).
    grid = scm_cv_grid_device(masks_to_tensor(packed, "cpu"), [
        dict(f, **{k: f[k][:packed.shape[0]] for k in (
            "pos_mask", "neg_mask", "test_pos_mask", "test_neg_mask")})
        for f in fits], n_kmers, 6)
    np.testing.assert_array_equal(got[0], grid[0])


@pytest.mark.parametrize("n_kmers", [531, 5])
@pytest.mark.parametrize("criterion", ["gini", "cross-entropy"])
@pytest.mark.parametrize("blacklist", [False, True])
def test_cart_frontier_splits_sharded_equals_jax(blacklist, criterion,
                                                 n_kmers):
    rng = np.random.RandomState(40 + n_kmers)
    n_genomes = 50
    dense = (rng.rand(n_genomes, n_kmers) > 0.5).astype(np.uint8)
    y = (rng.rand(n_genomes) > 0.5).astype(np.uint8)
    dense[:, min(11, n_kmers - 1)] = y
    if n_kmers > 400:
        dense[:, 333] = y  # a tie in a later shard
    excl = None
    if blacklist:
        excl = np.zeros(n_kmers, bool)
        excl[[c for c in (11, 123, 400) if c < n_kmers] or [1]] = True
    node_sets = [
        {0: np.where(y == 0)[0], 1: np.where(y == 1)[0]},
        {0: np.where(y == 0)[0][:10], 1: np.where(y == 1)[0][:15]},
        {0: np.where(y == 0)[0][:1], 1: np.where(y == 1)[0][:0]},
    ]
    priors = [{0: 0.5, 1: 0.5}] * 3
    totals = [{0: float((y == 0).sum()), 1: float((y == 1).sum())}] * 3
    want = jax_cart_sharded(JaxBitMatrix.from_dense(dense), node_sets,
                            priors, totals, criterion, jmesh.make_mesh(8),
                            excl=excl)
    bm = BitMatrix.from_dense(dense, device="cpu")
    got = cart_frontier_splits_sharded(bm, node_sets, priors, totals,
                                       criterion, _mesh(), excl=excl)
    unsharded = cart_frontier_splits_device(bm, node_sets, priors, totals,
                                            criterion, excl=excl)
    assert [c for c, _ in got] == [c for c, _ in want]
    assert got == unsharded
    # XLA's float32 scores round a pure split's 0 to ~2e-9: scores compare
    # within float32 rounding, the columns exactly.
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-6, atol=1e-6)
    assert got[2] == (None, np.inf)
    # A matrix loaded on the mesh scores the same.
    loaded = BitMatrix(pack_binary_bytes_to_ints(dense, 32), n_genomes,
                       columns_sharding=tmesh.MeshSharding(_mesh()))
    assert cart_frontier_splits_sharded(loaded, node_sets, priors, totals,
                                        criterion, _mesh(), excl=excl) == got
    with pytest.raises(ValueError, match="shards columns only"):
        cart_frontier_splits_sharded(bm, node_sets, priors, totals,
                                     criterion, _mesh(2), excl=excl)


def test_eight_virtual_jax_devices():
    assert len(jax.devices()) == 8
