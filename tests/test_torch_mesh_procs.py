"""A mesh that spans processes: the port's sharded engines run by two and
four gloo processes on the CPU (``tests/torch_mesh_worker.py``, each
process naming the CPU as its 4 or 2 devices), against ``grm_tpu`` on its 8
virtual devices in this process and against the port's one-process runs.

``grm_tpu``'s two yardsticks, at their data (``tests/test_distributed_build
.py``: 60 genomes x 517 k-mers from ``RandomState(42)``):
two processes x 4 devices run ``scm_cv_grid_sharded`` (with and without a
blacklist), which must equal ``grm_tpu``'s on ``make_mesh(8)`` and its
scan engine; four processes x 2 devices run ``scm_device_step`` on a (2, 4)
mesh whose both axes cross processes, which must equal ``grm_tpu``'s. The
same groups run ``sharded_presence_counts`` and the scan engine with the
row axis across processes, and ``cart_frontier_splits_sharded`` for both
criteria. Columns 17 and 300 hold the same perfect marker, on two
processes: the cross-process tie must go to the lower column. Rules, rule
counts and columns compare exactly; risks to 1e-6 and CART scores within
float32 rounding (``grm_tpu``'s tolerances). Then each process's shards,
and the faults: a mismatched input and a dead peer must end every process
with an error, within the group's timeout. Every worker has a
``communicate`` timeout: there is no pytest-timeout."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from grm_tpu.ops.popcount import BitMatrix as JaxBitMatrix
from grm_tpu.parallel import mesh as jmesh
from grm_tpu.parallel.cart_device import (
    cart_frontier_splits_sharded as jax_cart_sharded,
)
from grm_tpu.parallel.scm_device import scm_cv_batch_device as jax_scan
from grm_tpu.parallel.scm_grid import scm_cv_grid_sharded as jax_grid
from grm_tpu.utils import build_row_mask, pack_binary_bytes_to_ints

from grm_tpu_torch.ops.popcount import BitMatrix, masks_to_tensor
from grm_tpu_torch.parallel import mesh as tmesh
from grm_tpu_torch.parallel.cart_device import cart_frontier_splits_sharded
from grm_tpu_torch.parallel.scm_grid import (
    scm_cv_grid_device,
    scm_cv_grid_sharded,
)

from helpers_scm import make_cv_fits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")
TIMEOUT = 150  # seconds a group of workers may take
N_GENOMES, N_KMERS, MAX_RULES = 60, 517, 4
CRITERIA = ("gini", "cross-entropy")


def run_workers(tmp, world, local_devices, cases, inputs, timeout=60,
                fault=None):
    """``world`` worker processes over a file store in ``tmp``, each with
    ``local_devices`` CPU devices, running ``cases``. Returns [(returncode,
    stderr, outputs or None)] in rank order; kills them all past
    :data:`TIMEOUT`."""
    tmp = str(tmp)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    spec = os.path.join(tmp, "spec.json")
    with open(spec, "w") as f:
        json.dump({"store": "file://" + os.path.join(tmp, "store"),
                   "world": world, "local_devices": local_devices,
                   "timeout": timeout, "inputs": os.path.join(
                       tmp, "inputs.pkl"), "cases": cases,
                   "out": os.path.join(tmp, "out_"), "fault": fault}, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, WORKER, spec, str(rank)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for rank in range(world)]
    results = []
    try:
        for rank, p in enumerate(procs):
            _, err = p.communicate(timeout=TIMEOUT)
            path = os.path.join(tmp, "out_%d.pkl" % rank)
            out = None
            if p.returncode == 0 and os.path.exists(path):
                with open(path, "rb") as f:
                    out = pickle.load(f)  # written by the worker above
            results.append((p.returncode, err.decode(), out))
    except subprocess.TimeoutExpired:
        raise AssertionError("a worker hung past %d s" % TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def _outputs(results):
    for rank, (rc, err, out) in enumerate(results):
        assert rc == 0 and out is not None, (rank, rc, err[-3000:])
    return [out for _, _, out in results]


def _yardstick():
    """``tests/test_distributed_build.py``'s data (its ``rng`` fixture),
    with a perfect marker at columns 17 and 300: a tie across processes."""
    rng = np.random.RandomState(42)
    dense = (rng.rand(N_GENOMES, N_KMERS) > 0.6).astype(np.uint8)
    y = (rng.rand(N_GENOMES) > 0.5).astype(np.uint8)
    tied = dense.copy()
    tied[:, 17] = tied[:, 300] = y
    return dense, tied, y


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Two processes x 4 devices: the CV grid on both data, the CART
    frontier."""
    dense, tied, y = _yardstick()
    inputs = {"n_genomes": N_GENOMES, "n_kmers": N_KMERS,
              "max_rules": MAX_RULES, "grid_excl": [17, 17 + N_KMERS, 200,
                                                    400 + N_KMERS]}
    per_data = {}
    for name, d in (("yardstick", dense), ("tied", tied)):
        packed = pack_binary_bytes_to_ints(d, 32)
        fits = make_cv_fits(y, N_GENOMES, packed.shape[0], ps=(0.5, 2.0),
                            n_folds=2)
        per_data[name] = dict(inputs, packed=packed, fits=fits)
    node_sets = [
        {0: np.where(y == 0)[0], 1: np.where(y == 1)[0]},
        {0: np.where(y == 0)[0][:10], 1: np.where(y == 1)[0][:15]},
        {0: np.where(y == 0)[0][:1], 1: np.where(y == 1)[0][:0]},
    ]
    cart_excl = np.zeros(N_KMERS, bool)
    cart_excl[[11, 17, 123, 400]] = True  # the lower marker too
    per_data["tied"].update(
        node_sets=node_sets, priors=[{0: 0.5, 1: 0.5}] * 3,
        totals=[{0: float((y == 0).sum()), 1: float((y == 1).sum())}] * 3,
        cart_excl=cart_excl)
    out = {}
    for name, cases in (("yardstick", ["grid"]), ("tied", ["grid", "cart"])):
        tmp = tmp_path_factory.mktemp("two_" + name)
        out[name] = _outputs(run_workers(tmp, 2, 4, cases, per_data[name]))
    return per_data, out


def test_two_process_grid_equals_jax_and_the_scan_engine(two):
    """grm_tpu's first yardstick: the column-sharded CV grid over 2
    processes x 4 devices equals grm_tpu's on make_mesh(8), its scan engine
    and the port's one-process run, on every rank."""
    per_data, out = two
    inp = per_data["yardstick"]
    want = jax_grid(inp["packed"], inp["fits"], N_KMERS, MAX_RULES,
                    jmesh.make_mesh(8), block=64, sweep="xla")
    scan = jax_scan(inp["packed"], inp["fits"], N_KMERS, MAX_RULES)
    local = scm_cv_grid_sharded(inp["packed"], inp["fits"], N_KMERS,
                                MAX_RULES, _local_mesh())
    for rank_out in out["yardstick"]:
        got = rank_out["grid"]["plain"]
        for g, u in zip(got, local):
            np.testing.assert_array_equal(g, u)
        for ref in (want, scan):
            np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
            np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
            np.testing.assert_allclose(got[2], np.asarray(ref[2]), atol=1e-6)


def _local_mesh(row_devices=1):
    """One process's 8-device mesh of the CPU."""
    return tmesh.make_mesh(8, row_devices=row_devices,
                           devices=[torch.device("cpu")] * 8)


@pytest.mark.parametrize("blacklist", [False, True])
def test_two_process_grid_ties_across_processes(two, blacklist):
    """A perfect marker in both processes' shards: every rank picks the
    lower column, as grm_tpu and the unsharded grid do; with the blacklist
    (which bans column 17's presence rule) the higher one."""
    per_data, out = two
    inp = per_data["tied"]
    excl = inp["grid_excl"] if blacklist else None
    want = jax_grid(inp["packed"], inp["fits"], N_KMERS, MAX_RULES,
                    jmesh.make_mesh(8), block=64, sweep="xla",
                    excl_rules=excl)
    unsharded = scm_cv_grid_device(masks_to_tensor(inp["packed"], "cpu"),
                                   inp["fits"], N_KMERS, MAX_RULES,
                                   excl_rules=excl)
    for rank_out in out["tied"]:
        got = rank_out["grid"]["blacklist" if blacklist else "plain"]
        for g, w, u in zip(got, want, unsharded):
            np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(g, u)
    first = out["tied"][0]["grid"]["blacklist" if blacklist else "plain"][0]
    assert (first[:, 0] == (300 if blacklist else 17)).any()


@pytest.mark.parametrize("blacklist", [False, True])
@pytest.mark.parametrize("criterion", CRITERIA)
def test_two_process_cart_frontier_equals_jax(two, criterion, blacklist):
    per_data, out = two
    inp = per_data["tied"]
    dense = _yardstick()[1]
    excl = inp["cart_excl"] if blacklist else None
    args = (inp["node_sets"], inp["priors"], inp["totals"], criterion)
    want = jax_cart_sharded(JaxBitMatrix.from_dense(dense), *args,
                            jmesh.make_mesh(8), excl=excl)
    local = cart_frontier_splits_sharded(
        BitMatrix.from_dense(dense, device="cpu"), *args, _local_mesh(),
        excl=excl)
    for rank_out in out["tied"]:
        got = rank_out["cart"][(criterion, blacklist)]
        assert got == local
        assert [c for c, _ in got] == [c for c, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   rtol=1e-6, atol=1e-6)
    assert got[0][0] == (300 if blacklist else 17)
    assert got[2] == (None, np.inf)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """Four processes x 2 devices on a (2, 4) mesh: grm_tpu's second
    yardstick and the row-sharded counts and scan."""
    dense, _, y = _yardstick()
    packed = pack_binary_bytes_to_ints(dense, 32)
    w = packed.shape[0]
    pos_mask = np.zeros(w, np.uint32)
    neg_mask = np.zeros(w, np.uint32)
    pm = build_row_mask(np.where(y == 1)[0], N_GENOMES, 32)
    nm = build_row_mask(np.where(y == 0)[0], N_GENOMES, 32)
    pos_mask[:len(pm)] = pm
    neg_mask[:len(nm)] = nm
    rng = np.random.RandomState(5)
    count_masks = np.stack([build_row_mask(rng.choice(N_GENOMES, n, False),
                                           N_GENOMES, 32) for n in (40, 13)])
    inputs = {"packed": packed, "n_kmers": N_KMERS, "max_rules": MAX_RULES,
              "pos_mask": pos_mask, "neg_mask": neg_mask,
              "count_masks": count_masks,
              "row_fits": make_cv_fits(y, N_GENOMES, w, ps=(0.5, 2.0),
                                       n_folds=2)}
    tmp = tmp_path_factory.mktemp("four")
    return inputs, _outputs(run_workers(tmp, 4, 2, ["rows"], inputs))


def test_four_process_multiaxis_device_step_equals_jax(four):
    """grm_tpu's second yardstick: three scm_device_steps on a (2, 4) mesh
    over 4 processes x 2 devices equal grm_tpu's on one process's (2, 4)
    mesh, and the port's one-process (2, 4) mesh, on every rank."""
    inputs, out = four
    jm = jmesh.make_mesh(8, row_devices=2)
    jmat, k = jmesh.shard_bit_matrix(inputs["packed"], jm)
    tmat, _ = tmesh.shard_bit_matrix(inputs["packed"], _local_mesh(2))
    pos, neg = inputs["pos_mask"].copy(), inputs["neg_mask"].copy()
    tpos, tneg = pos.copy(), neg.copy()
    want, mine = [], []
    for _ in range(3):
        best, util, pos, neg, n_neg = jmesh.scm_device_step(
            jmat, pos, neg, 1.0, k)
        want.append((int(best), float(util), int(n_neg)))
        tb, tu, tpos, tneg, tn = tmesh.scm_device_step(tmat, tpos, tneg, 1.0,
                                                       k)
        mine.append((int(tb), float(tu), int(tn)))
        if int(n_neg) == 0:
            break
    assert mine == want
    for rank_out in out:
        assert rank_out["rows"]["steps"] == want


def test_four_process_row_axis_counts_and_scan_equal_jax(four):
    """sharded_presence_counts and the scan engine with the row axis
    across processes."""
    inputs, out = four
    jm = jmesh.make_mesh(8, row_devices=2)
    jmat, _ = jmesh.shard_bit_matrix(inputs["packed"], jm)
    masks = np.zeros((2, jmat.shape[0]), np.uint32)
    masks[:, :inputs["count_masks"].shape[1]] = inputs["count_masks"]
    want_counts = jmesh.sharded_presence_counts(jmat, masks, jm)
    want_scan = jax_scan(jmat, inputs["row_fits"], N_KMERS, MAX_RULES)
    for rank_out in out:
        got = rank_out["rows"]
        np.testing.assert_array_equal(got["counts"], want_counts)
        np.testing.assert_array_equal(got["scan"][0], np.asarray(want_scan[0]))
        np.testing.assert_array_equal(got["scan"][1], np.asarray(want_scan[1]))
        np.testing.assert_allclose(got["scan"][2], np.asarray(want_scan[2]),
                                   atol=1e-6)
        # The engines that walk whole column shards refuse rows that span
        # processes, rather than pull another process's rows.
        assert "span processes" in got["refusal"]


def test_each_process_holds_only_its_shards(two, four):
    """Owners in process-major order, rank 0's devices first; each process
    holds tensors for its own positions only, never another's shard."""
    _, out2 = two
    _, out4 = four
    for world, outs, key, owners in (
            (2, out2["yardstick"], "grid", [[0] * 4 + [1] * 4]),
            (4, out4, "rows", [[0, 0, 1, 1], [2, 2, 3, 3]])):
        total = 0
        for rank, rank_out in enumerate(outs):
            held = rank_out[key]["held"]
            assert held["owners"] == owners
            mine = sorted((r, c) for r, row in enumerate(owners)
                          for c, o in enumerate(row) if o == rank)
            assert sorted(held["positions"]) == mine
            assert held["none"] == 8 - len(mine)
            total += held["words"]
        # The shards of all processes together are the padded matrix once.
        lw = -(-2 // len(owners))
        lk = -(-N_KMERS // len(owners[0]))
        assert total == lw * lk * 8


def _fault(tmp_path, fault, timeout):
    dense, _, y = _yardstick()
    packed = pack_binary_bytes_to_ints(dense, 32)
    inputs = {"packed": packed, "n_kmers": N_KMERS, "max_rules": MAX_RULES,
              "fits": make_cv_fits(y, N_GENOMES, packed.shape[0],
                                   ps=(0.5, 2.0), n_folds=2)}
    return run_workers(tmp_path, 2, 4, ["fault"], inputs, timeout=timeout,
                       fault=fault)


@pytest.mark.parametrize("fault,what", [
    ("fits", "the CV grid's fits"), ("shape", "the matrix's shape")])
def test_mismatched_input_fails_on_every_process(tmp_path, fault, what):
    """A process whose fits, or whose matrix's shape, differ: every process
    raises with the cause before any sweep, none hangs."""
    for rank, (rc, err, _) in enumerate(_fault(tmp_path, fault, 60)):
        assert rc == 3, (rank, rc, err[-2000:])
        assert "GRM_FAULT" in err and "input mismatch" in err
        assert "process(es) [1]" in err and what in err


def test_dead_peer_raises_within_the_timeout(tmp_path):
    """A process that dies after the mesh is made: its peer, in the next
    collective, raises within the group's timeout instead of hanging."""
    import time

    t0 = time.time()
    (rc0, err0, _), (rc1, _, _) = _fault(tmp_path, "dead", 10)
    assert rc1 == 4
    assert rc0 == 3, err0[-2000:]
    assert "GRM_FAULT" in err0
    assert time.time() - t0 < 10 + 60
