"""The port's multi-process matrix build (``grm_tpu_torch.parallel.build``
over ``torch.distributed`` with gloo) against the one-process builds: the
port's ``build_presence_matrix`` and ``grm_tpu``'s
``build_presence_matrix_distributed``, byte for byte, with and without the
singleton filter; then two real processes exchanging over gloo through a
file store, a genome list that differs between them (both must fail fast)
and a process whose input is missing (an error on every rank, no hang).
Every worker has a ``communicate`` timeout: there is no pytest-timeout."""

import os
import subprocess
import sys

import numpy as np
import pytest

from grm_tpu.parallel import build as jax_build
from grm_tpu.parallel.build import build_presence_matrix_distributed as jax_dist
from grm_tpu_torch.kmer import counter as tc
from grm_tpu_torch.kmer import matrix as tm
from grm_tpu_torch.parallel import build as port_build
from grm_tpu_torch.parallel import distributed as port_dist
from grm_tpu_torch.parallel.build import build_presence_matrix_distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds a two-process test may take


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Seven genomes of one backbone with their own substitutions (so some
    k-mers are in one genome only), one of them in two contigs."""
    tmp = tmp_path_factory.mktemp("dist_build")
    rng = np.random.RandomState(11)
    backbone = rng.choice(list("ACGT"), 600)
    specs = []
    for g in range(7):
        s = backbone.copy()
        s[rng.randint(0, 600, 10)] = rng.choice(list("ACGT"), 10)
        s = "".join(s)
        text = ">c\n%s\n" % s if g != 3 else ">a\n%s\n>b\n%s\n" % (s[:300],
                                                                  s[300:])
        path = tmp / ("d%02d.fna" % g)
        path.write_text(text)
        specs.append(("d%02d" % g, str(path)))
    return specs


def _local(specs, k, filter_singleton):
    gks = [tc.count_fasta(p, k, genome_id=gid, device="cpu")
           for gid, p in specs]
    return tm.build_presence_matrix(gks, filter_singleton=filter_singleton)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.kmers, want.kmers)
    np.testing.assert_array_equal(got.matrix, want.matrix)
    assert got.kmers.dtype == want.kmers.dtype
    assert got.matrix.dtype == want.matrix.dtype
    assert list(got.genome_ids) == list(want.genome_ids)


@pytest.mark.parametrize("filter_singleton", [False, True])
@pytest.mark.parametrize("k", [13, 31, 33])
def test_single_process_equals_local_and_jax(genomes, k, filter_singleton):
    got = build_presence_matrix_distributed(
        genomes, k, filter_singleton=filter_singleton, device="cpu")
    _assert_same(got, _local(genomes, k, filter_singleton))
    _assert_same(got, jax_dist(genomes, k, filter_singleton=filter_singleton))
    if filter_singleton:  # the filter had work to do
        assert got.kmers.shape[0] < _local(genomes, k, False).kmers.shape[0]


@pytest.mark.parametrize("n_shares", [2, 3])
def test_union_merge_equals_jax(genomes, n_shares):
    """The union of per-process unions (here: of disjoint genome shares)
    with the port's merge equals grm_tpu's np.unique merge."""
    k = 15
    nw = 1
    shares = [_local(genomes[i::n_shares], k, False).kmers
              for i in range(n_shares)]
    got = port_build._merge_sorted_unions(shares, nw, k)
    want = jax_build._merge_sorted_unions(shares, nw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _local(genomes, k, False).kmers)


def test_digest_and_helpers_equal_jax(genomes):
    for specs, k, flt in ((genomes, 31, True), (genomes[:3], 15, False)):
        np.testing.assert_array_equal(port_build._spec_digest(specs, k, flt),
                                      jax_build._spec_digest(specs, k, flt))
    items = list(range(11))
    for index in range(3):
        assert port_dist.shard_round_robin(items, index, 3) == \
            items[index::3]
    assert port_dist.process_index() == 0
    assert port_dist.process_count() == 1
    a = np.arange(12, dtype=np.uint32).reshape(4, 3)
    (got,) = port_dist.all_gather_arrays(a)
    np.testing.assert_array_equal(got, a)
    port_dist.initialize()  # one process: nothing to join
    port_build._check_spec_agreement(genomes, 31, False)


_WORKER = r"""
import os, sys
sys.path.insert(0, %(repo)r)
import numpy as np
from grm_tpu_torch.parallel.distributed import initialize
rank = int(sys.argv[1])
initialize(%(store)r, num_processes=2, process_id=rank, timeout=%(timeout)d)
from grm_tpu_torch.parallel.build import build_presence_matrix_distributed
specs = %(specs_by_rank)r[rank]
try:
    km = build_presence_matrix_distributed(
        specs, %(k)d, filter_singleton=%(filter)r, device="cpu")
except Exception as e:
    sys.stderr.write("GRM_FAULT: %%s\n" %% e)
    sys.stderr.flush()
    os._exit(3)  # a faulted worker must not wait on its peer at exit
np.save(%(out)r + "%%d_kmers.npy" %% rank, km.kmers)
np.save(%(out)r + "%%d_matrix.npy" %% rank, km.matrix)
# Leave the group before the interpreter exits: gloo's threads torn down at
# exit can abort the process ("terminate called without an active
# exception").
import torch.distributed
torch.distributed.destroy_process_group()
"""


def _launch(tmp_path, specs_by_rank, k, filter_singleton=False, timeout=60):
    script = _WORKER % {
        "repo": REPO, "store": "file://" + str(tmp_path / "store"),
        "timeout": timeout, "specs_by_rank": specs_by_rank, "k": k,
        "filter": filter_singleton, "out": str(tmp_path / "proc_")}
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    return [subprocess.Popen([sys.executable, "-c", script, str(rank)],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
            for rank in range(2)]


def _finish(procs):
    """Each process's (returncode, stderr), every one reaped in time."""
    out = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            raise AssertionError("a worker hung past %d s" % TIMEOUT)
        out.append((p.returncode, err.decode()))
    return out


@pytest.mark.parametrize("filter_singleton", [False, True])
def test_two_process_build_matches_local(tmp_path, genomes,
                                         filter_singleton):
    k = 15
    procs = _launch(tmp_path, [genomes, genomes], k, filter_singleton)
    for rc, err in _finish(procs):
        assert rc == 0, err[-2000:]
    want = _local(genomes, k, filter_singleton)
    for rank in range(2):
        kmers = np.load(tmp_path / ("proc_%d_kmers.npy" % rank))
        matrix = np.load(tmp_path / ("proc_%d_matrix.npy" % rank))
        np.testing.assert_array_equal(kmers, want.kmers)
        np.testing.assert_array_equal(matrix, want.matrix)
        assert matrix.dtype == np.uint64


def test_two_process_genome_list_mismatch_fails_fast(tmp_path, genomes):
    """A genome list that differs between the processes gives a clean error
    naming the mismatch on EVERY rank, not a hang or a diverged matrix."""
    mismatched = list(genomes[:4])
    mismatched[2] = ("zz_other", mismatched[2][1])  # rank 1 disagrees
    procs = _launch(tmp_path, [genomes[:4], mismatched], 11)
    for rc, err in _finish(procs):
        assert rc == 3, err[-1500:]
        assert "GRM_FAULT" in err and "input mismatch" in err


def test_two_process_failing_process_surfaces_error(tmp_path, genomes):
    """A process whose input is unreadable exits with an error carrying the
    cause; its peer, waiting in the exchange, errors too instead of hanging
    (within the process group's timeout)."""
    broken = list(genomes[:4])
    # round-robin: rank 1 owns genome indices 1 and 3
    broken[1] = (broken[1][0], str(tmp_path / "missing.fna"))
    procs = _launch(tmp_path, [broken, broken], 11, timeout=30)
    (rc0, err0), (rc1, err1) = _finish(procs)
    assert rc1 == 3, err1[-1500:]
    assert "GRM_FAULT" in err1 and "missing.fna" in err1
    assert rc0 == 3, err0[-1500:]
    assert "GRM_FAULT" in err0
    assert not (tmp_path / "proc_0_matrix.npy").exists()
