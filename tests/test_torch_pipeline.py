"""The port's in-memory pipeline (grm_tpu_torch.pipeline) against
grm_tpu.pipeline on the CPU: FASTA files -> device ingest -> train_scm give
the same union, rules, split and metrics."""

import numpy as np
import pytest
import torch

from grm_tpu import pipeline as jp
from grm_tpu_torch import pipeline as tp

MARKER = "TTAACCGGATCGATCGGCTAGCTAACG"


@pytest.fixture
def fasta(tmp_path, rng):
    """40 genomes: mutated copies of one backbone, half with a marker, each
    with a second contig holding an invalid base."""
    backbone = rng.choice(list("ACGT"), 500)
    specs, labels = [], {}
    for i in range(40):
        gid = "m%02d" % i
        s = backbone.copy()
        s[rng.randint(0, 500, 8)] = rng.choice(list("ACGT"), 8)
        s = "".join(s)
        seq = s[:250] + (MARKER if i % 2 else "") + s[250:]
        path = tmp_path / ("%s.fna" % gid)
        path.write_text(">c\n%s\n%s\n>d\nACGTACNGTACGTTGCA\n"
                        % (seq[:300], seq[300:]))
        specs.append((gid, str(path)))
        labels[gid] = i % 2
    return specs, labels


def _result(r):
    return ([str(x) for x in r.rules], [str(x) for x in r.model.rules],
            r.train_idx.tolist(), r.test_idx.tolist(),
            repr(r.train_metrics), repr(r.test_metrics))


@pytest.mark.parametrize("genome_batch,filter_singleton",
                         [(None, False), (None, True), (32, False),
                          (32, True)])
def test_from_contigs_device_then_train_scm(fasta, genome_batch,
                                            filter_singleton):
    specs, labels = fasta
    kw = dict(filter_singleton=filter_singleton, genome_batch=genome_batch)
    want = jp.InMemoryDataset.from_contigs_device(specs, labels, 15, **kw)
    got = tp.InMemoryDataset.from_contigs_device(specs, labels, 15,
                                                 device="cpu", **kw)
    assert isinstance(got, tp.DeviceDataset)
    assert got.kmer_count == want.kmer_count
    assert got.genome_count == want.genome_count
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.km.kmers, want.km.kmers)
    cols = [0, got.kmer_count - 1, got.kmer_count, 2 * got.kmer_count - 1]
    np.testing.assert_array_equal(got.get_matrix_columns(cols),
                                  want.get_matrix_columns(cols))
    for model_type, p, seed in (("conjunction", 1.0, 3),
                                ("disjunction", 0.5, 7)):
        r_want = jp.train_scm(want, model_type=model_type, p=p,
                              max_rules=4, random_seed=seed)
        r_got = tp.train_scm(got, model_type=model_type, p=p, max_rules=4,
                             random_seed=seed)
        assert _result(r_got) == _result(r_want)
    assert r_got.rules  # the marker is learned


def test_mesh_and_host_ingest_raise(fasta):
    """A mesh of another device type than the dataset's raises wherever it
    is asked for (the run never moves to it); a mesh of the dataset's own
    device type shards the matrix, from both ingests."""
    from grm_tpu_torch.parallel.mesh import MeshSharding, make_mesh

    specs, labels = fasta
    cuda = make_mesh(2, devices=[torch.device("cuda", 0)] * 2)
    cpu = MeshSharding(make_mesh(2, devices=[torch.device("cpu")] * 2))
    ds = tp.InMemoryDataset.from_contigs_device(specs, labels, 15,
                                                device="cpu")
    with pytest.raises(ValueError, match="not cpu devices"):
        tp.train_scm(ds, mesh=cuda)
    assert ds.bit_matrix(sharding=cpu).sharded
    assert not ds.bit_matrix().sharded
    host = tp.InMemoryDataset.from_contigs(specs, labels, 15, sharding=cpu,
                                           device="cpu")
    with pytest.raises(ValueError, match="not cpu devices"):
        tp.train_scm(host, mesh=cuda)
    assert host.bit_matrix().sharded
    assert tp.InMemoryDataset(host.km, labels, sharding=cpu,
                              device="cpu").bit_matrix().sharded
    fresh = tp.InMemoryDataset(host.km, labels, device="cpu")
    assert fresh.bit_matrix(sharding=cpu).sharded


@pytest.mark.parametrize("k,filter_singleton",
                         [(15, False), (15, True), (31, True)])
def test_from_contigs_then_train_scm(fasta, k, filter_singleton):
    """Host ingest (counting on the card's plain versions, the union merged
    on the host) + train_scm against grm_tpu's."""
    specs, labels = fasta
    want = jp.InMemoryDataset.from_contigs(specs, labels, k,
                                           filter_singleton=filter_singleton)
    got = tp.InMemoryDataset.from_contigs(specs, labels, k,
                                          filter_singleton=filter_singleton,
                                          device="cpu")
    assert isinstance(got, tp.InMemoryDataset)
    assert (got.genome_count, got.kmer_count) == (want.genome_count,
                                                  want.kmer_count)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.km.kmers, want.km.kmers)
    np.testing.assert_array_equal(got.km.matrix, want.km.matrix)
    assert got.km.genome_ids == want.km.genome_ids
    cols = [0, got.kmer_count - 1, got.kmer_count, 2 * got.kmer_count - 1]
    np.testing.assert_array_equal(got.get_matrix_columns(cols),
                                  want.get_matrix_columns(cols))
    for model_type, p, seed in (("conjunction", 1.0, 3),
                                ("disjunction", 0.5, 7)):
        r_want = jp.train_scm(want, model_type=model_type, p=p,
                              max_rules=4, random_seed=seed)
        r_got = tp.train_scm(got, model_type=model_type, p=p, max_rules=4,
                             random_seed=seed)
        assert _result(r_got) == _result(r_want)
    assert r_got.rules  # the marker is learned


def test_from_contigs_device_needs_cuda_by_default(fasta):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    specs, labels = fasta
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.InMemoryDataset.from_contigs_device(specs, labels, 15)


def test_fasta_to_sequences_matches(tmp_path):
    from grm_tpu.utils import fasta_to_sequences as want
    from grm_tpu_torch.utils import fasta_to_sequences as got

    path = tmp_path / "x.fna"
    path.write_text(">a\nacgt\nNNgg\n>b\n\n>c\nTT\n")
    assert got(str(path)) == want(str(path)) == ["ACGTNNGG", "", "TT"]
