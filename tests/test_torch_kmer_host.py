"""The port's host ingest (grm_tpu_torch.kmer: counter and matrix) against
grm_tpu.kmer on the CPU: per-genome counts (the card's counting through its
plain versions) against both of grm_tpu's counting engines (its XLA one and
its host library), the union merge through both of the port's engines, and
the TSV writers and readers, exactly and byte for byte."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from grm_tpu.kmer import counter as jc
from grm_tpu.kmer import matrix as jm
from grm_tpu_torch.kmer import counter as tc
from grm_tpu_torch.kmer import matrix as tm

# grm_tpu's counting engines, each a reference for the port's one.
REF_ENGINES = ("device", "native")


def _write(path, text):
    if str(path).endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Six FASTA genomes sharing a backbone, two gzipped; one holds a contig
    shorter than every k tested and a lower-case contig, one is empty."""
    tmp = tmp_path_factory.mktemp("kmer_host")
    rng = np.random.RandomState(7)
    backbone = rng.choice(list("ACGT"), 700)
    specs = []
    for g in range(6):
        name = "g%d.fna" % g + (".gz" if g in (1, 4) else "")
        if g == 5:
            specs.append(("g5", _write(tmp / name, "")))
            continue
        s = backbone.copy()
        s[rng.randint(0, 700, 12)] = rng.choice(list("ACGTN"), 12)
        s = "".join(s)
        text = ">a\n%s\n%s\n>b\n%s\n" % (s[:350], s[350:], s[100:180].lower())
        if g == 2:
            text += ">short\nACGTAC\n"
        specs.append(("g%d" % g, _write(tmp / name, text)))
    return specs


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Four genomes' read directories: reads cut from one backbone (so
    k-mers repeat), two FASTQ files each, one gzipped, plus a file that is
    not FASTQ."""
    tmp = tmp_path_factory.mktemp("reads_host")
    rng = np.random.RandomState(8)
    backbone = "".join(rng.choice(list("ACGT"), 400))
    dirs = []
    for g in range(4):
        d = tmp / ("r%d" % g)
        d.mkdir()
        for part, name in enumerate(("a.fastq", "b.fq.gz")):
            lines = []
            for i in range(30):
                lo = rng.randint(0, 340)
                seq = backbone[lo:lo + rng.randint(20, 60)]
                if rng.rand() < 0.1:
                    seq = seq[:5] + "N" + seq[6:]
                lines.append("@r%d_%d\n%s\n+\n%s\n" % (part, i, seq,
                                                      "I" * len(seq)))
            _write(d / name, "".join(lines))
        (d / "notes.txt").write_text("not reads\n")
        dirs.append(("r%d" % g, str(d)))
    return dirs


def _same_genome(got, want):
    assert got.genome_id == want.genome_id and got.k == want.k
    np.testing.assert_array_equal(got.kmers, want.kmers)
    assert got.kmers.dtype == want.kmers.dtype == np.uint32
    if want.counts is None:
        assert got.counts is None
    else:
        np.testing.assert_array_equal(got.counts, want.counts)


@pytest.mark.parametrize("ref_engine", REF_ENGINES)
@pytest.mark.parametrize("k", [9, 15, 31, 32, 33])
def test_count_fasta(genomes, k, ref_engine):
    for keep_counts in (False, True):
        for gid, path in genomes:
            want = jc.count_fasta(path, k, keep_counts=keep_counts,
                                  engine=ref_engine)
            got = tc.count_fasta(path, k, keep_counts=keep_counts,
                                 device="cpu")
            _same_genome(got, want)
    assert tc.count_fasta(genomes[5][1], k, device="cpu").n_kmers == 0


@pytest.mark.parametrize("ref_engine", REF_ENGINES)
@pytest.mark.parametrize("k", [9, 31, 33])
def test_count_fasta_many(genomes, k, ref_engine):
    want = jc.count_fasta_many(genomes, k, engine=ref_engine)
    seen = []
    got = tc.count_fasta_many(dict(genomes), k, device="cpu",
                              progress_callback=lambda t, p: seen.append(p))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_genome(g, w)
    assert seen[-1] == 1.0


@pytest.mark.parametrize("ref_engine", REF_ENGINES)
@pytest.mark.parametrize("k", [9, 15, 31, 32, 33])
@pytest.mark.parametrize("abundance_min", [1, 3])
def test_count_reads_dir(reads, k, ref_engine, abundance_min):
    for gid, d in reads:
        want = jc.count_reads_dir(d, k, abundance_min=abundance_min,
                                  engine=ref_engine)
        got = tc.count_reads_dir(d, k, abundance_min=abundance_min,
                                 device="cpu")
        _same_genome(got, want)
        assert got.n_kmers > 0
    one_file = reads[0][1] + "/a.fastq"
    _same_genome(tc.count_reads_dir(one_file, k, device="cpu"),
                 jc.count_reads_dir(one_file, k, engine=ref_engine))


@pytest.mark.parametrize("abundance_min", [1, 2])
def test_count_reads_many(reads, abundance_min):
    want = jc.count_reads_many(reads, 31, abundance_min=abundance_min,
                               n_workers=2)
    seen = []
    got = tc.count_reads_many(reads, 31, abundance_min=abundance_min,
                              device="cpu",
                              progress_callback=lambda t, p: seen.append(p))
    assert seen[-1] == 1.0
    for g, w in zip(got, want):
        _same_genome(g, w)


def test_count_reads_dir_without_fastq(tmp_path):
    with pytest.raises(IOError, match="No FASTQ files"):
        tc.count_reads_dir(str(tmp_path), 9, device="cpu")


_TUNE_PROBE = r'''
import sys
import grm_tpu_torch
from grm_tpu_torch import hostmem
from grm_tpu_torch.kmer.counter import count_fasta, count_reads_dir
before = hostmem._done
count_fasta(sys.argv[1], 9, device="cpu")
after_fasta = hostmem._done
hostmem._done = False
count_reads_dir(sys.argv[2], 9, device="cpu")
print(before, after_fasta, hostmem._done)
'''


@pytest.mark.parametrize("opt_out", [False, True])
def test_counting_tunes_the_allocator_and_import_does_not(genomes, reads,
                                                          opt_out):
    """Importing the package leaves glibc's thresholds alone; the FASTA
    and reads counters raise them, unless GRM_NO_MALLOC_TUNE=1."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("GRM_NO_MALLOC_TUNE", None)
    if opt_out:
        env["GRM_NO_MALLOC_TUNE"] = "1"
    r = subprocess.run([sys.executable, "-c", _TUNE_PROBE, genomes[0][1],
                        reads[0][1]], cwd=repo, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    tuned = str(not opt_out)
    assert r.stdout.split() == ["False", tuned, tuned]


def test_fastq_to_sequences(reads):
    for _, d in reads:
        for name in ("a.fastq", "b.fq.gz"):
            assert (tc.fastq_to_sequences(d + "/" + name)
                    == jc.fastq_to_sequences(d + "/" + name))


def _genome_kmers(genomes, k):
    return ([tc.count_fasta(p, k, genome_id=g, device="cpu")
             for g, p in genomes],
            [jc.count_fasta(p, k, genome_id=g) for g, p in genomes])


def _same_matrix(got, want):
    assert got.k == want.k and got.genome_ids == want.genome_ids
    np.testing.assert_array_equal(got.kmers, want.kmers)
    np.testing.assert_array_equal(got.matrix, want.matrix)
    assert got.matrix.dtype == want.matrix.dtype == np.uint64


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("filter_singleton", [False, True])
@pytest.mark.parametrize("k", [9, 31, 33])
def test_build_presence_matrix(genomes, k, filter_singleton, engine):
    got_g, want_g = _genome_kmers(genomes, k)
    want = jm.build_presence_matrix(want_g, filter_singleton=filter_singleton)
    got = tm.build_presence_matrix(got_g, filter_singleton=filter_singleton,
                                   engine=engine, n_threads=2)
    _same_matrix(got, want)
    assert got.n_kmers > 0
    np.testing.assert_array_equal(got.dense(), want.dense())
    assert got.kmer_strings() == want.kmer_strings()


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_build_presence_matrix_filter_removes_everything(tmp_path, engine):
    paths = []
    for g, seq in enumerate(("ACGTTGCAAGGCTTAGC", "TTTTTTTTTTTTTTTTTG")):
        paths.append(("s%d" % g, _write(tmp_path / ("s%d.fna" % g),
                                        ">x\n%s\n" % seq)))
    got_g, want_g = _genome_kmers(paths, 9)
    want = jm.build_presence_matrix(want_g, filter_singleton=True)
    got = tm.build_presence_matrix(got_g, filter_singleton=True,
                                   engine=engine)
    assert got.n_kmers == want.n_kmers == 0
    _same_matrix(got, want)


def test_build_presence_matrix_errors(genomes):
    with pytest.raises(ValueError, match="At least one genome"):
        tm.build_presence_matrix([])
    a = tc.count_fasta(genomes[0][1], 9, device="cpu")
    b = tc.count_fasta(genomes[1][1], 11, device="cpu")
    with pytest.raises(ValueError, match="same k"):
        tm.build_presence_matrix([a, b])
    with pytest.raises(ValueError, match="engine"):
        tm.build_presence_matrix([a], engine="device")


@pytest.mark.parametrize("k", [9, 33])
def test_matrix_tsv_round_trip(genomes, tmp_path, k):
    got_g, want_g = _genome_kmers(genomes, k)
    want = jm.build_presence_matrix(want_g)
    got = tm.build_presence_matrix(got_g)
    jm.matrix_to_tsv(want, tmp_path / "want.tsv")
    tm.matrix_to_tsv(got, tmp_path / "got.tsv")
    assert (tmp_path / "got.tsv").read_bytes() == \
        (tmp_path / "want.tsv").read_bytes()
    ids, strings, dense = tm.read_matrix_tsv(tmp_path / "got.tsv")
    w_ids, w_strings, w_dense = jm.read_matrix_tsv(tmp_path / "want.tsv")
    assert (ids, strings) == (w_ids, w_strings)
    np.testing.assert_array_equal(dense, w_dense)
    np.testing.assert_array_equal(dense, got.dense())


def test_read_matrix_tsv_without_kmers(tmp_path):
    path = tmp_path / "empty.tsv"
    path.write_text("kmers\ta\tb\n\n")
    ids, strings, dense = tm.read_matrix_tsv(path)
    w = jm.read_matrix_tsv(path)
    assert (ids, strings) == (w[0], w[1]) == (["a", "b"], [])
    assert dense.shape == w[2].shape == (2, 0)


@pytest.mark.parametrize("reads_mode", [False, True])
def test_counts_to_tsv(genomes, reads, tmp_path, reads_mode):
    if reads_mode:
        got = tc.count_reads_dir(reads[1][1], 31, device="cpu")
        want = jc.count_reads_dir(reads[1][1], 31)
    else:
        got = tc.count_fasta(genomes[2][1], 33, keep_counts=True,
                             device="cpu")
        want = jc.count_fasta(genomes[2][1], 33, keep_counts=True)
    tm.counts_to_tsv(got, tmp_path / "got.tsv")
    jm.counts_to_tsv(want, tmp_path / "want.tsv")
    assert (tmp_path / "got.tsv").read_bytes() == \
        (tmp_path / "want.tsv").read_bytes()
    # Without counts every k-mer counts once; an empty genome writes nothing.
    for gk, name in ((tc.count_fasta(genomes[0][1], 9, device="cpu"), "a"),
                     (tc.count_fasta(genomes[5][1], 9, device="cpu"), "e")):
        tm.counts_to_tsv(gk, tmp_path / (name + ".tsv"))
        jm.counts_to_tsv(jc.count_fasta(
            genomes[0 if name == "a" else 5][1], 9),
            tmp_path / (name + "_want.tsv"))
        assert (tmp_path / (name + ".tsv")).read_bytes() == \
            (tmp_path / (name + "_want.tsv")).read_bytes()


def test_parse_survey_conf(tmp_path):
    good = tmp_path / "survey.conf"
    good.write_text("-k 21\n-run-surveyor\n-output /out dir/run\n"
                    "-write-kmer-matrix\n\n"
                    "-read-sample-assembly g1 /data/g 1.fna\n"
                    "-read-sample-assembly g2 /data/g2.fna\n")
    assert tm.parse_survey_conf(good) == jm.parse_survey_conf(good) == (
        21, [("g1", "/data/g 1.fna"), ("g2", "/data/g2.fna")],
        "/out dir/run")
    for text, message in (("-k x\n-read-sample-assembly a b\n", "non-integer"),
                          ("-read-sample-assembly a b\n", "missing the -k"),
                          ("-k 9\n", "no -read-sample-assembly")):
        bad = tmp_path / "bad.conf"
        bad.write_text(text)
        with pytest.raises(ValueError, match=message) as got:
            tm.parse_survey_conf(bad)
        with pytest.raises(ValueError) as want:
            jm.parse_survey_conf(bad)
        assert str(got.value) == str(want.value)


def test_kmer_rows_sort_key_orders_as_grm_tpu():
    rng = np.random.RandomState(4)
    for nw in (1, 2, 3, 8):
        rows = rng.randint(0, 2**32, (50, nw), dtype=np.uint64).astype(
            np.uint32)
        got, want = tm.kmer_rows_sort_key(rows), jm.kmer_rows_sort_key(rows)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.argsort(got, kind="stable"),
                                      np.argsort(want, kind="stable"))
