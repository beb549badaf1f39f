"""The port's host library (grm_tpu_torch/native: grmio.cpp built with g++
into grm_tpu_torch/_kernels/) against grm_tpu.native.bindings and against
the numpy and plain PyTorch versions: every ctypes entry, exactly. A build
that fails raises, and the process never maps grm_tpu's libgrmio.so."""

import gzip
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from grm_tpu.native import bindings as jb
from grm_tpu_torch.native import bindings as tb
from grm_tpu_torch.ops import kmer as tk
from grm_tpu_torch.utils import fasta_to_sequences

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fasta_text(rng, n_contigs=3, length=400, lower=False):
    out = []
    for c in range(n_contigs):
        seq = "".join(rng.choice(list("ACGTACGTACGTN"), length))
        if lower and c == 1:
            seq = seq.lower()
        out.append(">contig%d some description\n" % c)
        out.extend(seq[i:i + 70] + "\n" for i in range(0, len(seq), 70))
    return "".join(out)


def _kmer_lists(rng, k, n_genomes=7, length=600):
    """Per-genome sorted distinct k-mers (plain versions on the CPU) of
    genomes that share half their sequence; one genome empty."""
    shared = rng.randint(0, 4, length // 2).astype(np.int8)
    lists = []
    for g in range(n_genomes):
        if g == 3:
            codes = np.zeros(0, np.int8)
        else:
            codes = np.concatenate([shared, rng.randint(
                0, 5, length - length // 2).astype(np.int8)])
        lists.append(tk.sorted_kmers_np(codes, k, device="cpu"))
    return lists


def test_library_is_built_into_the_ports_kernel_directory():
    tb.library()
    path = tb._lib_path()
    assert path.exists()
    assert path.parent == tb.BUILD_DIR
    assert path.parent.name == "_kernels"
    assert path.parent.parent.name == "grm_tpu_torch"
    assert path.name.startswith("libgrmio-")


@pytest.mark.parametrize("lower", [False, True])
def test_encode_fasta(tmp_path, lower):
    rng = np.random.RandomState(1 + lower)
    text = _fasta_text(rng, lower=lower)
    path = tmp_path / "g.fna"
    path.write_text(text)
    got = tb.encode_fasta_native(text)
    np.testing.assert_array_equal(got, jb.encode_fasta_native(text))
    np.testing.assert_array_equal(got, tb.encode_fasta_native(text.encode()))
    want = tk.encode_contigs(fasta_to_sequences(str(path)))
    np.testing.assert_array_equal(got, want)


def test_encode_fastq(tmp_path):
    from grm_tpu_torch.kmer.counter import fastq_to_sequences

    rng = np.random.RandomState(3)
    reads = ["".join(rng.choice(list("ACGTN"), rng.randint(20, 90)))
             for _ in range(25)]
    text = "".join("@r%d\n%s\n+\n%s\n" % (i, r, "I" * len(r))
                   for i, r in enumerate(reads))
    got = tb.encode_fasta_native(text, fastq=True)
    np.testing.assert_array_equal(got, jb.encode_fasta_native(text,
                                                              fastq=True))
    path = str(tmp_path / "r.fq.gz")
    with gzip.open(path, "wt") as f:
        f.write(text)
    np.testing.assert_array_equal(
        got, tk.encode_contigs(fastq_to_sequences(path)))


def _numpy_merge(lists, nw):
    """The plain version: union, genome counts, packed matrix."""
    from grm_tpu_torch.kmer.counter import GenomeKmers
    from grm_tpu_torch.kmer.matrix import build_presence_matrix, \
        kmer_rows_sort_key

    km = build_presence_matrix(
        [GenomeKmers(str(i), 16 * nw, a) for i, a in enumerate(lists)],
        engine="numpy")
    keys = kmer_rows_sort_key(km.kmers)
    cols = [np.searchsorted(keys, kmer_rows_sort_key(a)) for a in lists]
    counts = np.zeros(km.n_kmers, np.int32)
    for c in cols:
        counts[c] += 1
    return km.kmers, counts, km.matrix


@pytest.mark.parametrize("k", [9, 31, 33, 64])
def test_merges(k):
    nw = tk.n_words_for_k(k)
    lists = _kmer_lists(np.random.RandomState(k + 1), k)
    union, counts, matrix = _numpy_merge(lists, nw)

    got = tb.merge_union_bits_native(lists, nw)
    want = jb.merge_union_bits_native(lists, nw)
    for g, w, p in zip(got, want, (union, counts, matrix)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)

    for n_threads in (1, 3):  # min_total 0 partitions even a small merge
        got = tb.merge_union_bits_parallel(lists, nw, n_threads=n_threads,
                                           min_total=0)
        want = jb.merge_union_bits_parallel(lists, nw, n_threads=n_threads,
                                            min_total=0)
        for g, w, p in zip(got, want, (union, counts, matrix)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tb, "_lib", None)
    monkeypatch.setattr(tb, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tb, "CXX_FLAGS", tb.CXX_FLAGS + ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="building the host library "
                                           "failed"):
        tb.library()
    assert not list(tmp_path.glob("*.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        tb.library()
    # The counter's encoder and the merge take the native route and raise
    # with it.
    from grm_tpu_torch.kmer.counter import GenomeKmers, count_fasta
    from grm_tpu_torch.kmer.matrix import build_presence_matrix

    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        build_presence_matrix([GenomeKmers("a", 9, np.zeros((1, 1),
                                                             np.uint32))])
    (tmp_path / "g.fna").write_text(">a\nACGTACGTAC\n")
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        count_fasta(str(tmp_path / "g.fna"), 5, device="cpu")


def test_threads_build_the_library_once(monkeypatch, tmp_path):
    """Threads that ask for the library at once on an empty build directory
    share one build: each gets the same loaded library, and no temporary
    file is left behind."""
    monkeypatch.setattr(tb, "_lib", None)
    monkeypatch.setattr(tb, "BUILD_DIR", tmp_path)
    builds = []
    run = tb._run

    def counting_run(cmd):
        if "-o" in cmd:
            builds.append(cmd)
        return run(cmd)

    monkeypatch.setattr(tb, "_run", counting_run)
    with ThreadPoolExecutor(max_workers=6) as pool:
        libs = list(pool.map(lambda _: tb.library(), range(6)))
    assert len(builds) == 1
    assert all(lib is libs[0] for lib in libs)
    assert [p.name for p in tmp_path.iterdir()] == [tb._lib_path().name]
    text = ">a\nACGTNacgt\n"
    np.testing.assert_array_equal(tb.encode_fasta_native(text),
                                  jb.encode_fasta_native(text))


_MAPS_PROBE = r'''
import sys
import numpy as np
from grm_tpu_torch.kmer.counter import count_fasta
from grm_tpu_torch.kmer.matrix import build_presence_matrix
path = sys.argv[1]
gks = [count_fasta(path, 15, genome_id=g, device="cpu") for g in "abc"]
km = build_presence_matrix(gks)
assert km.n_kmers > 0
print(open("/proc/self/maps").read())
'''


def test_process_maps_only_the_ports_library(tmp_path):
    path = tmp_path / "g.fna"
    path.write_text(_fasta_text(np.random.RandomState(9)))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "-c", _MAPS_PROBE, str(path)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    maps = r.stdout
    assert os.path.join("grm_tpu_torch", "_kernels", "libgrmio-") in maps
    assert os.path.join("grm_tpu", "native", "libgrmio.so") not in maps
