"""The port's dataset creation (grm_tpu_torch.dataset: from_contigs,
from_reads, from_tsv, parse_metadata, split_with_ids) against grm_tpu's on
the CPU: every dataset, dtype, chunk shape, filter and attr of the HDF5
files equal (apart from ``uuid`` and ``created``), the in-memory artifact
equal to the file, the same warnings and errors; then grm_tpu reads the
port's file, and learn_SCM on it gives grm_tpu's result on its own file."""

import numpy as np
import pytest

import h5py

from grm_tpu.dataset import artifact as ja
from grm_tpu.dataset import create as jcr
from grm_tpu.dataset import split as js
from grm_tpu.learning.experiments.scm_experiment import learn_SCM as jax_learn
from grm_tpu_torch.dataset import artifact as ta
from grm_tpu_torch.dataset import create as tcr
from grm_tpu_torch.dataset import split as ts
from grm_tpu_torch.learning.experiments import learn_SCM

MARKER = "GATTACAGATTACACCGGTTAAGGCCTTAGCA"
VOLATILE = ("uuid", "created")


def _fasta(path, seq):
    path.write_text(">c1\n%s\n>c2\n%s\n" % (seq[:300], seq[300:]))
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """14 genomes of a shared backbone with SNPs, the odd ones carrying a
    marker; their FASTA files, read directories (FASTQ, one gzipped) and
    lists; metadata files: binary tags, raw 0/1, three classes, and one
    that misses two genomes and names one that does not exist."""
    import gzip

    tmp = tmp_path_factory.mktemp("create")
    rng = np.random.RandomState(11)
    backbone = rng.choice(list("ACGT"), 700)
    ids = ["gen%02d" % i for i in (5, 3, 12, 0, 9, 1, 13, 7, 2, 11, 4, 8, 10,
                                   6)]
    contigs, reads = [], []
    for i, gid in enumerate(ids):
        s = backbone.copy()
        s[rng.randint(0, 700, 10)] = rng.choice(list("ACGT"), 10)
        seq = "".join(s)
        if i % 2:
            seq = seq[:400] + MARKER + seq[400:]
        contigs.append((gid, _fasta(tmp / (gid + ".fna"), seq)))
        d = tmp / ("reads_" + gid)
        d.mkdir()
        for part, opener in enumerate((open, gzip.open)):
            lines = []
            for r in range(60):
                lo = rng.randint(0, len(seq) - 50)
                read = seq[lo:lo + 50]
                lines.append("@%s_%d\n%s\n+\n%s\n" % (gid, r, read,
                                                     "I" * len(read)))
            name = "r%d.fastq" % part + (".gz" if part else "")
            with opener(str(d / name), "wt") as f:
                f.write("".join(lines))
        reads.append((gid, str(d)))
    (tmp / "contigs.tsv").write_text(
        "".join("%s\t%s\n" % p for p in contigs))
    (tmp / "reads.tsv").write_text("".join("%s\t%s\n" % p for p in reads))
    metas = {
        "binary": ["%s\t%s" % (g, "R" if i % 2 else "S")
                   for i, g in enumerate(ids)],
        "raw01": ["%s\t%d" % (g, i % 2) for i, g in enumerate(ids)],
        "three": ["%s\t%s" % (g, "abc"[i % 3]) for i, g in enumerate(ids)],
        "missing": ["%s\t%s" % (g, "R" if i % 2 else "S")
                    for i, g in enumerate(ids) if i not in (2, 7)]
        + ["ghost\tR"],
    }
    for name, lines in metas.items():
        (tmp / ("meta_%s.tsv" % name)).write_text("\n".join(lines) + "\n")
    return tmp


def _tree(path):
    """Every group and dataset of an HDF5 file: attrs, and for a dataset
    its dtype, shape, chunks, filter and values; root uuid/created left
    out."""
    out = {}
    with h5py.File(path, "r") as f:
        out["/"] = {k: v for k, v in f.attrs.items() if k not in VOLATILE}

        def visit(name, obj):
            entry = {"attrs": dict(obj.attrs)}
            if isinstance(obj, h5py.Dataset):
                entry.update(dtype=str(obj.dtype), shape=obj.shape,
                             chunks=obj.chunks, compression=obj.compression,
                             opts=obj.compression_opts, values=obj[...])
            out[name] = entry

        f.visititems(visit)
    return out


def _memory_tree(mem):
    out = {"/": {k: v for k, v in mem.attrs.items() if k not in VOLATILE}}

    def visit(prefix, grp):
        for name, obj in grp.items():
            path = prefix + name
            entry = {"attrs": dict(obj.attrs)}
            if isinstance(obj, ta.MemoryDataset):
                entry.update(dtype=str(obj.data.dtype), shape=obj.shape,
                             values=obj.data)
                out[path] = entry
            else:
                out[path] = entry
                visit(path + "/", obj)

    visit("", mem)
    return out


def _assert_trees_equal(got, want, keys=None):
    assert sorted(got) == sorted(want)
    for name in want:
        w, g = want[name], got[name]
        if name == "/":
            assert g.keys() == w.keys()
            for key in w:
                assert g[key] == w[key], key
            continue
        for key in keys or w:
            if key == "values":
                np.testing.assert_array_equal(g[key], w[key], err_msg=name)
                assert g[key].dtype == w[key].dtype, name
            elif key == "attrs":
                assert g[key].keys() == w[key].keys(), name
                for a in w[key]:
                    assert np.array_equal(g[key][a], w[key][a]), (name, a)
            else:
                assert g[key] == w[key], (name, key)


def _create(module, source, data, out, meta=None, memory=False, **kw):
    path = out if not memory else ta.MemoryArtifact()
    warnings = []
    phen = {} if meta is None else dict(
        phenotype_description="resistance",
        phenotype_metadata_path=str(data / ("meta_%s.tsv" % meta)))
    if module is tcr:
        kw["device"] = "cpu"
    if source == "contigs":
        res = module.from_contigs(str(data / "contigs.tsv"), path,
                                  warning_callback=warnings.append, **phen,
                                  **kw)
    else:
        res = module.from_reads(str(data / "reads.tsv"), path,
                                warning_callback=warnings.append, **phen,
                                **kw)
    return (res if memory else path), warnings


CASES = [
    ("contigs", "binary", 31, False, 4),
    ("contigs", "raw01", 15, True, 0),
    ("contigs", "three", 33, True, 4),
    ("contigs", None, 9, False, 4),
    ("contigs", "missing", 31, True, 4),
    ("reads", "binary", 31, True, 4),
    ("reads", "missing", 33, False, 0),
]


@pytest.mark.parametrize("source,meta,k,filter_singleton,gzip", CASES)
def test_create_equals_grm_tpu(data, tmp_path, source, meta, k,
                               filter_singleton, gzip):
    kw = dict(kmer_size=k, filter_singleton=filter_singleton, gzip=gzip)
    if source == "reads":
        kw["abundance_min"] = 2
    want, w_warn = _create(jcr, source, data, tmp_path / "want.h5", meta,
                           **kw)
    got, g_warn = _create(tcr, source, data, tmp_path / "got.h5", meta, **kw)
    assert g_warn == w_warn
    if meta == "missing":
        assert len(w_warn) == 2
    want_tree = _tree(want)
    _assert_trees_equal(_tree(got), want_tree)
    # The in-memory target holds the same arrays and attrs.
    mem, m_warn = _create(tcr, source, data, None, meta, memory=True, **kw)
    assert isinstance(mem, ta.MemoryArtifact) and m_warn == w_warn
    _assert_trees_equal(_memory_tree(mem), want_tree,
                        keys=("attrs", "dtype", "shape", "values"))


def test_create_writes_chunks_in_parallel(tmp_path):
    """Past 100,000 k-mers and 1 MB of k-mer text the writers deflate
    several chunks of each dataset on a thread pool."""
    rng = np.random.RandomState(2)
    lines = []
    for g in range(8):
        seq = "".join(rng.choice(list("ACGT"), 20000))
        path = tmp_path / ("big%d.fna" % g)
        path.write_text(">x\n%s\n" % seq)
        lines.append("big%d\t%s\n" % (g, path))
    (tmp_path / "list.tsv").write_text("".join(lines))
    kw = dict(kmer_size=31, gzip=6)
    jcr.from_contigs(str(tmp_path / "list.tsv"), tmp_path / "want.h5", **kw)
    tcr.from_contigs(str(tmp_path / "list.tsv"), tmp_path / "got.h5",
                     device="cpu", **kw)
    want = _tree(tmp_path / "want.h5")
    assert want["kmer_matrix"]["shape"][1] > tcr.BLOCK_SIZE
    assert want["kmer_sequences"]["chunks"][0] < \
        want["kmer_sequences"]["shape"][0]
    _assert_trees_equal(_tree(tmp_path / "got.h5"), want)


def test_from_tsv_equals_grm_tpu(data, tmp_path):
    from grm_tpu.kmer.counter import count_fasta
    from grm_tpu.kmer.matrix import build_presence_matrix, matrix_to_tsv

    with open(data / "contigs.tsv") as f:
        pairs = [l.split() for l in f]
    km = build_presence_matrix([count_fasta(p, 13, genome_id=g)
                                for g, p in pairs])
    matrix_to_tsv(km, tmp_path / "m.tsv")
    for meta, gzip in (("three", 4), (None, 0)):
        phen = {} if meta is None else dict(
            phenotype_description="resistance",
            phenotype_metadata_path=str(data / ("meta_%s.tsv" % meta)))
        jcr.from_tsv(str(tmp_path / "m.tsv"), tmp_path / "want.h5",
                     gzip=gzip, **phen)
        tcr.from_tsv(str(tmp_path / "m.tsv"), tmp_path / "got.h5",
                     gzip=gzip, device="cpu", **phen)
        want = _tree(tmp_path / "want.h5")
        _assert_trees_equal(_tree(tmp_path / "got.h5"), want)
        mem = tcr.from_tsv(str(tmp_path / "m.tsv"), ta.MemoryArtifact(),
                           gzip=gzip, device="cpu", **phen)
        _assert_trees_equal(_memory_tree(mem), want,
                            keys=("attrs", "dtype", "shape", "values"))
    with pytest.raises(ValueError, match="description and a metadata"):
        tcr.from_tsv(str(tmp_path / "m.tsv"), ta.MemoryArtifact(),
                     phenotype_description="x", device="cpu")


def test_singleton_filter_removing_everything(tmp_path):
    for g, seq in enumerate(("ACGTTGCAAGGCTTAGC", "TTTTTTTTTTTTTTTTTG")):
        (tmp_path / ("s%d.fna" % g)).write_text(">x\n%s\n" % seq)
    (tmp_path / "list.tsv").write_text("".join(
        "s%d\t%s\n" % (g, tmp_path / ("s%d.fna" % g)) for g in range(2)))
    with pytest.raises(ValueError) as want:
        jcr.from_contigs(str(tmp_path / "list.tsv"), tmp_path / "w.h5", 9,
                         filter_singleton=True)
    with pytest.raises(ValueError) as got:
        tcr.from_contigs(str(tmp_path / "list.tsv"), ta.MemoryArtifact(), 9,
                         filter_singleton=True, device="cpu")
    assert str(got.value) == str(want.value)
    assert "singleton filter removed every k-mer" in str(got.value)


def test_missing_genome_file(tmp_path):
    (tmp_path / "list.tsv").write_text("a\t%s\n" % (tmp_path / "none.fna"))
    errors = []
    with pytest.raises(Exception):
        jcr.from_contigs(str(tmp_path / "list.tsv"), tmp_path / "w.h5", 9,
                         error_callback=errors.append)
    got = []
    with pytest.raises(Exception):
        tcr.from_contigs(str(tmp_path / "list.tsv"), ta.MemoryArtifact(), 9,
                         error_callback=got.append, device="cpu")
    assert [str(e) for e in got] == [str(e) for e in errors]
    assert "cannot be found" in str(got[0])


@pytest.mark.parametrize("lines", [
    ["a\tR", "b\tR"],                                   # one phenotype
    ["g%d\tc%d" % (i, i) for i in range(256)],          # 256 phenotypes
    ["a\tR", "a\tS", "b\tS"],                           # a genome twice
    ["x\tR", "y\tS"],                                   # no genome in common
])
def test_parse_metadata_errors(tmp_path, lines):
    path = tmp_path / "meta.tsv"
    path.write_text("\n".join(lines) + "\n")
    ids = ["a", "b", "g0", "g1"]
    with pytest.raises(Exception) as want:
        jcr.parse_metadata(str(path), ids)
    with pytest.raises(Exception) as got:
        tcr.parse_metadata(str(path), ids)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_parse_metadata_matches(data):
    ids = [l.split()[0] for l in open(data / "contigs.tsv")]
    for name in ("binary", "raw01", "three", "missing"):
        want_warn, got_warn = [], []
        want = jcr.parse_metadata(str(data / ("meta_%s.tsv" % name)), ids,
                                  warning_callback=want_warn.append)
        got = tcr.parse_metadata(str(data / ("meta_%s.tsv" % name)), ids,
                                 warning_callback=got_warn.append)
        assert got_warn == want_warn
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        assert got[3] == want[3]


@pytest.fixture(scope="module")
def pair(data, tmp_path_factory):
    """The same contigs dataset created by grm_tpu and by the port."""
    tmp = tmp_path_factory.mktemp("pair")
    kw = dict(kmer_size=21, filter_singleton=True, gzip=4,
              phenotype_description="resistance",
              phenotype_metadata_path=str(data / "meta_binary.tsv"))
    jcr.from_contigs(str(data / "contigs.tsv"), tmp / "want.h5", **kw)
    tcr.from_contigs(str(data / "contigs.tsv"), tmp / "got.h5", device="cpu",
                     **kw)
    return tmp


def test_split_with_ids_equals_grm_tpu(pair, tmp_path):
    import shutil

    for name in ("want.h5", "got.h5"):
        shutil.copy(pair / name, tmp_path / name)
    with h5py.File(tmp_path / "want.h5") as f:
        ids = [x.decode() for x in f["genome_identifiers"][...]]
    (tmp_path / "train.txt").write_text("\n".join(ids[:9]) + "\n\n")
    (tmp_path / "test.txt").write_text("\n".join(ids[9:]) + "\n")
    args = ("ids", str(tmp_path / "train.txt"), str(tmp_path / "test.txt"),
            7, 3)
    js.split_with_ids(tmp_path / "want.h5", *args)
    ts.split_with_ids(tmp_path / "got.h5", *args, device="cpu")
    _assert_trees_equal(_tree(tmp_path / "got.h5"),
                        _tree(tmp_path / "want.h5"))
    got = ta.GrmDataset(tmp_path / "got.h5", device="cpu")
    want = ja.GrmDataset(tmp_path / "want.h5")
    assert got.compression == want.compression == "gzip (level 4)"
    assert got.genome_source == want.genome_source
    assert [str(s) for s in got.splits] == [str(s) for s in want.splits]
    assert "Folds: 3" in str(got.splits[0])
    (tmp_path / "bad.txt").write_text("nobody\n")
    with pytest.raises(Exception) as w_err:
        js.split_with_ids(tmp_path / "want.h5", "bad",
                          str(tmp_path / "bad.txt"), str(tmp_path / "test.txt"),
                          1)
    with pytest.raises(Exception) as g_err:
        ts.split_with_ids(tmp_path / "got.h5", "bad",
                          str(tmp_path / "bad.txt"), str(tmp_path / "test.txt"),
                          1, device="cpu")
    assert str(g_err.value) == str(w_err.value)


def _s(x):
    return x.decode() if isinstance(x, bytes) else str(x)


def _fingerprint(out):
    best_hp, score, train_m, test_m, model, imps, equiv, cls = out
    return {
        "hp": {k: _s(v) for k, v in best_hp.items()},
        "score": None if score is None else float(score),
        "rules": [(_s(r.kmer_sequence), _s(r.type)) for r in model.rules],
        "importances": [float(v) for v in np.asarray(imps).ravel()],
        "equiv": [sorted((_s(e.kmer_sequence), _s(e.type)) for e in eq)
                  for eq in equiv],
        "train": {k: np.asarray(v).tolist() for k, v in train_m.items()},
        "test": {k: np.asarray(v).tolist() for k, v in test_m.items()},
        "cls": {k: sorted(_s(g) for g in v) for k, v in cls.items()},
    }


def test_grm_tpu_reads_the_ports_file_and_learns_the_same(pair, tmp_path):
    import shutil

    for name in ("want.h5", "got.h5"):
        shutil.copy(pair / name, tmp_path / name)
    js.split_with_proportion(tmp_path / "want.h5", "sp", 0.7, 5, 3)
    ts.split_with_proportion(tmp_path / "got.h5", "sp", 0.7, 5, 3,
                             device="cpu")
    read = ja.GrmDataset(tmp_path / "got.h5")
    ref = ja.GrmDataset(tmp_path / "want.h5")
    np.testing.assert_array_equal(read.kmer_matrix_u64(),
                                  ref.kmer_matrix_u64())
    np.testing.assert_array_equal(read.genome_identifiers,
                                  ref.genome_identifiers)
    assert read.kmer_count == ref.kmer_count > 0
    kw = dict(split_name="sp", model_type=["conjunction", "disjunction"],
              p=[0.5, 1.0], max_rules=3, parameter_selection="cv",
              random_seed=3, bound_delta=0.05, engine="host")
    want = _fingerprint(jax_learn(dataset_file=tmp_path / "want.h5", **kw))
    got = _fingerprint(learn_SCM(dataset_file=tmp_path / "got.h5",
                                 device="cpu", **kw))
    assert got == want
    assert got["rules"] and got["train"]["risk"] == [0.0]
