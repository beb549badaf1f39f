"""The port's dataset and k-mer commands (``python -m grm_tpu_torch dataset
create|split|info`` and ``kmer count|matrix``, ``--device cpu``) against
``grm``'s: the same files (HDF5 datasets and attrs apart from ``uuid`` and
``created``; TSVs byte for byte), the same standard output and the same
error exits. Each CLI runs in a directory of its own with the same
relative paths, since paths land in attrs and reports. Then ``learn scm
--device cpu`` on the port-made dataset writes ``grm``'s reports on
``grm``'s dataset."""

import gzip
import json
import os
import shutil
import subprocess
import sys

import h5py
import numpy as np
import pytest

from grm_tpu import cli as jcli
from grm_tpu_torch import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOLATILE = ("uuid", "created")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Genomes (FASTA, two gzipped) in ``genomes/`` and listed in
    ``contigs.tsv``; read directories listed in ``reads.tsv``; labels in
    ``meta.tsv``; a Ray Surveyor ``survey.conf``. Paths are relative to the
    directory that holds them."""
    tmp = tmp_path_factory.mktemp("cli_inputs")
    rng = np.random.RandomState(31)
    backbone = rng.choice(list("ACGT"), 600)
    marker = "CCGGTTAAGGCCTTAGCAGATTACAGATTAC"
    (tmp / "genomes").mkdir()
    (tmp / "reads").mkdir()
    contigs, reads, meta = [], [], []
    for i in range(12):
        gid = "s%02d" % ((7 * i) % 12)
        s = backbone.copy()
        s[rng.randint(0, 600, 8)] = rng.choice(list("ACGT"), 8)
        seq = "".join(s)
        if i % 2:
            seq = seq[:300] + marker + seq[300:]
        text = ">%s_1\n%s\n>%s_2\n%s\n" % (gid, seq[:250], gid, seq[250:])
        name = "genomes/%s.fna" % gid + (".gz" if i in (3, 8) else "")
        if name.endswith(".gz"):
            with gzip.open(str(tmp / name), "wt") as f:
                f.write(text)
        else:
            (tmp / name).write_text(text)
        contigs.append("%s\t%s" % (gid, name))
        rdir = tmp / "reads" / gid
        rdir.mkdir()
        lines = []
        for r in range(80):
            lo = rng.randint(0, len(seq) - 40)
            lines.append("@%d\n%s\n+\n%s\n" % (r, seq[lo:lo + 40], "I" * 40))
        (rdir / "r.fastq").write_text("".join(lines))
        reads.append("%s\treads/%s" % (gid, gid))
        meta.append("%s\t%s" % (gid, "resistant" if i % 2 else "susceptible"))
    (tmp / "contigs.tsv").write_text("\n".join(contigs) + "\n")
    (tmp / "reads.tsv").write_text("\n".join(reads) + "\n")
    (tmp / "meta.tsv").write_text("\n".join(meta) + "\n")
    (tmp / "survey.conf").write_text(
        "-k 17\n-run-surveyor\n-output survey_out\n-write-kmer-matrix\n"
        + "".join("-read-sample-assembly %s %s\n" % tuple(c.split("\t"))
                  for c in contigs[:6]))
    return tmp


@pytest.fixture
def dirs(inputs, tmp_path):
    """Two copies of the inputs: ``want`` for grm, ``got`` for the port."""
    for side in ("want", "got"):
        shutil.copytree(inputs, tmp_path / side)
    return tmp_path / "want", tmp_path / "got"


def _main(module, args, cwd, monkeypatch, capsys):
    """(exit code, stdout) of ``module.main(args)`` run in ``cwd``."""
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    code = 0
    try:
        module.main(args)
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def _both(args, dirs, monkeypatch, capsys, port_extra=("--device", "cpu")):
    monkeypatch.setenv("GRM_PLATFORM", "cpu")
    monkeypatch.setenv("GRM_COMPILE_CACHE", "0")
    want = _main(jcli, args, dirs[0], monkeypatch, capsys)
    got = _main(tcli, list(args) + list(port_extra), dirs[1], monkeypatch,
                capsys)
    return got, want


def _port_process(args, cwd):
    """``python -m grm_tpu_torch`` in a process of its own."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "-m", "grm_tpu_torch"] + args,
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=300)
    return r.returncode, r.stdout, r.stderr


def _tree(path):
    out = {"/": {k: v for k, v in h5py.File(path, "r").attrs.items()
                 if k not in VOLATILE}}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            entry = {"attrs": {k: np.asarray(v).tolist()
                               for k, v in obj.attrs.items()}}
            if isinstance(obj, h5py.Dataset):
                entry.update(dtype=str(obj.dtype), shape=obj.shape,
                             chunks=obj.chunks, compression=obj.compression,
                             opts=obj.compression_opts,
                             values=obj[...].tobytes())
            out[name] = entry

        f.visititems(visit)
    out["/"] = {k: np.asarray(v).tolist() for k, v in out["/"].items()}
    return out


def _same_file(dirs, name):
    want, got = (d / name for d in dirs)
    if name.endswith(".h5"):
        assert _tree(got) == _tree(want)
    else:
        assert got.read_bytes() == want.read_bytes()


CREATE = ["dataset", "create"]
PHENOTYPE = ["--phenotype-description", "amr", "--phenotype-metadata",
             "meta.tsv"]


def test_create_from_contigs_list_in_a_process(dirs, monkeypatch, capsys):
    args = CREATE + ["from-contigs", "--genomic-data", "contigs.tsv",
                     "--output", "ds.h5", "--kmer-size", "15"] + PHENOTYPE
    _, want = _main(jcli, args, dirs[0], monkeypatch, capsys)
    code, out, err = _port_process(args + ["--device", "cpu"], dirs[1])
    assert code == 0, out + err
    assert out == want
    _same_file(dirs, "ds.h5")


@pytest.mark.parametrize("source,extra", [
    ("from-contigs", ["--genomic-data", "genomes", "--kmer-size", "21"]),
    ("from-contigs", ["--genomic-data", "genomes", "--singleton-kmers",
                      "--compression", "0", "--kmer-size", "33"]),
    ("from-reads", ["--genomic-data", "reads.tsv", "--kmer-size", "31",
                    "--kmer-min-abundance", "2"]),
    ("from-reads", ["--genomic-data", "reads", "--kmer-size", "25"]),
])
def test_create(dirs, monkeypatch, capsys, source, extra):
    args = CREATE + [source, "--output", "ds.h5"] + extra + PHENOTYPE
    got, want = _both(args, dirs, monkeypatch, capsys)
    assert got == want and want[0] == 0
    _same_file(dirs, "ds.h5")
    if extra[1] in ("genomes", "reads"):  # the directory form's list
        _same_file(dirs, "ds.h5.paths.tsv")


def test_create_from_tsv(dirs, monkeypatch, capsys):
    got, want = _both(["kmer", "matrix", "--genome-list", "contigs.tsv",
                       "--kmer-size", "11", "--out", "m.tsv"], dirs,
                      monkeypatch, capsys)
    assert got == want
    args = CREATE + ["from-tsv", "--genomic-data", "m.tsv", "--output",
                     "ds.h5"] + PHENOTYPE
    got, want = _both(args, dirs, monkeypatch, capsys)
    assert got == want and want[0] == 0
    _same_file(dirs, "ds.h5")


def test_split_info_and_learn(dirs, monkeypatch, capsys):
    args = CREATE + ["from-contigs", "--genomic-data", "contigs.tsv",
                     "--output", "ds.h5", "--kmer-size", "17"] + PHENOTYPE
    assert _both(args, dirs, monkeypatch, capsys)[1][0] == 0
    got, want = _both(["dataset", "split", "--dataset", "ds.h5", "--id",
                       "sp", "--train-size", "0.75", "--folds", "3",
                       "--random-seed", "5", "-x"], dirs, monkeypatch, capsys)
    assert got == want
    for d in dirs:
        with h5py.File(d / "ds.h5") as f:
            ids = [x.decode() for x in f["genome_identifiers"][...]]
        (d / "train.txt").write_text("\n".join(ids[::2]) + "\n")
        (d / "test.txt").write_text("\n".join(ids[1::2]) + "\n")
    got, want = _both(["dataset", "split", "--dataset", "ds.h5", "--id",
                       "by_ids", "--train-ids", "train.txt", "--test-ids",
                       "test.txt", "--folds", "2", "--random-seed", "9"],
                      dirs, monkeypatch, capsys)
    assert got == want
    _same_file(dirs, "ds.h5")

    got, want = _both(["dataset", "info", "--dataset", "ds.h5", "--all"],
                      dirs, monkeypatch, capsys)
    strip = lambda out: [l for l in out.splitlines()
                         if not l.startswith("UUID:")]
    assert strip(got[1]) == strip(want[1])
    assert "Folds: 3   Random Seed: 5" in got[1]
    assert "Compression: gzip (level 4)" in got[1]
    for flag in ("--genome-source", "--splits", "--compression"):
        got, want = _both(["dataset", "info", "--dataset", "ds.h5", flag],
                          dirs, monkeypatch, capsys)
        assert got == want

    # learn scm in one directory (reports hold the dataset's absolute
    # path): grm's on grm's dataset, then the port's on the port's.
    learn = dirs[0].parent / "learn"
    learn.mkdir()
    args = ["learn", "scm", "--dataset", "ds.h5", "--split", "sp", "--p",
            "0.5", "1.0", "--max-rules", "3", "--random-seed", "7",
            "--output-dir", "out"]
    monkeypatch.setenv("GRM_PLATFORM", "cpu")
    monkeypatch.setenv("GRM_COMPILE_CACHE", "0")
    results = []
    for module, d, extra in ((jcli, dirs[0], []),
                             (tcli, dirs[1], ["--device", "cpu"])):
        shutil.copy(d / "ds.h5", learn / "ds.h5")
        code, _ = _main(module, args + extra, learn, monkeypatch, capsys)
        assert code == 0
        results.append(learn / ("out_" + d.name))
        os.rename(learn / "out", results[-1])
    want_dir, got_dir = results
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    assert "model.fasta" in names
    for name in names:
        w = (want_dir / name).read_text()
        g = (got_dir / name).read_text()
        if name.endswith(".json"):
            w, g = json.loads(w), json.loads(g)
            for key in ("running_time", "engine", "device", "n_devices"):
                w.pop(key, None)
                g.pop(key, None)
            if "data" in w:  # each dataset has its own uuid
                assert g["data"].pop("uuid") != w["data"].pop("uuid")
        elif name == "report.txt":
            keep = lambda t: [l for l in t.splitlines()
                              if not l.startswith(("Running time:",
                                                   "Dataset UUID:"))
                              and l.split(":")[0] not in ("engine", "device",
                                                          "n_devices")]
            w, g = keep(w), keep(g)
        assert g == w, name


def test_kmer_count(dirs, monkeypatch, capsys):
    for genome, k in (("genomes/s05.fna", 31), ("genomes/s09.fna.gz", 9)):
        got, want = _both(["kmer", "count", "--genome", genome,
                           "--kmer-size", str(k), "--out", "c.tsv"], dirs,
                          monkeypatch, capsys)
        assert got == want and "distinct canonical" in got[1]
        _same_file(dirs, "c.tsv")


@pytest.mark.parametrize("source", [
    ["--genome-dir", "genomes", "--kmer-size", "13"],
    ["--genome-list", "contigs.tsv", "--filter-singleton", "--n-cpu", "2"],
    ["--reads-list", "reads.tsv", "--kmer-size", "15",
     "--kmer-min-abundance", "2"],
    ["--survey-conf", "survey.conf"],
])
def test_kmer_matrix(dirs, monkeypatch, capsys, source):
    out = [] if source[0] == "--survey-conf" else ["--out", "m.tsv"]
    got, want = _both(["kmer", "matrix"] + source + out, dirs, monkeypatch,
                      capsys)
    assert got == want and want[0] == 0
    _same_file(dirs, "m.tsv" if out else "survey_out.kmer_matrix.tsv")


@pytest.mark.parametrize("args", [
    ["dataset", "split", "--dataset", "ds.h5", "--id", "bad", "--folds", "1"],
    ["dataset", "split", "--dataset", "ds.h5", "--id", "bad", "--train-ids",
     "contigs.tsv"],
    ["learn", "scm", "--dataset", "ds.h5", "--split", "nope"],
    CREATE + ["from-contigs", "--genomic-data", "contigs.tsv", "--output",
              "x.h5", "--phenotype-description", "amr"],
    CREATE + ["from-contigs", "--genomic-data", "reads", "--output", "x.h5"],
    ["kmer", "matrix", "--genome-dir", "genomes", "--genome-list",
     "contigs.tsv", "--out", "m.tsv"],
    ["kmer", "matrix", "--genome-dir", "genomes"],
])
def test_cli_errors(dirs, monkeypatch, capsys, args):
    """The error exits of tests/test_cli.py::test_cli_errors and the
    dataset and k-mer commands' own: same message, same exit code."""
    if "ds.h5" in args:
        create = CREATE + ["from-contigs", "--genomic-data", "contigs.tsv",
                           "--output", "ds.h5", "--kmer-size", "15"] + \
            PHENOTYPE
        assert _both(create, dirs, monkeypatch, capsys)[1][0] == 0
    got, want = _both(args, dirs, monkeypatch, capsys)
    assert got == want
    assert want[0] == 1 and want[1].startswith("Error:")
