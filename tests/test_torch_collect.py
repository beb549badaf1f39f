"""The port's data collection (``grm_tpu_torch.collect``) against
``grm_tpu.collect`` on the same inputs: the AMR table (``AmrDatabase``,
pandas-free in the port) row for row and in the same order after ``load``,
``dataset_list`` with and without the 50/50 filter, ``species``,
``antibiotics`` and ``select`` with each filter, and the four exported TSVs
byte for byte; the cases of ``tests/test_collect.py``; the cells pandas'
``read_csv`` treats specially (``NA``, ``nan``, ``N/A``, empty and missing
cells, quotes, blank lines, another column order, CRLF line ends);
synthetic PATRIC tables made from seeds; and the FTP client against an
in-process fake server (``tests/test_collect_ftp.py``'s ``FakeFTP``): MDTM,
the metadata download with its ``.part`` clean-up, the per-genome pool
with its errors and cancel. Every comparison is exact."""

import os
import sys
import threading
from ftplib import error_temp

import pandas as pd
import pytest

import grm_tpu.collect.patric as jpatric
from grm_tpu.collect.amr import AmrDatabase as JaxAmr
from grm_tpu_torch.collect import patric as tpatric
from grm_tpu_torch.collect.amr import AMR_COLUMNS, AmrDatabase, Table
from grm_tpu_torch.collect.amr import sanitize_filename

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the synthetic PATRIC table)

HEADER = ("genome_id\tgenome_name\tantibiotic\tresistant_phenotype\t"
          "measurement\tmeasurement_unit")
# tests/test_collect.py's rows: a duplicate, name variants, an mm row, a
# contradicting genome, an empty measurement.
ROWS = [
    ("1.1", "Escherichia coli K12", "ampicillin", "Resistant", "8", "mg/L"),
    ("1.1", "Escherichia coli K12", "ampicillin", "Resistant", "8", "mg/L"),
    ("1.2", "escherichia COLI xyz", "ampicillin", "Susceptible", "1", "mg/L"),
    ("1.3", "[Escherichia] coli", "ampicillin", "Intermediate", "4", "mg/L"),
    ("1.4", "Escherichia coli", "ampicillin", "Resistant", "20", "mm"),
    ("1.5", "Staphylococcus aureus", "methicillin", "Resistant", "16", "mg/L"),
    ("1.5", "Staphylococcus aureus", "methicillin", "Susceptible", "1", "mg/L"),
    ("1.6", "Staphylococcus aureus", "methicillin", "Susceptible", "0.5", "mg/L"),
    ("1.7", "Klebsiella pneumoniae", "gentamicin", "Resistant", "", "mg/L"),
]
# The cells pandas' read_csv with converters hands over as raw strings.
EDGE_TEXT = (
    "source\tmeasurement_unit\tgenome_name\tgenome_id\tantibiotic\t"
    "resistant_phenotype\tmeasurement\tlab\r\n"
    "a\tmg/L\tEscherichia coli\t2.1\tampicillin\tResistant\tNA\tx\r\n"
    "a\tmg/L\tEscherichia coli\t2.2\tampicillin\tSusceptible\tnan\tx\r\n"
    "a\tN/A\tEscherichia coli\t2.3\tampicillin\tResistant\t8\tx\r\n"
    "\r\n"
    "a\tmg/L\t\"Escherichia\tcoli\"\t2.4\tampicillin\tResistant\t8\tx\r\n"
    "a\tmg/L\t\"Escherichia coli, K-12\"\t2.5\t\"ampicillin\"\tResistant\t"
    "\"8\"\"\"\tx\r\n"
    "a\tmg/L\tEscherichia coli\t2.6\tampicillin\n"
    "a\tmg/L\tEscherichia coli\t2.7\tampicillin\tNA\t\t\r\n"
    "a\tmm\tEscherichia coli\t2.8\tampicillin\tResistant\t20\tx\r\n"
    "a\tmg/L\t  Escherichia   coli  x \t2.9\tampicillin\tN/A\t<=1\tx\r\n"
    "   \r\n"
    "a\tmg/L\tab\"c d\t3.0\tgentamicin\tResistant\t4\tx\r\n"
)


def _rows(df):
    return [tuple(r) for r in df.values.tolist()]


def _same_table(theirs, ours):
    assert ours.columns == theirs.columns.tolist()
    assert ours.rows == _rows(theirs)


@pytest.fixture
def amr_file(tmp_path):
    p = tmp_path / "PATRIC_genomes_AMR.txt"
    with open(p, "w") as f:
        f.write(HEADER + "\textra_col\n")
        for r in ROWS:
            f.write("\t".join(r) + "\textra\n")
    return p


@pytest.fixture(params=["fixture", "edge", "seed0", "seed1", "seed2"])
def any_file(request, tmp_path):
    if request.param == "fixture":
        p = tmp_path / "amr.txt"
        p.write_text(HEADER + "\textra_col\n" + "".join(
            "\t".join(r) + "\textra\n" for r in ROWS))
        return p
    if request.param == "edge":
        p = tmp_path / "amr.txt"
        p.write_bytes(EDGE_TEXT.encode())
        return p
    return chip_smoke.write_amr_table(tmp_path / "amr.txt", 3000,
                                      int(request.param[-1]))


def test_load_cleaning(amr_file):
    db = AmrDatabase.load(amr_file)
    _same_table(JaxAmr.load(amr_file).frame, db.frame)
    assert len(db.frame) == 6
    assert set(db.frame["genome_name"]) == {
        "escherichia coli", "staphylococcus aureus"}
    assert all(m.endswith("mg/L") for m in db.frame["measurement"])


def test_load_matches_grm_tpu(any_file):
    _same_table(JaxAmr.load(any_file).frame, AmrDatabase.load(any_file).frame)


def test_read_keeps_pandas_raw_cells(tmp_path):
    """What pandas' read_csv (converters on every column) gives: raw
    strings, quotes stripped, a quoted tab kept, blank lines skipped, short
    rows padded with empty cells, the file's column order."""
    from grm_tpu_torch.collect.amr import _read_amr

    p = tmp_path / "edge.txt"
    p.write_bytes(EDGE_TEXT.encode())
    raw = pd.read_csv(p, sep="\t", usecols=AMR_COLUMNS,
                      converters={c: str for c in AMR_COLUMNS})
    ours = _read_amr(p)
    assert ours.columns == raw.columns.tolist() == [
        "measurement_unit", "genome_name", "genome_id", "antibiotic",
        "resistant_phenotype", "measurement"]
    name = ours.columns.index("genome_name")
    assert [r[:name] + r[name + 1:] for r in ours.rows] == [
        r[:name] + r[name + 1:] for r in _rows(raw)]
    cells = {r[2]: r for r in ours.rows}
    assert cells["2.1"][5] == "NA" and cells["2.2"][5] == "nan"
    assert cells["2.3"][0] == "N/A" and cells["2.9"][4] == "N/A"
    assert cells["2.4"][1] == "escherichia coli"  # "Escherichia\tcoli"
    assert cells["2.5"][5] == '8"' and cells["2.5"][3] == "ampicillin"
    assert cells["2.6"][4:] == ("", "")
    assert cells["3.0"][1] == 'ab"c d'
    db = AmrDatabase.load(p)
    _same_table(JaxAmr.load(p).frame, db.frame)
    assert sorted(db.frame["genome_id"]) == [
        "2.1", "2.2", "2.3", "2.4", "2.5", "2.9", "3.0"]


def test_missing_column_raises(tmp_path):
    p = tmp_path / "amr.txt"
    p.write_text("genome_id\tgenome_name\tantibiotic\n1\ta b\tamp\n")
    with pytest.raises(ValueError):
        AmrDatabase.load(p)
    with pytest.raises(ValueError):
        JaxAmr.load(p)


@pytest.mark.parametrize("min_group_count", [None, 1, 50])
def test_dataset_list_matches_grm_tpu(any_file, min_group_count):
    ours = AmrDatabase.load(any_file).dataset_list(min_group_count)
    _same_table(JaxAmr.load(any_file).dataset_list(min_group_count), ours)


def test_species_and_antibiotics_match_grm_tpu(any_file):
    j, t = JaxAmr.load(any_file), AmrDatabase.load(any_file)
    assert t.species() == j.species()
    assert t.antibiotics() == j.antibiotics()


@pytest.mark.parametrize("drop_intermediate", [False, True])
@pytest.mark.parametrize("filter_contradictions", [False, True])
@pytest.mark.parametrize("numeric_phenotypes", [False, True])
def test_select_and_export_match_grm_tpu(any_file, tmp_path,
                                         drop_intermediate,
                                         filter_contradictions,
                                         numeric_phenotypes):
    j, t = JaxAmr.load(any_file), AmrDatabase.load(any_file)
    species = j.species()
    drugs = j.antibiotics()
    for sp, ab in [("All", "All"), (species[0], "All"), ("All", drugs[-1]),
                   (species[-1], drugs[0])]:
        kw = dict(species=sp, antibiotic=ab,
                  drop_intermediate=drop_intermediate,
                  filter_contradictions=filter_contradictions,
                  numeric_phenotypes=numeric_phenotypes)
        theirs, ours = j.select(**kw), t.select(**kw)
        _same_table(theirs, ours)
        a = j.export(theirs, tmp_path / "grm", sp, ab)
        b = t.export(ours, tmp_path / "port", sp, ab)
        assert os.path.relpath(a, tmp_path / "grm") == os.path.relpath(
            b, tmp_path / "port")
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for name in os.listdir(a):
            with open(os.path.join(a, name), "rb") as fa, \
                    open(os.path.join(b, name), "rb") as fb:
                assert fa.read() == fb.read(), name


def test_select_filters(amr_file):
    db = AmrDatabase.load(amr_file)
    data = db.select(species="escherichia coli", antibiotic="ampicillin")
    assert set(data["genome_id"]) == {"1.1", "1.2", "1.3"}
    data = db.select(species="escherichia coli", antibiotic="ampicillin",
                     drop_intermediate=True)
    assert set(data["genome_id"]) == {"1.1", "1.2"}
    data = db.select(species="staphylococcus aureus", antibiotic="methicillin",
                     filter_contradictions=True)
    assert set(data["genome_id"]) == {"1.6"}


def test_numeric_phenotypes(amr_file):
    db = AmrDatabase.load(amr_file)
    data = db.select(species="escherichia coli", antibiotic="ampicillin",
                     numeric_phenotypes=True)
    by_id = dict(zip(data["genome_id"], data["resistant_phenotype"]))
    assert by_id == {"1.1": 1, "1.2": 0, "1.3": 2}


def test_dataset_list_group_filter(tmp_path):
    rows = []
    for i in range(60):
        rows.append(("2.%d" % i, "Big species", "drugA",
                     "Resistant" if i < 55 else "Susceptible", "8", "mg/L"))
    for i in range(120):
        rows.append(("3.%d" % i, "Good species", "drugB",
                     "Resistant" if i < 60 else "Susceptible", "8", "mg/L"))
    p = tmp_path / "amr.txt"
    p.write_text(HEADER + "\n" + "".join("\t".join(r) + "\n" for r in rows))
    db = AmrDatabase.load(p)
    assert len(db.dataset_list()) == 2
    assert db.dataset_list(min_group_count=50).rows == [
        ("good species", "drugB")]
    _same_table(JaxAmr.load(p).dataset_list(50), db.dataset_list(50))


def test_export_files(amr_file, tmp_path):
    db = AmrDatabase.load(amr_file)
    data = db.select(species="escherichia coli", antibiotic="ampicillin",
                     drop_intermediate=True, numeric_phenotypes=True)
    folder = db.export(data, tmp_path / "out", "escherichia coli", "ampicillin")
    base = "escherichia_coli_ampicillin"
    lines = open(os.path.join(folder, base + "_phenotype_metadata.tsv")
                 ).read().splitlines()
    assert {l.split("\t")[0]: l.split("\t")[1] for l in lines} == {
        "1.1": "1", "1.2": "0"}


def test_table():
    t = Table(["a", "b"], [(1, "x"), (2, "y"), (1, "x")])
    assert len(t) == 3 and t["a"] == [1, 2, 1]
    assert t[["b"]].rows == [("x",), ("y",), ("x",)]
    assert t.drop_duplicates().rows == [(1, "x"), (2, "y")]
    assert t.where("b", lambda v: v == "y").rows == [(2, "y")]
    assert list(t) == t.rows


def test_sanitize_filename():
    assert sanitize_filename("escherichia coli/k12") == "escherichia_coli_k12"


# -- the FTP client ------------------------------------------------------------

class FakeFTP:
    """Minimal ftplib.FTP stand-in serving from a class-level dict."""

    files = {}
    fail_paths = set()
    connections = []

    def __init__(self, host, timeout=None):
        self.host = host
        type(self).connections.append(self)

    def login(self):
        pass

    def sendcmd(self, cmd):
        assert cmd.startswith("MDTM ")
        return "213 20260812093000"

    def size(self, path):
        return len(self.files[path])

    def retrbinary(self, cmd, callback, blocksize=8192):
        path = cmd.split(" ", 1)[1]
        if path in self.fail_paths:
            callback(b"PARTIAL")  # some bytes land before the failure
            raise error_temp("426 Connection closed; transfer aborted.")
        if path not in self.files:
            raise error_temp("550 %s: No such file" % path)
        data = self.files[path]
        for i in range(0, len(data), 4):
            callback(data[i:i + 4])

    def quit(self):
        pass


@pytest.fixture
def fake_ftp(monkeypatch):
    FakeFTP.files = {}
    FakeFTP.fail_paths = set()
    FakeFTP.connections = []
    monkeypatch.setattr(jpatric, "FTP", FakeFTP)
    monkeypatch.setattr(tpatric, "FTP", FakeFTP)
    return FakeFTP


@pytest.mark.parametrize("module", [jpatric, tpatric], ids=["grm", "port"])
def test_amr_metadata_download_and_mdtm(tmp_path, fake_ftp, module):
    fake_ftp.files[module.AMR_METADATA_PATH] = b"genome_id\tantibiotic\n1\tamp\n"
    seen = []
    local = module.download_amr_metadata(
        tmp_path, progress_callback=lambda t, p: seen.append((t, p)))
    assert local == os.path.join(tmp_path, "PATRIC_genomes_AMR.txt")
    assert open(local, "rb").read() == fake_ftp.files[module.AMR_METADATA_PATH]
    assert not os.path.exists(local + ".part")
    assert seen[-1] == ("AMR metadata", 1.0) and len(seen) == 7
    assert module.remote_amr_metadata_mdtm() == "20260812093000"


@pytest.mark.parametrize("module", [jpatric, tpatric], ids=["grm", "port"])
def test_amr_metadata_failure_cleans_partial(tmp_path, fake_ftp, module):
    fake_ftp.files[module.AMR_METADATA_PATH] = b"data"
    fake_ftp.fail_paths.add(module.AMR_METADATA_PATH)
    with pytest.raises(error_temp):
        module.download_amr_metadata(tmp_path)
    assert os.listdir(tmp_path) == []


def _genome_files(fake_ftp):
    for gid in ("11.1", "22.2"):
        fake_ftp.files["genomes/%s/%s.fna" % (gid, gid)] = (
            b">c\nACGT" + gid.encode() + b"\n")
        fake_ftp.files["genomes/%s/%s.PATRIC.features.tab" % (gid, gid)] = (
            b"feat\t" + gid.encode())
    fake_ftp.files["genomes/33.3/33.3.fna"] = b">c\nAAAA\n"
    fake_ftp.fail_paths.add("genomes/33.3/33.3.fna")


@pytest.mark.parametrize("features", [False, True])
def test_download_genomes_matches_grm_tpu(tmp_path, fake_ftp, features):
    _genome_files(fake_ftp)
    ids = ["11.1", "22.2", "33.3", "44.4"]
    out = {}
    for name, module in (("grm", jpatric), ("port", tpatric)):
        dest = tmp_path / name
        results, errors = module.download_genomes(ids, dest, features=features)
        out[name] = (
            {g: [os.path.relpath(f, dest) for f in fs]
             for g, fs in results.items()},
            {g: (type(e), str(e)) for g, e in errors.items()},
            {f: open(os.path.join(dest, f), "rb").read()
             for f in sorted(os.listdir(dest))})
    assert out["port"] == out["grm"]
    results, errors, files = out["port"]
    assert set(results) == {"11.1", "22.2"} and set(errors) == {"33.3", "44.4"}
    assert results["11.1"] == (["11.1.fna", "11.1.PATRIC.features.tab"]
                               if features else ["11.1.fna"])
    assert not [f for f in files if ".part" in f or f.startswith(("33", "44"))]


@pytest.mark.parametrize("module", [jpatric, tpatric], ids=["grm", "port"])
def test_download_genomes_cancel_stops_early(tmp_path, fake_ftp, module):
    gids = ["%d.0" % i for i in range(30)]
    for gid in gids:
        fake_ftp.files["genomes/%s/%s.fna" % (gid, gid)] = b">c\nACGT\n"
    cancel = threading.Event()

    def progress(task, p):
        cancel.set()  # cancel after the first completion lands

    results, errors = module.download_genomes(
        gids, tmp_path, progress_callback=progress, cancel_event=cancel)
    assert len(results) + len(errors) < len(gids)
    assert not errors


def test_ftp_client_constants_match_grm_tpu():
    assert (tpatric.PATRIC_FTP_HOST, tpatric.AMR_METADATA_PATH,
            tpatric.MAX_WORKERS) == (jpatric.PATRIC_FTP_HOST,
                                     jpatric.AMR_METADATA_PATH,
                                     jpatric.MAX_WORKERS)
