"""The port's results site (``grm_tpu_torch.results_site``) and profiling
hooks (``grm_tpu_torch.profiling``) against ``grm_tpu``'s: every file
``write_site`` emits (summary.json, index.html, each dataset's
overview/model/repeats JSON, details.html and model FASTA) byte for byte on
the same ``results.json`` directories, with one or several repeats and
datasets, with and without a readable artifact (``_dataset_dims`` reads it
with ``h5py``, imported lazily, and gives None without it); ``serve_site``
on port 0; ``StageTimer``, ``throughput`` and ``torch_trace``, whose trace
file is a Chrome trace JSON. Exact comparisons throughout."""

import json
import os
import sys
import threading
import urllib.request

import h5py
import numpy as np
import pytest

from grm_tpu import profiling as jprof
from grm_tpu import results_site as jsite
from grm_tpu_torch import profiling as tprof
from grm_tpu_torch import results_site as tsite


def _results_dir(tmp_path, name, risk, n_rules, running_time,
                 sensitivity=0.9, artifact=None, fasta=True, seed=0):
    rng = np.random.default_rng(seed)
    d = tmp_path / name
    os.makedirs(d)
    results = {
        "data": {"uuid": "u", "path": artifact or "p", "split": "s"},
        "metrics": {
            "train": {"risk": [0.0]},
            "test": {
                "risk": [risk], "sensitivity": [sensitivity],
                "specificity": [float(rng.random())],
                "precision": [0.9], "recall": [None],
                "f1_score": [float(rng.random())],
                "tp": [int(rng.integers(20))], "tn": [8], "fp": [2], "fn": [1],
            },
        },
        "model": {"n_rules": n_rules,
                  "rules": ["Presence(AAA)", "Absence(C<T>&\"G)"][:n_rules],
                  "rule_importances": [1.0, 0.25][:n_rules],
                  "equivalent_rule_counts": [7, 1][:n_rules],
                  "type": "conjunction"},
        "classifications": {
            "train_correct": ["g%d" % i for i in range(10)],
            "train_errors": [],
            "test_correct": ["t%d" % i for i in range(17)],
            "test_errors": ["e%d" % i for i in range(3)],
        },
        "running_time": running_time,
    }
    with open(d / "results.json", "w") as f:
        json.dump(results, f)
    if fasta:
        with open(d / "model.fasta", "w") as f:
            f.write(">rule-1 presence, importance: 1.00\nAAA\n")
    return str(d)


def _artifact(tmp_path, n_genomes, n_kmers):
    path = str(tmp_path / ("ds_%d.h5" % n_genomes))
    with h5py.File(path, "w") as f:
        f.create_dataset("genome_identifiers", data=np.arange(n_genomes))
        f.create_dataset("kmer_sequences", data=np.arange(n_kmers))
    return path


def _runs(tmp_path, case):
    if case == "one":
        return [{"species": "klebsiella pneumoniae", "antibiotic": "gentamicin",
                 "results_dir": _results_dir(tmp_path, "r", 0.22, 2, 312)}]
    if case == "repeats":
        return [
            {"species": "escherichia coli", "antibiotic": "ampicillin",
             "results_dir": _results_dir(tmp_path, "r1", 0.10, 2, 100)},
            {"species": "escherichia coli", "antibiotic": "ampicillin",
             "results_dir": _results_dir(tmp_path, "r2", 0.20, 1, 200.5,
                                         fasta=False, seed=1)},
        ]
    runs = []
    for i, (sp, ab) in enumerate([
            ("escherichia coli", "ampicillin"),
            ("klebsiella pneumoniae", "gentamicin"),
            ("enterococcus faecium", "vancomycin"),
            ("escherichia coli", "ampicillin"),
            ("Mycobacterium Tuberculosis", "isoniazid <INH>")]):
        artifact = (_artifact(tmp_path, 100 + 37 * i, 1000 * i + 7)
                    if case == "artifacts" and i != 2 else None)
        runs.append({"species": sp, "antibiotic": ab,
                     "results_dir": _results_dir(
                         tmp_path, "d%d" % i, 0.01 + 0.1 * i, 1 + i % 2,
                         100 + 50 * i, sensitivity=1.0 - 0.1 * i,
                         artifact=artifact, seed=i)})
    return runs


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("case", ["one", "repeats", "datasets", "artifacts"])
def test_write_site_matches_grm_tpu(tmp_path, case):
    runs = _runs(tmp_path, case)
    a = jsite.write_site(runs, str(tmp_path / "grm"))
    b = tsite.write_site(runs, str(tmp_path / "port"))
    assert a == b
    theirs, ours = _tree(tmp_path / "grm"), _tree(tmp_path / "port")
    assert sorted(ours) == sorted(theirs)
    for name in theirs:
        assert ours[name] == theirs[name], name
    assert "index.html" in ours and "summary.json" in ours
    if case == "artifacts":
        assert any("ds_n_kmers" in r for r in b)


def test_aggregate_runs_mean_over_repeats(tmp_path):
    runs = _runs(tmp_path, "repeats")
    summary = tsite.aggregate_runs(runs, tmp_path / "site")
    assert summary == jsite.aggregate_runs(runs, tmp_path / "grm")
    row = summary[0]
    assert row["ds_full_name"] == "ampicillin___escherichia_coli"
    assert row["risk"] == 0.15 and row["n_rules"] == 1.5
    assert row["ds_n_examples"] == 30
    ds_dir = tmp_path / "site" / "datasets" / "ampicillin___escherichia_coli"
    assert len(json.load(open(ds_dir / "repeats.json"))) == 2
    assert json.load(open(tmp_path / "site" / "summary.json")) == summary


def test_dataset_dims_without_h5py(tmp_path, monkeypatch):
    path = _artifact(tmp_path, 50, 60)
    results = {"data": {"path": path}}
    assert tsite._dataset_dims(results) == (50, 60)
    assert tsite._dataset_dims({"data": {"path": str(tmp_path / "no")}}) == (
        None, None)
    assert tsite._dataset_dims({}) == (None, None)
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now fails
    assert tsite._dataset_dims(results) == (None, None)


def test_serve_site_http(tmp_path):
    runs = _runs(tmp_path, "datasets")
    out = tmp_path / "site"
    tsite.write_site(runs, str(out))
    server = tsite.serve_site(str(out), port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        got = lambda rel: urllib.request.urlopen(base + rel, timeout=10).read()
        assert got("/index.html") == (out / "index.html").read_bytes()
        name = "ampicillin___escherichia_coli"
        assert got("/datasets/%s/details.html" % name) == (
            out / "datasets" / name / "details.html").read_bytes()
        assert json.loads(got("/summary.json")) == json.load(
            open(out / "summary.json"))
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)


def test_serve_site_missing_dir(tmp_path):
    with pytest.raises(ValueError):
        tsite.serve_site(str(tmp_path / "nope"))


def test_stage_timer():
    t = tprof.StageTimer()
    for name in ("a", "b", "a"):
        with t.stage(name):
            pass
    assert list(t.stages) == ["a", "b"]
    assert t.total >= 0 and t.as_dict() == dict(t.stages)
    report = t.report().splitlines()
    assert report[0] == "Stage timings:" and report[-1].split()[0] == "TOTAL"
    ref = jprof.StageTimer()
    ref.stages.update(t.stages)
    assert t.report() == ref.report()


@pytest.mark.parametrize("args", [(1e6, 50, 2.0, 2), (3, 1, 0.0, 1)])
def test_throughput(args):
    assert tprof.throughput(*args) == jprof.throughput(*args)
    if args[0] == 1e6:
        out = tprof.throughput(*args)
        assert out["kmers_per_s_per_chip"] == 250000.0
        assert out["genomes_per_s"] == 25.0


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with tprof.torch_trace(tmp_path / "trace") as prof:
        x = torch.arange(1000, dtype=torch.float32)
        (x * x).sum()
    files = os.listdir(tmp_path / "trace")
    assert files == [os.path.basename(prof.trace_path)]
    with open(prof.trace_path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
