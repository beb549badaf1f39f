"""The port's CLI (``python -m grm_tpu_torch learn scm --device cpu`` and
``learn tree --device cpu``, host engine by default there, and their exact
and argmax device engines) against ``grm learn
scm --engine host`` and ``grm learn tree``: every report file is equal, apart from the running time and the
lines that say how each ran (``engine``, ``device`` and ``n_devices`` in the
configuration)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from grm_tpu.dataset import from_tsv
from grm_tpu.dataset.split import split_with_proportion

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_KEYS = ("engine", "device", "n_devices")


def _run(module, args, cwd, expect=0):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["GRM_PLATFORM"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=cwd,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == expect, r.stdout + r.stderr
    return r.stdout


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.RandomState(21)
    dense = (rng.rand(30, 80) > 0.5).astype(np.uint8)
    labels = (rng.rand(30) > 0.5).astype(np.uint8)
    dense[:, 9] = labels
    dense[:, 9][rng.choice(30, 3, replace=False)] ^= 1
    dense[:, 33] = dense[:, 9]  # a tie
    ids = ["g%02d" % i for i in range(30)]
    kmers = ["".join("ACGT"[(i >> (2 * j)) & 3] for j in range(8))
             for i in range(80)]
    lines = ["kmers\t" + "\t".join(ids)] + [
        kmers[r] + "\t" + "\t".join(str(int(v)) for v in dense[:, r])
        for r in range(80)]
    (tmp / "m.tsv").write_text("\n".join(lines) + "\n")
    (tmp / "meta.tsv").write_text("\n".join(
        "%s\t%s" % (g, l) for g, l in zip(ids, labels)) + "\n")
    from_tsv(tmp / "m.tsv", tmp / "ds.h5", phenotype_description="amr",
             phenotype_metadata_path=tmp / "meta.tsv", gzip=4)
    split_with_proportion(tmp / "ds.h5", "sp", train_prop=0.7,
                          random_seed=4, n_folds=3)
    return tmp


def _strip_report(text):
    return [l for l in text.splitlines()
            if not l.startswith("Running time:")
            and l.split(":")[0] not in RUN_KEYS]


def _assert_same_outputs(want_dir, got_dir, expected_names):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    assert expected_names <= set(names)
    for name in names:
        want = (want_dir / name).read_text()
        got = (got_dir / name).read_text()
        if name == "report.txt":
            assert _strip_report(got) == _strip_report(want)
        elif name == "results.json":
            w, g = json.loads(want), json.loads(got)
            w.pop("running_time")
            g.pop("running_time")
            assert g == w
        elif name == "config.json":
            w, g = json.loads(want), json.loads(got)
            for key in RUN_KEYS:
                w.pop(key, None)
                g.pop(key, None)
            assert g == w
        else:
            assert got == want, name


def _both_clis(artifact, tag, common, jax_extra, port_extra):
    """Both write to the same --output-dir (it is part of the config), one
    after the other."""
    want_dir = artifact / ("jax_" + tag)
    got_dir = artifact / ("torch_" + tag)
    _run("grm_tpu", common + jax_extra + ["--output-dir", "out"], artifact)
    os.rename(artifact / "out", want_dir)
    _run("grm_tpu_torch", common + port_extra + ["--output-dir", "out"],
         artifact)
    os.rename(artifact / "out", got_dir)
    return want_dir, got_dir


@pytest.mark.parametrize("hp_choice", ["cv", "bound"])
def test_port_cli_reports_equal_jax_host(artifact, hp_choice):
    common = ["learn", "scm", "--dataset", "ds.h5", "--split", "sp",
              "--p", "0.5", "1.0", "4.0", "--max-rules", "4",
              "--hp-choice", hp_choice, "--random-seed", "7"]
    want_dir, got_dir = _both_clis(artifact, hp_choice, common,
                                   ["--engine", "host"], ["--device", "cpu"])
    _assert_same_outputs(want_dir, got_dir,
                         {"model.fasta", "model_rule_1_equiv.fasta"})


@pytest.mark.parametrize("hp_choice,engine", [("cv", None), ("bound", None),
                                              ("cv", "device-argmax"),
                                              ("bound", "device")])
def test_port_cli_learn_tree_reports_equal_jax(artifact, hp_choice, engine):
    """``learn tree --device cpu`` (host engine by default there, as ``grm
    learn tree`` on a CPU backend), ``--engine device-argmax`` and
    ``--engine device``, over a grid of criteria, depths and class
    importances."""
    common = ["learn", "tree", "--dataset", "ds.h5", "--split", "sp",
              "--criterion", "gini", "crossentropy", "--max-depth", "2", "4",
              "--class-importance", "0.5", "1.0", "--hp-choice", hp_choice]
    if engine:
        common += ["--engine", engine]
    want_dir, got_dir = _both_clis(artifact, "tree_%s_%s" % (hp_choice, engine),
                                   common, [], ["--device", "cpu"])
    # The bound prunes this small tree down to its root; CV keeps rules.
    rule_files = {"model_rule_0_equiv.fasta"} if hp_choice == "cv" else set()
    _assert_same_outputs(want_dir, got_dir, {"model.fasta"} | rule_files)
    results = json.loads((got_dir / "results.json").read_text())
    assert (results["model"]["n_rules"] >= 1) == (hp_choice == "cv")
    assert "pruning_alpha" in results["cv"]["best_hp"]["values"]


def test_port_cli_learn_tree_exact_engine_ends_with_an_error(artifact):
    """``learn tree --engine device`` once ended with an error here; the
    exact engine now runs, and its reports equal ``grm learn tree --engine
    device``'s, tie sets (the equivalent-rule files) included."""
    common = ["learn", "tree", "--dataset", "ds.h5", "--split", "sp",
              "--criterion", "gini", "crossentropy", "--max-depth", "2", "4",
              "--class-importance", "0.5", "1.0", "--engine", "device"]
    want_dir, got_dir = _both_clis(artifact, "tree_exact", common, [],
                                   ["--device", "cpu"])
    _assert_same_outputs(want_dir, got_dir,
                         {"model.fasta", "model_rule_0_equiv.fasta"})
    equiv = (got_dir / "model_rule_0_equiv.fasta").read_text()
    assert equiv.count(">") >= 2  # the planted tie: columns 9 and 33


@pytest.mark.parametrize("engine,want", [(None, "host"),
                                         ("device", "device")])
def test_port_cli_learn_scm_engine_default_on_the_cpu(artifact, engine, want):
    """``learn scm --device cpu`` without ``--engine`` runs the host engine,
    as ``grm learn scm`` does on a CPU backend; ``--engine device`` still
    runs the exact engine there. The engine that ran is the configuration's
    (``config.json``, written from the parsed arguments), and both give the
    reference's reports."""
    common = ["learn", "scm", "--dataset", "ds.h5", "--split", "sp",
              "--p", "0.5", "4.0", "--max-rules", "3", "--random-seed", "5"]
    port = ["--device", "cpu"] + (["--engine", engine] if engine else [])
    want_dir, got_dir = _both_clis(artifact, "scm_engine_%s" % engine,
                                   common, ["--engine", "host"], port)
    config = json.loads((got_dir / "config.json").read_text())
    assert config["engine"] == want and config["device"] == "cpu"
    _assert_same_outputs(want_dir, got_dir, {"model.fasta"})
