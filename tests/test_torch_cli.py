"""The port's CLI (``python -m grm_tpu_torch learn scm --device cpu``, exact
device engine by default) against ``grm learn scm --engine host``: every
report file is equal, apart from the running time and the lines that say
how each ran (``engine``, ``device`` and ``n_devices`` in the
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


def _run(module, args, cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["GRM_PLATFORM"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=cwd,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


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


@pytest.mark.parametrize("hp_choice", ["cv", "bound"])
def test_port_cli_reports_equal_jax_host(artifact, hp_choice):
    common = ["learn", "scm", "--dataset", "ds.h5", "--split", "sp",
              "--p", "0.5", "1.0", "4.0", "--max-rules", "4",
              "--hp-choice", hp_choice, "--random-seed", "7"]
    # Both write to the same --output-dir (it is part of the config), one
    # after the other.
    want_dir = artifact / ("jax_" + hp_choice)
    got_dir = artifact / ("torch_" + hp_choice)
    _run("grm_tpu", common + ["--engine", "host", "--output-dir", "out"],
         artifact)
    os.rename(artifact / "out", want_dir)
    _run("grm_tpu_torch", common + ["--device", "cpu", "--output-dir", "out"],
         artifact)
    os.rename(artifact / "out", got_dir)
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    assert "model.fasta" in names and "model_rule_1_equiv.fasta" in names
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
