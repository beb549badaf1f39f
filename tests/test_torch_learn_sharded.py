"""``learn_SCM``, ``learn_CART`` and ``train_scm`` of the port over a device
mesh (on the CPU: meshes that name the CPU 8 times) against ``grm_tpu``'s
runs on its 8 virtual CPU devices and against the port's own unsharded
runs: hyperparameters, score, rules, tie sets, importances, metrics and
classifications must be equal. K = 517 k-mers over 8 shards leaves the
last shard 6 padding columns. Also the row-sharded meshes' blacklist
refusals, and ``learn scm --n-devices`` through the port's CLI."""

import os
import subprocess
import sys

import pytest
import torch

from grm_tpu import pipeline as jp
from grm_tpu.learning.experiments import cart_experiment as jax_cart
from grm_tpu.learning.experiments.scm_experiment import learn_SCM as jax_scm
from grm_tpu.parallel.mesh import make_mesh as jax_mesh

import grm_tpu_torch.pipeline as tp
from grm_tpu_torch.learning.experiments import learn_CART, learn_SCM
from grm_tpu_torch.learning.experiments import scm_experiment as port_scm
from grm_tpu_torch.parallel import cart_exact as port_cart_exact
from grm_tpu_torch.parallel.mesh import MeshSharding, make_mesh

from test_torch_learn_cart import _cart_fingerprint
from test_torch_learn_cart import CV as CART_CV
from test_torch_learn_cart import _tied_dense as _cart_dense
from test_torch_learn_scm import CV as SCM_CV
from test_torch_learn_scm import _artifact, _s, _scm_fingerprint
from test_torch_learn_scm import _tied_dense as _scm_dense
from test_torch_pipeline import _result, fasta  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINES = ["device", "device-argmax"]


def _mesh(row_devices=1):
    return make_mesh(8, row_devices=row_devices,
                     devices=[torch.device("cpu")] * 8)


def _scm_all(path, engine, row_devices=1, **kwargs):
    """(port over the mesh, grm_tpu over its mesh, port unsharded); a
    row-sharded mesh runs the scan engine, which the unsharded argmax
    engine equals."""
    got = _scm_fingerprint(learn_SCM(
        dataset_file=path, engine=engine, mesh=_mesh(row_devices),
        device="cpu", **kwargs))
    want = _scm_fingerprint(jax_scm(
        dataset_file=path, engine=engine,
        mesh=jax_mesh(8, row_devices=row_devices), **kwargs))
    unsharded = _scm_fingerprint(learn_SCM(
        dataset_file=path, device="cpu", **dict(kwargs, engine=(
            engine if row_devices == 1 else "device-argmax"))))
    return got, want, unsharded


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", [0, 3])
def test_learn_scm_on_a_mesh_equals_jax_and_unsharded(tmp_path, seed,
                                                      engine):
    dense, labels = _scm_dense(seed, n_genomes=60, n_kmers=517)
    path, _ = _artifact(tmp_path, dense, labels, "m%d" % seed, seed)
    got, want, unsharded = _scm_all(path, engine, **SCM_CV)
    assert got == want
    assert got == unsharded
    if engine == "device":
        assert any(len(eq) > 1 for eq in got["equiv"])


@pytest.mark.parametrize("engine", ENGINES)
def test_learn_scm_blacklist_on_a_mesh_equals_jax(tmp_path, engine):
    dense, labels = _scm_dense(6, n_genomes=60, n_kmers=517)
    dense[:, 450] = labels  # a perfect marker in the last shard
    path, _ = _artifact(tmp_path, dense, labels, "bl", 6)
    import h5py

    with h5py.File(path) as f:
        marker = _s(f["kmer_sequences"][int(f["kmer_by_matrix_column"][450])])
    bl = tmp_path / "bl.txt"
    bl.write_text(marker + "\n")
    got, want, unsharded = _scm_all(path, engine, **dict(
        SCM_CV, kmer_blacklist_file=str(bl)))
    assert got == want == unsharded
    assert all(seq != marker for seq, _ in got["rules"])


@pytest.mark.parametrize("engine", ENGINES)
def test_learn_scm_on_a_row_mesh_runs_the_scan_engine(tmp_path, engine):
    """(2, 4): both device engines take the pure-argmax scan engine, which
    gives the unsharded argmax engine's model."""
    dense, labels = _scm_dense(4, n_genomes=60, n_kmers=517)
    path, _ = _artifact(tmp_path, dense, labels, "rows", 4)
    got, want, unsharded = _scm_all(path, engine, row_devices=2, **SCM_CV)
    assert got == want
    assert got == unsharded


def test_row_sharded_blacklists_are_refused(tmp_path):
    """grm_tpu's refusals, word for word: a k-mer blacklist file on a
    row-sharded mesh errors before learning; the engines' own guards raise
    ValueError."""
    dense, labels = _scm_dense(2, n_genomes=40, n_kmers=100)
    path, _ = _artifact(tmp_path, dense, labels, "ref", 2)
    bl = tmp_path / "bl.txt"
    bl.write_text("ACGTACGT\n")
    for engine in ENGINES:
        with pytest.raises(Exception, match="row-sharded scan engine does "
                           "not support k-mer blacklists"):
            learn_SCM(dataset_file=path, engine=engine, mesh=_mesh(2),
                      device="cpu", **dict(SCM_CV, kmer_blacklist_file=str(
                          bl)))
        with pytest.raises(Exception, match="row-sharded scan engine does "
                           "not support k-mer blacklists"):
            jax_scm(dataset_file=path, engine=engine,
                    mesh=jax_mesh(8, row_devices=2),
                    **dict(SCM_CV, kmer_blacklist_file=str(bl)))
    from grm_tpu_torch.dataset import GrmDataset

    ds = GrmDataset(path, device="cpu")
    with pytest.raises(ValueError, match="not supported by the row-sharded"):
        port_scm._cross_validation_device(
            ds, "sp", ["conjunction"], [1.0], 3, lambda *a: None,
            mesh=_mesh(2), rule_blacklist=[1, 101])
    with pytest.raises(ValueError, match="not supported by the row-sharded"):
        port_scm._full_train_device(
            ds, "sp", "conjunction", 1.0, 3, lambda *a: None,
            mesh=_mesh(2), rule_blacklist=[1, 101])


def _cart_all(path, engine, **kwargs):
    got = _cart_fingerprint(learn_CART(dataset_file=path, engine=engine,
                                       mesh=_mesh(), device="cpu", **kwargs))
    want = _cart_fingerprint(jax_cart.learn_CART(
        dataset_file=path, engine=engine, mesh=jax_mesh(8), **kwargs))
    unsharded = _cart_fingerprint(learn_CART(dataset_file=path,
                                             engine=engine, device="cpu",
                                             **kwargs))
    return got, want, unsharded


@pytest.mark.parametrize("engine", ENGINES)
def test_learn_cart_on_a_mesh_equals_jax_and_unsharded(tmp_path, engine):
    dense, labels = _cart_dense(2, n_genomes=60, n_kmers=517)
    path, _ = _artifact(tmp_path, dense, labels, "c2", 2)
    got, want, unsharded = _cart_all(path, engine, **dict(
        CART_CV, criterion=["gini", "cross-entropy"]))
    assert got == want
    assert got == unsharded


@pytest.mark.parametrize("engine", ENGINES)
def test_learn_cart_three_classes_on_a_mesh(tmp_path, engine, monkeypatch):
    """Three classes of ~45 training genomes each: the master's root count
    lattice (~46^3) is past the tuple tables' 65,536, so the exact engine's
    gather regime runs, on the shards."""
    modes = []
    orig = port_cart_exact.cart_exact_select

    def spy(matrix, *args, **kwargs):
        modes.append((args[6], matrix.shape[1]))
        return orig(matrix, *args, **kwargs)

    monkeypatch.setattr(port_cart_exact, "cart_exact_select", spy)
    dense, labels = _cart_dense(4, n_genomes=150, n_kmers=517, n_classes=3,
                                mirror=False)
    path, _ = _artifact(tmp_path, dense, labels, "c3", 4, n_folds=2,
                        train_prop=0.9)
    kwargs = dict(CART_CV, class_importance=[{0: 1.0, 1: 1.0, 2: 1.0}])
    got, want, unsharded = _cart_all(path, engine, **kwargs)
    assert got == want
    assert got == unsharded
    assert "confusion_matrix" in got["test"]
    if engine == "device":  # the gather regime ran on the shards
        assert ("gather", 65) in modes


def test_learn_cart_blacklist_on_a_mesh(tmp_path):
    dense, labels = _cart_dense(1, n_genomes=40, n_kmers=517)
    path, _ = _artifact(tmp_path, dense, labels, "cbl", 1)
    base = _cart_fingerprint(learn_CART(dataset_file=path, engine="device",
                                        device="cpu", **CART_CV))
    banned = base["tree"][1][0]
    bl = tmp_path / "bl.txt"
    bl.write_text(banned + "\n")
    for engine in ENGINES:
        kwargs = dict(CART_CV, kmer_blacklist_file=str(bl))
        got = _cart_fingerprint(learn_CART(
            dataset_file=path, engine=engine, mesh=_mesh(), device="cpu",
            **kwargs))
        assert got == _cart_fingerprint(learn_CART(
            dataset_file=path, engine=engine, device="cpu", **kwargs))
        assert all(seq != banned for seq, _ in got["importances"])


def test_one_dataset_serves_sharded_and_unsharded_runs(tmp_path,
                                                       monkeypatch):
    """One loaded GrmDataset through sharded and unsharded learns, in
    turn: each run gives its fresh run's model, a sharded learn reads the
    matrix once, and an unsharded run after a sharded one gets an
    unsharded matrix."""
    from grm_tpu_torch.dataset import GrmDataset, artifact

    dense, labels = _scm_dense(5, n_genomes=60, n_kmers=517)
    path, _ = _artifact(tmp_path, dense, labels, "one", 5)
    ds = GrmDataset(path, device="cpu")
    # Every load of the matrix, whole or sharded, goes through
    # BitMatrix.from_u64 (a sharded one reads only its shards' words).
    reads = []
    orig = artifact.BitMatrix.from_u64.__func__
    monkeypatch.setattr(artifact.BitMatrix, "from_u64", classmethod(
        lambda cls, *a, **kw: reads.append(1) or orig(cls, *a, **kw)))

    def fresh(learn, fingerprint, **kwargs):
        return fingerprint(learn(dataset_file=path, device="cpu", **kwargs))

    runs = [(learn_CART, _cart_fingerprint, "device", True, CART_CV),
            (learn_SCM, _scm_fingerprint, "device", True, SCM_CV),
            (learn_SCM, _scm_fingerprint, "device-argmax", False, SCM_CV),
            (learn_CART, _cart_fingerprint, "device-argmax", False, CART_CV),
            (learn_SCM, _scm_fingerprint, "device", False, SCM_CV),
            (learn_CART, _cart_fingerprint, "device-argmax", True, CART_CV)]
    layout = None
    for learn, fingerprint, engine, sharded, kwargs in runs:
        mesh = _mesh() if sharded else None
        del reads[:]
        got = fingerprint(learn(dataset_file=ds, engine=engine, mesh=mesh,
                                **kwargs))
        n_reads = len(reads)
        assert got == fresh(learn, fingerprint, engine=engine, **kwargs)
        # A new layout is read once, the layout kept not at all.
        assert n_reads == (0 if sharded == layout else 1)
        assert ds._bit_matrix.sharded == sharded
        assert ds.bit_matrix(sharding=(
            None if mesh is None else MeshSharding(mesh))) is ds._bit_matrix
        layout = sharded


def test_in_memory_dataset_follows_the_sharding_asked(fasta):  # noqa: F811
    specs, labels = fasta
    ds = tp.InMemoryDataset.from_contigs(specs, labels, 15, device="cpu")
    plain = tp.train_scm(ds, max_rules=4)
    sharded = tp.train_scm(ds, max_rules=4, mesh=_mesh())
    assert ds._bm.sharded  # the matrix kept is the sharded run's
    again = tp.train_scm(ds, max_rules=4)
    assert not ds.bit_matrix().sharded
    assert _result(plain) == _result(sharded) == _result(again)


def test_learn_on_a_mesh_of_another_device_type_raises(tmp_path):
    dense, labels = _scm_dense(1)
    path, _ = _artifact(tmp_path, dense, labels, "cuda_mesh", 1)
    cuda = make_mesh(2, devices=[torch.device("cuda", 0)] * 2)
    with pytest.raises(ValueError, match="not cpu devices"):
        learn_SCM(dataset_file=path, engine="device", mesh=cuda,
                  device="cpu", **SCM_CV)
    with pytest.raises(ValueError, match="not cpu devices"):
        learn_CART(dataset_file=path, engine="device", mesh=cuda,
                   device="cpu", **CART_CV)


@pytest.mark.parametrize("ingest", ["host", "device"])
def test_train_scm_on_a_mesh_equals_jax(fasta, ingest):  # noqa: F811
    specs, labels = fasta
    if ingest == "host":
        want = jp.InMemoryDataset.from_contigs(specs, labels, 15)
        got = tp.InMemoryDataset.from_contigs(specs, labels, 15,
                                              device="cpu")
        plain = tp.InMemoryDataset.from_contigs(specs, labels, 15,
                                                device="cpu")
    else:
        want = jp.InMemoryDataset.from_contigs_device(specs, labels, 15)
        got = tp.InMemoryDataset.from_contigs_device(specs, labels, 15,
                                                     device="cpu")
        plain = got
    for model_type, p, seed in (("conjunction", 1.0, 0),
                                ("disjunction", 0.5, 7)):
        r_want = jp.train_scm(want, model_type=model_type, p=p, max_rules=4,
                              random_seed=seed, mesh=jax_mesh(8))
        r_got = tp.train_scm(got, model_type=model_type, p=p, max_rules=4,
                             random_seed=seed, mesh=_mesh())
        r_plain = tp.train_scm(plain, model_type=model_type, p=p,
                               max_rules=4, random_seed=seed)
        assert _result(r_got) == _result(r_want) == _result(r_plain)
    assert got.bit_matrix(sharding=None).n_columns == got.kmer_count
    assert r_got.rules


def _cli(args, cwd, expect):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", "grm_tpu_torch"] + args,
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == expect, r.stdout + r.stderr
    return r.stdout


def test_cli_learn_scm_n_devices(tmp_path):
    """``--engine device --n-devices 4 --device cpu`` (the exact engine over
    four column shards of the CPU) gives the host engine's rules and test
    risk; ``--n-devices`` with the host engine exits 1."""
    import json

    dense, labels = _scm_dense(3, n_genomes=40, n_kmers=130)
    _artifact(tmp_path, dense, labels, "cli", 3)
    common = ["learn", "scm", "--dataset", "cli.h5", "--split", "sp",
              "--p", "0.5", "1.0", "--max-rules", "3", "--device", "cpu"]
    _cli(common + ["--engine", "device", "--n-devices", "4",
                   "--output-dir", "dev4"], tmp_path, 0)
    _cli(common + ["--output-dir", "host"], tmp_path, 0)
    sharded = json.loads((tmp_path / "dev4" / "results.json").read_text())
    host = json.loads((tmp_path / "host" / "results.json").read_text())
    assert sharded["model"]["rules"] == host["model"]["rules"]
    assert sharded["metrics"]["test"]["risk"] == \
        host["metrics"]["test"]["risk"]
    config = json.loads((tmp_path / "dev4" / "config.json").read_text())
    assert config["n_devices"] == 4
    out = _cli(common + ["--engine", "host", "--n-devices", "4",
                         "--output-dir", "x"], tmp_path, 1)
    assert "requires --engine device" in out
    out = _cli(["learn", "tree", "--dataset", "cli.h5", "--split", "sp",
                "--device", "cpu", "--n-devices", "2", "--output-dir", "y"],
               tmp_path, 1)
    assert "requires --engine device" in out


def test_cli_n_devices_1_over_a_memory_artifact_runs_unsharded(
        monkeypatch):
    """``learn scm --engine device --n-devices 1`` through ``cli.main``
    over an in-memory artifact, by its ``memory://`` path (the smoke's
    check on the card): no matrix is placed on a mesh and the report is
    that of the command without the flag. A path of no live artifact
    raises."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    from grm_tpu_torch.dataset import GrmDataset

    monkeypatch.setattr(chip_smoke, "CLI_SIZE", (60, 517))
    line = chip_smoke.cli_unsharded(torch.device("cpu"), 1)
    assert "unsharded" in line
    with pytest.raises(FileNotFoundError, match="no artifact"):
        GrmDataset("memory://artifact-999999999", device="cpu")
