"""``learn_SCM`` and ``learn_CART`` through both device engines on a (1, 4)
mesh that spans two gloo processes on the CPU (``tests/torch_mesh_worker
.py``, 2 devices a process), against ``grm_tpu``'s runs on
``make_mesh(4)`` of its 8 virtual devices and the port's unsharded runs:
each process's hyperparameters, score, rules, tie sets, importances,
metrics and classifications must be equal, and so must the report files
each process writes into its own directory. Each process loads only its
own shards of the artifact. K = 517 over 4 shards of 130 leaves the last
shard 3 padding columns."""

import filecmp
import os

import numpy as np
import pytest
import torch

from grm_tpu import pipeline as jp
from grm_tpu.learning.experiments import cart_experiment as jax_cart
from grm_tpu.learning.experiments.scm_experiment import learn_SCM as jax_scm
from grm_tpu.parallel.mesh import make_mesh as jax_mesh

import grm_tpu_torch.pipeline as tp
from grm_tpu_torch.dataset import GrmDataset
from grm_tpu_torch.learning.experiments import learn_CART, learn_SCM
from grm_tpu_torch.reports import write_cart_outputs, write_scm_outputs

from test_torch_learn_cart import CV as CART_CV
from test_torch_learn_cart import _cart_fingerprint
from test_torch_learn_cart import _tied_dense as _cart_dense
from test_torch_learn_scm import CV as SCM_CV
from test_torch_learn_scm import _artifact, _scm_fingerprint
from test_torch_learn_scm import _tied_dense as _scm_dense
from test_torch_mesh_procs import run_workers, _outputs
from test_torch_pipeline import MARKER, _result

ENGINES = ["device", "device-argmax"]
TRAIN_RUNS = [("conjunction", 1.0, 0), ("disjunction", 0.5, 7)]
LEARNERS = {
    "scm": (learn_SCM, jax_scm, _scm_fingerprint, write_scm_outputs),
    "cart": (learn_CART, jax_cart.learn_CART, _cart_fingerprint,
             write_cart_outputs),
}


@pytest.fixture(scope="module")
def learned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("learn_procs")
    dense, labels = _scm_dense(0, n_genomes=60, n_kmers=517)
    scm_path, _ = _artifact(tmp, dense, labels, "scm", 0)
    dense, labels = _cart_dense(2, n_genomes=60, n_kmers=517)
    cart_path, _ = _artifact(tmp, dense, labels, "cart", 2)
    specs, labels = _fasta(tmp)
    km = tp.InMemoryDataset.from_contigs(specs, labels, 15, device="cpu").km
    inputs = {"scm_path": str(scm_path), "cart_path": str(cart_path),
              "scm_kwargs": SCM_CV,
              "cart_kwargs": dict(CART_CV, criterion=["gini",
                                                      "cross-entropy"]),
              "reports": str(tmp / "reports"), "km": km, "labels": labels,
              "specs": specs, "train_runs": TRAIN_RUNS}
    return inputs, _outputs(run_workers(tmp, 2, 2, ["learn", "train"],
                                        inputs))


def _fasta(tmp):
    """``tests/test_torch_pipeline.py``'s 40 genomes (its ``fasta``
    fixture's recipe): mutated copies of one backbone, half with a marker,
    each with a second contig holding an invalid base."""
    rng = np.random.RandomState(42)
    backbone = rng.choice(list("ACGT"), 500)
    specs, labels = [], {}
    for i in range(40):
        gid = "m%02d" % i
        s = backbone.copy()
        s[rng.randint(0, 500, 8)] = rng.choice(list("ACGT"), 8)
        s = "".join(s)
        seq = s[:250] + (MARKER if i % 2 else "") + s[250:]
        path = tmp / ("%s.fna" % gid)
        path.write_text(">c\n%s\n%s\n>d\nACGTACNGTACGTTGCA\n"
                        % (seq[:300], seq[300:]))
        specs.append((gid, str(path)))
        labels[gid] = i % 2
    return specs, labels


def _write(writer, out, path, directory, engine, what):
    (best_hp, best_hp_score, train_m, test_m, model, imps, equiv,
     cls) = out
    more = {"classification_type": "binary"} if what == "cart" else {}
    writer(output_dir=directory, dataset=GrmDataset(path, device="cpu"),
           split_name="sp", config={"engine": engine}, best_hp=best_hp,
           best_hp_score=best_hp_score, train_metrics=train_m,
           test_metrics=test_m, model=model, rule_importances=imps,
           equivalent_rules=equiv, classifications=cls,
           running_time_seconds=0.0, **more)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("what", ["scm", "cart"])
def test_learn_on_a_mesh_across_processes(learned, tmp_path, what, engine):
    inputs, out = learned
    learn, jax_learn, fingerprint, writer = LEARNERS[what]
    path, kwargs = inputs[what + "_path"], inputs[what + "_kwargs"]
    want = fingerprint(jax_learn(dataset_file=path, engine=engine,
                                 mesh=jax_mesh(4), **kwargs))
    unsharded = learn(dataset_file=path, engine=engine, device="cpu",
                      **kwargs)
    assert fingerprint(unsharded) == want
    for rank_out in out:
        assert fingerprint(rank_out["learn"][(what, engine)]) == want
    if engine == "device" and what == "scm":
        assert any(len(eq) > 1 for eq in want["equiv"])
    # Every process wrote the unsharded run's report files.
    _write(writer, unsharded, path, str(tmp_path), engine, what)
    names = sorted(os.listdir(tmp_path))
    for rank in range(2):
        theirs = os.path.join(inputs["reports"], "rank%d" % rank,
                              "%s-%s" % (what, engine))
        assert sorted(os.listdir(theirs)) == names
        match, mismatch, errors = filecmp.cmpfiles(tmp_path, theirs, names,
                                                   shallow=False)
        assert (mismatch, errors) == ([], [])


def test_each_process_loads_only_its_shards(learned):
    """The artifact's matrix loaded on the (1, 4) mesh: each process holds
    its two positions' shards, and together they are the matrix once."""
    _, out = learned
    total = 0
    for rank, rank_out in enumerate(out):
        held = rank_out["learn"]["held"]
        assert held["owners"] == [[0, 0, 1, 1]]
        assert sorted(held["positions"]) == [(0, 2 * rank), (0, 2 * rank + 1)]
        assert held["none"] == 2
        total += held["words"]
    assert total == 2 * 130 * 4  # 2 word rows x 4 shards of 130 columns


def test_a_process_mesh_needs_the_group():
    """Without a process group a mesh names one process's devices; owners
    must name a position of this process."""
    from grm_tpu_torch.parallel.mesh import Mesh, make_mesh

    mesh = make_mesh(4, devices=[torch.device("cpu")] * 4)
    assert mesh.owners is None and not mesh.spans_processes
    with pytest.raises(ValueError, match="owns no position"):
        Mesh([[torch.device("cpu")] * 2], owners=[[1, 1]])
    owned = Mesh([[torch.device("cpu")] * 2], owners=[[0, 0]])
    assert not owned.spans_processes and owned != mesh
    assert owned.device == torch.device("cpu")


def test_train_scm_on_a_mesh_across_processes(learned):
    """train_scm on a (1, 4) mesh over two processes: every process fits
    grm_tpu's model on make_mesh(4), and the port's unsharded one."""
    inputs, out = learned
    want = jp.InMemoryDataset.from_contigs(inputs["specs"], inputs["labels"],
                                           15)
    plain = tp.InMemoryDataset(inputs["km"], inputs["labels"], device="cpu")
    for model_type, p, seed in TRAIN_RUNS:
        r_want = _result(jp.train_scm(want, model_type=model_type, p=p,
                                      max_rules=4, random_seed=seed,
                                      mesh=jax_mesh(4)))
        assert _result(tp.train_scm(plain, model_type=model_type, p=p,
                                    max_rules=4, random_seed=seed)) == r_want
        for rank_out in out:
            assert tuple(rank_out["train"][model_type]) == r_want
        assert r_want[0]
