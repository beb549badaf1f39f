"""The port's spans (``grm_tpu_torch.profiling.span``): off, one shared
context that records nothing; on, records with their parent, counts and
drops; in ``torch_trace``'s Chrome trace as ``grm:`` ranges; and the span
tree that ``learn_SCM``, ``learn_CART`` and the device ingest emit on the
CPU, whose results spans leave as they were."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from grm_tpu_torch import profiling
from grm_tpu_torch.dataset import GrmDataset, from_numpy_artifact
from grm_tpu_torch.dataset.split import split_with_proportion
from grm_tpu_torch.learning.experiments import learn_CART, learn_SCM
from grm_tpu_torch.parallel.device_build import build_matrix_device_batched
from grm_tpu_torch.pipeline import DeviceDataset, train_scm
from grm_tpu_torch.reports import write_cart_outputs, write_scm_outputs


@pytest.fixture
def spans_on():
    profiling.take_spans()
    profiling.record_spans(True)
    yield
    profiling.record_spans(False)
    profiling.take_spans()


def test_off_a_span_is_the_one_shared_noop():
    profiling.record_spans(False)
    profiling.take_spans()
    a = profiling.span("a")
    b = profiling.span("b", bytes=3)
    assert a is b and not a
    with a as rec:
        rec["nodes"] = 5
    assert profiling.take_spans() == ([], 0)


def test_on_records_name_times_parent_and_counts(spans_on):
    with profiling.span("outer", bytes=7) as outer:
        with profiling.span("inner") as inner:
            inner["nodes"] = 3.0
        outer["trees"] = 2
    with profiling.span("next"):
        pass
    recs, dropped = profiling.take_spans()
    assert dropped == 0
    assert [r.name for r in recs] == ["outer", "inner", "next"]
    assert recs[0] is outer and recs[1] is inner and inner
    assert outer.parent is None and inner.parent is outer
    assert recs[2].parent is None
    assert outer.counts == {"bytes": 7, "trees": 2}
    assert inner.counts == {"nodes": 3} and type(inner.counts["nodes"]) is int
    for r in recs:
        assert r.rank is None and r.start <= r.end
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert outer.end <= recs[2].start


def test_take_spans_empties_the_record(spans_on):
    with profiling.span("a"):
        pass
    assert len(profiling.take_spans()[0]) == 1
    assert profiling.take_spans() == ([], 0)


def test_records_past_the_bound_are_counted(spans_on, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    for i in range(5):
        with profiling.span("s%d" % i):
            pass
    recs, dropped = profiling.take_spans()
    assert [r.name for r in recs] == ["s0", "s1", "s2"] and dropped == 2


def test_a_span_ends_on_an_exception(spans_on):
    with pytest.raises(ValueError):
        with profiling.span("fails"):
            raise ValueError("x")
    with profiling.span("after"):
        pass
    recs, _ = profiling.take_spans()
    assert recs[0].end is not None and recs[1].parent is None


def test_spanned_wraps_each_call(spans_on):
    @profiling.spanned("wrapped")
    def add(a, b=1):
        """Add."""
        return a + b

    assert add(2, b=3) == 5 and add.__doc__ == "Add."
    recs, _ = profiling.take_spans()
    assert [r.name for r in recs] == ["wrapped"]
    profiling.record_spans(False)
    assert add(1) == 2 and profiling.take_spans() == ([], 0)


def test_torch_trace_shows_spans_as_grm_ranges(tmp_path):
    profiling.record_spans(False)
    with profiling.torch_trace(tmp_path / "trace") as prof:
        with profiling.span("t.outer"):
            with profiling.span("t.inner"):
                (torch.arange(100.0) * 2).sum()
    assert not profiling.span("t.after")  # off again after the block
    recs, _ = profiling.take_spans()
    assert [r.name for r in recs] == ["t.outer", "t.inner"]
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"grm:t.outer", "grm:t.inner"} <= names


# -- the span tree of each path ---------------------------------------------

SCM = dict(model_type=["conjunction", "disjunction"], p=[0.5, 1.0],
           max_rules=4, max_equiv_rules=10000, parameter_selection="cv",
           random_seed=42, bound_delta=0.05)
CART = dict(criterion=["gini"], max_depth=[4], min_samples_split=[2],
            class_importance=[{0: 1.0, 1: 1.0}], bound_delta=0.05,
            parameter_selection="cv")
N_FOLDS = 3


@pytest.fixture(scope="module")
def artifact():
    arrays, attrs = chip_smoke.synthetic_arrays(130, 3000, 5)
    mem = from_numpy_artifact(arrays, attrs)
    split_with_proportion(mem, "sp", train_prop=0.67, random_seed=42,
                          n_folds=N_FOLDS, device="cpu")
    return mem, arrays


def _rule(r):
    return (str(r.kmer_sequence), str(r.type))


def _metrics(m):
    return None if m is None else {k: np.asarray(v).tolist()
                                   for k, v in m.items()}


def _learn(kind, artifact, out_dir):
    """One learn job as ``grm learn`` runs it: the load, the learner, the
    report. Returns its fingerprint and the loaded matrix's bytes."""
    mem, arrays = artifact
    ds = GrmDataset(mem.path, device="cpu")
    ds.bit_matrix()
    if kind == "scm":
        out = learn_SCM(dataset_file=ds, split_name="sp", engine="device",
                        bound_max_genome_size=ds.kmer_count, device="cpu",
                        **SCM)
        write_scm_outputs(str(out_dir), ds, "sp", {}, *out,
                          running_time_seconds=0.0)
        best_hp, score, train_m, test_m, model, imps, equiv, cls = out
        model_key = [_rule(r) for r in model.rules]
        equiv_key = [[_rule(e) for e in eq] for eq in equiv]
    else:
        out = learn_CART(dataset_file=ds, split_name="sp", engine="device",
                         bound_max_genome_size=ds.kmer_count, device="cpu",
                         **CART)
        write_cart_outputs(str(out_dir), ds, "sp", {}, *out,
                           running_time_seconds=0.0,
                           classification_type=ds.classification_type)
        best_hp, score, train_m, test_m, model, imps, equiv, cls = out
        model_key = str(model)
        equiv_key = sorted((_rule(r), [_rule(e) for e in eq])
                           for r, eq in equiv.items())
        imps = [imps[r] for r in model.decision_tree.rules]
    fp = {"hp": sorted((k, str(v)) for k, v in best_hp.items()),
          "score": float(score), "model": model_key, "equiv": equiv_key,
          "importances": np.asarray(imps, np.float64).tolist(),
          "train": _metrics(train_m), "test": _metrics(test_m),
          "cls": {k: sorted(str(g) for g in v) for k, v in cls.items()}}
    return fp, arrays["kmer_matrix"].nbytes


@pytest.fixture(scope="module")
def genomes():
    codes, labels, _ = chip_smoke.ingest_genomes(70, 20000, 90, 520, 0)
    return codes, labels


def _ingest(genomes):
    codes, labels = genomes
    ids = ["g%d" % i for i in range(len(codes))]
    dm = build_matrix_device_batched(
        codes, 31, genome_ids=ids, k_budget=1 << 17, genome_batch=32,
        batch_budget=1 << 17, filter_singleton=True, device="cpu")
    ds = DeviceDataset(dm, dict(zip(ids, labels.tolist())))
    res = train_scm(ds, model_type="conjunction", p=1.0, max_rules=10)
    fp = {"union": dm.union_kmers_host().tobytes(),
          "matrix": dm.matrix.numpy().tobytes(),
          "rules": [_rule(r) for r in res.rules],
          "train": _metrics(res.train_metrics),
          "test": _metrics(res.test_metrics)}
    return fp, dm


def _run(kind, artifact, genomes, out_dir):
    if kind == "ingest":
        return _ingest(genomes)
    return _learn(kind, artifact, out_dir)


TREES = {
    "scm": {("load", None), ("load.read", "load"), ("load.stage", "load"),
            ("load.fill", "load"), ("load.enqueue", "load"),
            ("scm.learn", None), ("scm.fits", "scm.learn"),
            ("scm.step", "scm.fits"), ("scm.apply", "scm.step"),
            ("scm.sweep", "scm.step"), ("scm.gather", "scm.step"),
            ("scm.select", "scm.step"), ("scm.predict", "scm.learn"),
            ("scm.train", "scm.learn"), ("scm.rules", "scm.learn"),
            ("scm.bound", "scm.learn"), ("report.write", None)},
    "cart": {("load", None), ("load.read", "load"), ("load.stage", "load"),
             ("load.fill", "load"), ("load.enqueue", "load"),
             ("cart.learn", None), ("cart.grow", "cart.learn"),
             ("cart.round", "cart.grow"), ("cart.advance", "cart.round"),
             ("cart.score", "cart.round"), ("cart.replay", "cart.score"),
             ("cart.finish", "cart.learn"), ("cart.predict", "cart.learn"),
             ("cart.prune", "cart.finish"), ("cart.folds", "cart.finish"),
             ("cart.equiv", "cart.learn"), ("cart.select", "cart.learn"),
             ("report.write", None)},
    "ingest": {("ingest.build", None), ("ingest.pad", "ingest.build"),
               ("ingest.batch", "ingest.build"),
               ("ingest.merge", "ingest.build"),
               ("ingest.counts", "ingest.build"),
               ("ingest.compact", "ingest.build"), ("pipeline.fit", None),
               ("pipeline.decode", "pipeline.fit")},
}


def _by_name(recs, name):
    return [r for r in recs if r.name == name]


@pytest.mark.parametrize("kind", ["scm", "cart", "ingest"])
def test_each_path_emits_its_span_tree(kind, artifact, genomes, tmp_path,
                                       spans_on):
    _, extra = _run(kind, artifact, genomes, tmp_path)
    recs, dropped = profiling.take_spans()
    assert dropped == 0
    # The load's waits are on the copy events of a CUDA load only.
    tree = {(r.name, r.parent.name if r.parent else None) for r in recs}
    assert tree == TREES[kind]
    for r in recs:
        assert r.start <= r.end and r.rank is None
        if r.parent is not None:
            assert r.parent.start <= r.start <= r.end <= r.parent.end
    if kind in ("scm", "cart"):
        (load,) = _by_name(recs, "load")
        assert load.counts["bytes"] == extra
        assert sum(r.counts["bytes"] for r in _by_name(recs, "load.fill")) \
            == extra
    if kind == "scm":
        fits = len(SCM["model_type"]) * len(SCM["p"]) * (N_FOLDS + 1)
        steps = _by_name(recs, "scm.step")
        assert 2 <= len(steps) <= SCM["max_rules"] + 1
        assert all(0 <= s.counts["fits"] <= fits for s in steps)
        assert steps[0].counts["fits"] == fits
        assert len(_by_name(recs, "scm.select")) == len(steps) - 1
        assert all(s.counts["candidates"] >= 1
                   for s in _by_name(recs, "scm.select"))
    elif kind == "cart":
        rounds = _by_name(recs, "cart.round")
        scored = [r for r in rounds if "nodes" in r.counts]
        assert scored and sum(r.counts["nodes"] for r in scored) >= 2
        # The fold trees and the master grow together.
        assert scored[0].counts == {"trees": N_FOLDS + 1,
                                    "nodes": N_FOLDS + 1}
        assert all(1 <= r.counts["trees"] <= N_FOLDS + 1 for r in scored)
        (prune,) = _by_name(recs, "cart.prune")
        assert prune.counts["trees"] >= N_FOLDS + 1
        (grow,) = _by_name(recs, "cart.grow")
        assert grow.counts == {"trees": N_FOLDS + 1, "combos": 1}
        (select,) = _by_name(recs, "cart.select")
        assert select.counts == {"ties": 0}
    else:
        dm = extra
        pads = _by_name(recs, "ingest.pad")
        assert [p.counts["genomes"] for p in pads] == [32, 32, 6]
        width = -(-20000 // 4096) * 4096
        assert [p.counts["bytes"] for p in pads] == [32 * width, 32 * width,
                                                     6 * width]
        assert len(_by_name(recs, "ingest.batch")) == 3
        (decode,) = _by_name(recs, "pipeline.decode")
        assert decode.counts["bytes"] == dm.n_kmers * dm.union_words.shape[1] * 4


@pytest.mark.parametrize("kind", ["scm", "cart", "ingest"])
def test_spans_leave_each_result_as_it_was(kind, artifact, genomes,
                                          tmp_path):
    profiling.record_spans(False)
    profiling.take_spans()
    off, _ = _run(kind, artifact, genomes, tmp_path / "off")
    assert profiling.take_spans() == ([], 0)
    profiling.record_spans(True)
    try:
        on, _ = _run(kind, artifact, genomes, tmp_path / "on")
    finally:
        profiling.record_spans(False)
    assert profiling.take_spans()[0]
    assert on == off
    if kind != "ingest":
        for name in ("report.txt", "results.json"):
            with open(os.path.join(tmp_path, "off", name)) as a, \
                    open(os.path.join(tmp_path, "on", name)) as b:
                assert a.read() == b.read()
