"""The job of ``grm learn tree``: open the artifact afresh, load its matrix
onto the card, learn (every fold's tree and the master tree, the pruning,
the alpha chosen by cross-validation, the predictions), write the reports,
synchronize.

Set-up makes the same artifact as ``learn scm``'s, its split written into
it (:mod:`harness.artifact`). The check holds the last job of the window
to the plain reference: the loaded matrix word for word, the report
against what ``learn_CART`` returned, and everything ``learn_CART``
decided against :func:`reference.cart.learn_tree`.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from harness.artifact import SPLIT, make_artifact, matrix_mismatches, packed
from harness.compare import compare
from reference import cart as ref
from reference import scm as scm_ref


def span(spans, name):
    return spans.span(name) if spans is not None else contextlib.nullcontext()


def _s(x):
    return x.decode() if isinstance(x, bytes) else str(x)


class State:
    def __init__(self, config, seed, device):
        self.config = config
        self.device = torch.device(device)
        self.settings = dict(config["cart"])
        self.mem, self.arrays, self.split = make_artifact(config, seed,
                                                          device)
        self.tags = [_s(t) for t in self.arrays["phenotype_tags"]]
        self.tmp = tempfile.mkdtemp(prefix="bench-learn-tree-")
        self.n_jobs = 0


def setup(config, traffic, seed, device):
    return State(config, seed, device)


def class_importance(state):
    return {int(c): float(v)
            for c, v in state.settings["class_importance"].items()}


def cli_config(state, path, output_dir, kmer_count):
    """The configuration the report records, as ``grm learn tree`` passes
    it (its parsed arguments)."""
    s = state.settings
    return {"dataset": path, "split": SPLIT, "criterion": [s["criterion"]],
            "max_depth": [s["max_depth"]],
            "min_samples_split": [s["min_samples_split"]],
            "class_importance": None, "kmer_blacklist": None,
            "hp_choice": "cv", "bound_max_genome_size": kmer_count,
            "n_cpu": 1, "engine": s["engine"], "n_devices": 1,
            "device": state.device.type, "output_dir": output_dir,
            "progress": False, "verbose": False, "authorized_rules": "",
            "bound_delta": s["bound_delta"]}


def run(state, spans):
    """One job. Returns the dataset (its loaded matrix), learn_CART's
    output and the report's directory."""
    from grm_tpu_torch.dataset import GrmDataset
    from grm_tpu_torch.learning.experiments import learn_CART
    from grm_tpu_torch.reports import write_cart_outputs

    s = state.settings
    ds = GrmDataset(state.mem.path, device=state.device)
    with span(spans, "load"):
        ds.bit_matrix()
    with span(spans, "fit"):
        out = learn_CART(
            dataset_file=ds, split_name=SPLIT, criterion=[s["criterion"]],
            max_depth=[s["max_depth"]],
            min_samples_split=[s["min_samples_split"]],
            class_importance=[class_importance(state)],
            bound_delta=s["bound_delta"],
            bound_max_genome_size=ds.kmer_count, parameter_selection="cv",
            engine=s["engine"], device=state.device)
    with span(spans, "report"):
        state.n_jobs += 1
        out_dir = os.path.join(state.tmp, "job-%d" % state.n_jobs)
        write_cart_outputs(out_dir, ds, SPLIT,
                           cli_config(state, ds.path, out_dir, ds.kmer_count),
                           *out, running_time_seconds=0.0,
                           classification_type=ds.classification_type)
    if state.device.type == "cuda":
        torch.cuda.synchronize()
    return {"ds": ds, "out": out, "dir": out_dir}


def release(state, outcome):
    shutil.rmtree(outcome["dir"], ignore_errors=True)
    outcome.clear()


def work(state):
    return {}


def fingerprint(out):
    """Everything learn_CART decides, in the reference's form."""
    best_hp, score, train_m, test_m, model, imps, equiv, cls = out
    tags = model.class_tags

    def shape(nd):
        if nd.is_leaf:
            return _s(tags[nd.class_prediction])
        return [_s(nd.rule.kmer_sequence), shape(nd.left_child),
                shape(nd.right_child)]

    key = lambda r: (_s(r.kmer_sequence), _s(r.type))
    rules = model.decision_tree.rules
    floats = [("score", float(score)),
              ("pruning_alpha", float(best_hp["pruning_alpha"]))]
    floats += [("importance.%d" % i, float(imps[r]))
               for i, r in enumerate(rules)]
    floats += scm_ref.metric_floats("train", train_m)
    ints = scm_ref.metric_ints("train", train_m)
    if test_m is not None:
        floats += scm_ref.metric_floats("test", test_m)
        ints += scm_ref.metric_ints("test", test_m)
    return {
        "hp": [_s(best_hp["criterion"]), int(best_hp["max_depth"]),
               float(best_hp["min_samples_split"])],
        "tree": shape(model.decision_tree),
        "rules": [key(r) for r in rules],
        "equiv": [[key(e) for e in equiv[r]] for r in rules],
        "cls": {k: sorted(_s(g) for g in v) for k, v in cls.items()},
        "floats": dict(floats),
        "ints": dict(ints),
    }


def summary(outcome):
    return json.dumps(fingerprint(outcome["out"]), sort_keys=True)


def report_mismatches(out, out_dir):
    """How many of results.json's fields differ from learn_CART's output."""
    best_hp, score, train_m, test_m, model, imps, equiv, cls = out
    with open(os.path.join(out_dir, "results.json")) as f:
        res = json.load(f)
    rules = model.decision_tree.rules
    values = res["cv"]["best_hp"]["values"]
    pairs = [
        (values["criterion"], _s(best_hp["criterion"])),
        (values["max_depth"], int(best_hp["max_depth"])),
        (values["min_samples_split"], int(best_hp["min_samples_split"])),
        (values["pruning_alpha"], float(best_hp["pruning_alpha"])),
        (res["cv"]["best_hp"]["score"], float(score)),
        (res["model"]["rules"], [str(r) for r in rules]),
        (res["model"]["rule_importances"], [float(imps[r]) for r in rules]),
        (res["model"]["equivalent_rule_counts"],
         [len(equiv[r]) for r in rules]),
        (res["classifications"],
         {k: [_s(g) for g in v] for k, v in cls.items()}),
    ]
    for side, m in (("train", train_m), ("test", test_m)):
        pairs.append((res["metrics"][side],
                      None if m is None else json.loads(json.dumps(
                          {k: np.asarray(v).tolist() for k, v in m.items()}))))
    return sum(a != b for a, b in pairs)


def reference_fingerprint(state, pm, dtype=np.float64):
    """The reference's fingerprint of the job (``dtype``: its precision)."""
    a = state.arrays
    t0 = time.perf_counter()
    fp = ref.learn_tree(pm, a["phenotype"],
                        [_s(g) for g in a["genome_identifiers"]],
                        a["kmer_sequences"], state.split, state.settings,
                        state.tags, dtype)
    log("reference %.2f s" % (time.perf_counter() - t0))
    return fp


def numbers(state, matrix, report, learn, gap):
    return [("matrix_words_differ", matrix, 0),
            ("report_fields_differ", report, 0),
            ("learn_entries_differ", learn, 0),
            ("learn_float_gap", gap,
             state.config["limits"]["tree_float_gap"])]


def check(state, outcome):
    """The numbers compared, each with its limit. The program's state is
    read (matrix, report) and freed before the reference runs."""
    pm = packed(state.arrays, state.device)
    matrix = matrix_mismatches(outcome["ds"].bit_matrix(), pm)
    report = report_mismatches(outcome["out"], outcome["dir"])
    got = fingerprint(outcome["out"])
    release(state, outcome)
    shutil.rmtree(state.tmp, ignore_errors=True)
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    return numbers(state, matrix, report,
                   *compare(got, reference_fingerprint(state, pm)))


# The program's own float32 path (engine "device-argmax": float32 scores,
# ties to the lowest column, no tie sets) read 0 on every number at this
# size (three seeds on an H100): it learns the same trees here, so it is
# no control of this cell; ``control`` still runs it by name.
CONTROLS = ("float32",)


def control(state, name):
    """A control's numbers. ``float32``: the reference in float32, in the
    program's place, against the reference in float64. ``argmax``: the
    program with its own lower path switched on (``engine="device-argmax"``)
    through the check."""
    if name == "argmax":
        state.settings["engine"] = "device-argmax"
        return check(state, run(state, None))
    pm = packed(state.arrays, state.device)
    want = reference_fingerprint(state, pm)
    got = reference_fingerprint(state, pm, np.float32)
    return numbers(state, 0, 0, *compare(got, want))


def log(msg):
    print("[learn_cart] " + msg, file=sys.stderr, flush=True)
