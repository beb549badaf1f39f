"""The job of ``grm learn scm``: open the artifact afresh, load its matrix
onto the card, learn (cross-validation over the model types and p values,
the choice of hyperparameters, the full training, the predictions, the
bound), write the reports, synchronize.

Set-up makes the artifact from the seed, its split written into it
(:mod:`harness.artifact`).

The check holds the last job of the window to the plain reference: the
loaded matrix word for word, the report against what ``learn_SCM``
returned, and everything ``learn_SCM`` decided against
:func:`reference.scm.learn_scm`.
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
from reference import scm as ref


def span(spans, name):
    return spans.span(name) if spans is not None else contextlib.nullcontext()


def _s(x):
    return x.decode() if isinstance(x, bytes) else str(x)


class State:
    def __init__(self, config, traffic, seed, device):
        self.config = config
        self.device = torch.device(device)
        self.settings = dict(config["scm"])
        self.mem, self.arrays, self.split = make_artifact(config, seed,
                                                          device)
        self.tmp = tempfile.mkdtemp(prefix="bench-learn-scm-")
        self.n_jobs = 0


def setup(config, traffic, seed, device):
    return State(config, traffic, seed, device)


def cli_config(state, path, output_dir):
    """The configuration the report records, as ``grm learn scm`` passes
    it (its parsed arguments)."""
    s = state.settings
    return {"dataset": path, "split": SPLIT, "model_type": s["model_type"],
            "p": s["p"], "kmer_blacklist": None, "max_rules": s["max_rules"],
            "max_equiv_rules": s["max_equiv_rules"], "hp_choice": "cv",
            "bound_max_genome_size": None, "random_seed": s["random_seed"],
            "n_cpu": 1, "engine": s["engine"], "n_devices": 1,
            "device": state.device.type, "output_dir": output_dir,
            "progress": False, "verbose": False, "authorized_rules": "",
            "bound_delta": s["bound_delta"]}


def run(state, spans):
    """One job. Returns what the check reads: the dataset (its loaded
    matrix), learn_SCM's output and the report's directory."""
    from grm_tpu_torch.dataset import GrmDataset
    from grm_tpu_torch.learning.experiments import learn_SCM
    from grm_tpu_torch.reports import write_scm_outputs

    s = state.settings
    ds = GrmDataset(state.mem.path, device=state.device)
    with span(spans, "load"):
        ds.bit_matrix()
    with span(spans, "fit"):
        out = learn_SCM(
            dataset_file=ds, split_name=SPLIT, model_type=s["model_type"],
            p=s["p"], max_rules=s["max_rules"],
            max_equiv_rules=s["max_equiv_rules"], parameter_selection="cv",
            random_seed=s["random_seed"], bound_delta=s["bound_delta"],
            bound_max_genome_size=ds.kmer_count, engine=s["engine"],
            device=state.device)
    with span(spans, "report"):
        state.n_jobs += 1
        out_dir = os.path.join(state.tmp, "job-%d" % state.n_jobs)
        write_scm_outputs(out_dir, ds, SPLIT,
                          cli_config(state, ds.path, out_dir), *out,
                          running_time_seconds=0.0)
    if state.device.type == "cuda":
        torch.cuda.synchronize()
    return {"ds": ds, "out": out, "dir": out_dir}


def release(state, outcome):
    shutil.rmtree(outcome["dir"], ignore_errors=True)
    outcome.clear()


def work(state):
    return {}


def fingerprint(out):
    """Everything learn_SCM decides, in the reference's form."""
    best_hp, score, train_m, test_m, model, imps, equiv, cls = out
    key = lambda r: (_s(r.kmer_sequence), _s(r.type))
    floats = [("score", float(score))]
    floats += [("importance.%d" % i, float(v))
               for i, v in enumerate(np.asarray(imps).ravel())]
    floats += ref.metric_floats("train", train_m)
    ints = ref.metric_ints("train", train_m)
    if test_m is not None:
        floats += ref.metric_floats("test", test_m)
        ints += ref.metric_ints("test", test_m)
    return {
        "hp": [_s(best_hp["model_type"]), float(best_hp["p"]),
               int(best_hp["max_rules"])],
        "rules": [key(r) for r in model.rules],
        "equiv": [[key(e) for e in eq] for eq in equiv],
        "cls": {k: sorted(_s(g) for g in v) for k, v in cls.items()},
        "floats": dict(floats),
        "ints": dict(ints),
    }


def summary(outcome):
    return json.dumps(fingerprint(outcome["out"]), sort_keys=True)


def report_mismatches(out, out_dir):
    """How many of results.json's fields differ from learn_SCM's output."""
    best_hp, score, train_m, test_m, model, imps, equiv, cls = out
    with open(os.path.join(out_dir, "results.json")) as f:
        res = json.load(f)
    pairs = [
        (res["cv"]["best_hp"]["values"]["model_type"],
         _s(best_hp["model_type"])),
        (res["cv"]["best_hp"]["values"]["p"], float(best_hp["p"])),
        (res["cv"]["best_hp"]["values"]["max_rules"],
         int(best_hp["max_rules"])),
        (res["cv"]["best_hp"]["score"], float(score)),
        (res["model"]["rules"], [str(r) for r in model.rules]),
        (res["model"]["rule_importances"],
         [float(v) for v in np.asarray(imps).ravel()]),
        (res["model"]["equivalent_rule_counts"], [len(e) for e in equiv]),
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
    timings = {}
    fp = ref.learn_scm(pm, a["phenotype"],
                       [_s(g) for g in a["genome_identifiers"]],
                       a["kmer_sequences"], state.split, state.settings,
                       dtype, timings)
    log("reference (s): " + " ".join("%s %.2f" % kv for kv in
                                     timings.items()))
    return fp


def check(state, outcome):
    """The numbers compared, each with its limit. The program's state is
    read (matrix, report) and freed before the reference runs."""
    t0 = time.perf_counter()
    pm = packed(state.arrays, state.device)
    matrix = matrix_mismatches(outcome["ds"].bit_matrix(), pm)
    report = report_mismatches(outcome["out"], outcome["dir"])
    got = fingerprint(outcome["out"])
    release(state, outcome)
    shutil.rmtree(state.tmp, ignore_errors=True)
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    want = reference_fingerprint(state, pm)
    learn, gap = compare(got, want)
    log("check: matrix and report %.2f s, reference %.2f s"
        % (t1 - t0, time.perf_counter() - t1))
    return numbers(state, matrix, report, learn, gap)


def numbers(state, matrix, report, learn, gap):
    return [("matrix_words_differ", matrix, 0),
            ("report_fields_differ", report, 0),
            ("learn_entries_differ", learn, 0),
            ("learn_float_gap", gap,
             state.config["limits"]["learn_float_gap"])]


CONTROLS = ("float32", "argmax")


def control(state, name):
    """A control's numbers. ``float32``: the reference in float32, in the
    program's place, against the reference in float64. ``argmax``: the
    program with its own lower path switched on (``engine="device-argmax"``:
    float32 utilities, ties to the lowest column) through the check."""
    if name == "argmax":
        state.settings["engine"] = "device-argmax"
        return check(state, run(state, None))
    pm = packed(state.arrays, state.device)
    want = reference_fingerprint(state, pm)
    got = reference_fingerprint(state, pm, np.float32)
    return numbers(state, 0, 0, *compare(got, want))


def log(msg):
    print("[learn_scm] " + msg, file=sys.stderr, flush=True)
