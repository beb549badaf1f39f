"""The job of ``grm learn tree`` as GRM's GUI sets it up: the grid of class
importances (``--class-importance "0: 0.25 0.5 0.75 1.0 1: 0.25 0.5 0.75
1.0"``, 16 combinations for two classes) with cross-validation. Open the
artifact afresh, load its matrix onto the card, learn (every
combination's fold trees and master tree grown as one forest, each
combination pruned and scored, one selected, its predictions), write the
reports, synchronize.

Set-up, the artifact, the split and most of the check are
``learn_cart``'s (:mod:`jobs.learn_cart`). The fingerprint adds the chosen
class importance to the hyperparameters, and the check holds the last job
of the window to :func:`reference.cart_grid.learn_grid`.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import numpy as np
import torch

from harness.artifact import SPLIT, matrix_mismatches, packed
from harness.compare import compare
from harness.runner import load_module
from reference import cart_grid as ref

base = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "learn_cart.py"), "bench_job_learn_cart")
setup, release, work, numbers = base.setup, base.release, base.work, \
    base.numbers


def class_importances(state):
    """The grid's importance dicts, keyed by class index, in order."""
    return [{int(c): float(v) for c, v in ci.items()}
            for ci in state.settings["class_importance"]]


def cli_tokens(state):
    """``--class-importance`` as the GUI passes it: each class, then its
    values in the grid's order."""
    tokens = []
    for c in sorted({c for ci in class_importances(state) for c in ci}):
        tokens.append("%d:" % c)
        for v in dict.fromkeys(ci[c] for ci in class_importances(state)):
            tokens.append(repr(v))
    return tokens


def cli_config(state, path, output_dir, kmer_count):
    cfg = base.cli_config(state, path, output_dir, kmer_count)
    cfg["class_importance"] = cli_tokens(state)
    return cfg


def run(state, spans):
    """One job. Returns the dataset (its loaded matrix), learn_CART's
    output and the report's directory."""
    from grm_tpu_torch.dataset import GrmDataset
    from grm_tpu_torch.learning.experiments import learn_CART
    from grm_tpu_torch.reports import write_cart_outputs

    s = state.settings
    ds = GrmDataset(state.mem.path, device=state.device)
    with base.span(spans, "load"):
        ds.bit_matrix()
    with base.span(spans, "fit"):
        out = learn_CART(
            dataset_file=ds, split_name=SPLIT, criterion=[s["criterion"]],
            max_depth=[s["max_depth"]],
            min_samples_split=[s["min_samples_split"]],
            class_importance=class_importances(state),
            bound_delta=s["bound_delta"],
            bound_max_genome_size=ds.kmer_count, parameter_selection="cv",
            engine=s["engine"], device=state.device)
    with base.span(spans, "report"):
        state.n_jobs += 1
        out_dir = os.path.join(state.tmp, "job-%d" % state.n_jobs)
        write_cart_outputs(out_dir, ds, SPLIT,
                           cli_config(state, ds.path, out_dir, ds.kmer_count),
                           *out, running_time_seconds=0.0,
                           classification_type=ds.classification_type)
    if state.device.type == "cuda":
        torch.cuda.synchronize()
    return {"ds": ds, "out": out, "dir": out_dir}


def fingerprint(out):
    """Everything learn_CART decides, in the reference's form: the cart
    job's, the chosen class importance last in ``hp``."""
    fp = base.fingerprint(out)
    fp["hp"].append([[int(c), float(v)] for c, v in
                     sorted(out[0]["class_importance"].items())])
    return fp


def summary(outcome):
    return json.dumps(fingerprint(outcome["out"]), sort_keys=True)


def report_mismatches(out, out_dir):
    """How many of results.json's fields differ from learn_CART's output,
    the chosen class importance included."""
    with open(os.path.join(out_dir, "results.json")) as f:
        res = json.load(f)
    chosen = res["cv"]["best_hp"]["values"]["class_importance"]
    want = {str(c): float(v) for c, v in out[0]["class_importance"].items()}
    return base.report_mismatches(out, out_dir) + int(chosen != want)


def reference_fingerprint(state, pm, dtype=np.float64):
    """The reference's fingerprint of the job (``dtype``: its precision)."""
    a = state.arrays
    t0 = time.perf_counter()
    fp = ref.learn_grid(pm, a["phenotype"],
                        [base._s(g) for g in a["genome_identifiers"]],
                        a["kmer_sequences"], state.split, state.settings,
                        state.tags, dtype)
    log("reference %.2f s" % (time.perf_counter() - t0))
    return fp


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


CONTROLS = ("float32",)


def control(state, name):
    """A control's numbers. ``float32``: the reference in float32, in the
    program's place, against the reference in float64."""
    if name != "float32":
        raise ValueError("no control %r" % name)
    pm = packed(state.arrays, state.device)
    want = reference_fingerprint(state, pm)
    got = reference_fingerprint(state, pm, np.float32)
    return numbers(state, 0, 0, *compare(got, want))


def log(msg):
    print("[learn_cart_grid] " + msg, file=sys.stderr, flush=True)
