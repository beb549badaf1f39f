"""The job of the device ingest: genomes' codes to a packed presence matrix
on the card (``build_matrix_device_batched``: batches of genomes, the
singleton filter), a ``DeviceDataset`` over it, and ``train_scm``'s fit,
then a synchronize.

Set-up makes the genomes from the seed (:func:`harness.recipes.
ingest_genomes`: copies of one backbone with SNPs from a shared pool and a
planted 3-marker conjunction); they stay in host memory as int8 codes, as
a user's encoded FASTA would.

The check holds the last job of the window to the plain reference
(:mod:`reference.ingest`): the union's k-mers, the matrix word for word,
and the fitted rules with their metrics.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import torch

from harness import recipes
from harness.compare import exact_differences
from reference import ingest as ref
from reference import scm as scm_ref


def span(spans, name):
    return spans.span(name) if spans is not None else contextlib.nullcontext()


class State:
    def __init__(self, config, traffic, seed, device):
        g = config["genomes"]
        self.config, self.device = config, torch.device(device)
        self.codes, self.labels, _ = recipes.ingest_genomes(
            g["n_genomes"], g["length"], g["n_snps"], g["snp_pool"],
            seed % 2 ** 32, k=config["ingest"]["k"])
        self.ids = ["g%05d" % i for i in range(len(self.codes))]


def setup(config, traffic, seed, device):
    return State(config, traffic, seed, device)


def run(state, spans):
    """One job. Returns the DeviceDataset and train_scm's result."""
    from grm_tpu_torch.parallel.device_build import build_matrix_device_batched
    from grm_tpu_torch.pipeline import DeviceDataset, train_scm

    ing, fit = state.config["ingest"], state.config["fit"]
    with span(spans, "build"):
        dm = build_matrix_device_batched(
            state.codes, ing["k"], genome_ids=state.ids,
            k_budget=ing["k_budget"], genome_batch=ing["genome_batch"],
            batch_budget=ing["batch_budget"],
            filter_singleton=ing["filter_singleton"], device=state.device)
    with span(spans, "fit"):
        ds = DeviceDataset(dm, dict(zip(state.ids, state.labels.tolist())))
        res = train_scm(ds, model_type=fit["model_type"], p=fit["p"],
                        max_rules=fit["max_rules"],
                        train_prop=fit["train_prop"],
                        random_seed=fit["random_seed"])
    if state.device.type == "cuda":
        torch.cuda.synchronize()
    return {"dm": dm, "res": res}


def release(state, outcome):
    outcome.clear()


def work(state):
    """Megabases of genome a job reads."""
    return {"mbp": sum(len(c) for c in state.codes) / 1e6}


def fingerprint(dm, res):
    """The union's size, the fitted rules and their metrics."""
    fp = {"n_kmers": dm.n_kmers,
          "rules": [(str(r.kmer_sequence), str(r.type))
                    for r in res.model.rules],
          "floats": dict(scm_ref.metric_floats("train", res.train_metrics)
                         + scm_ref.metric_floats("test", res.test_metrics)),
          "ints": dict(scm_ref.metric_ints("train", res.train_metrics)
                       + scm_ref.metric_ints("test", res.test_metrics))}
    return fp


def summary(outcome):
    return json.dumps(fingerprint(outcome["dm"], outcome["res"]),
                      sort_keys=True)


def reference(state, canonical=True, min_genomes=None):
    """(union keys, presence, the fit's fingerprint) of the reference.
    ``canonical=False`` or another ``min_genomes`` make a control."""
    ing = state.config["ingest"]
    if min_genomes is None:
        min_genomes = 2 if ing["filter_singleton"] else 1
    union, dense = ref.ingest(state.codes, ing["k"], min_genomes,
                              state.device, canonical)
    fp = ref.fit_fingerprint(dense, union, state.labels,
                             state.config["fit"], ing["k"])
    fp["n_kmers"] = int(union.numel())
    return union, dense, fp


def numbers(k, got_words, got_matrix, got, union, dense, want):
    """The compared numbers of a (union words, matrix, fingerprint) on
    the host against the reference's (union keys, presence, fingerprint)."""
    want_words = ref.key_words(union, k).cpu()
    want_matrix = ref.pack_rows(dense).cpu()
    n, u = got_words.shape[0], union.numel()
    m = min(n, u)
    union_diff = int((got_words[:m] != want_words[:m]).any(1).sum()) \
        + abs(n - u)
    matrix_diff = int((got_matrix[:, :m] != want_matrix[:, :m]).sum()) \
        + abs(n - u) * got_matrix.shape[0]
    return [("union_kmers_differ", union_diff, 0),
            ("matrix_words_differ", matrix_diff, 0),
            ("fit_entries_differ", exact_differences(got, want), 0)]


def check(state, outcome):
    """The numbers compared, each with its limit. The program's union and
    matrix leave the card, and its state is freed, before the reference
    runs."""
    t0 = time.perf_counter()
    dm, res = outcome["dm"], outcome["res"]
    got = fingerprint(dm, res)
    n = dm.n_kmers
    got_words = dm.union_words[:n].cpu()
    got_matrix = dm.matrix[:, :n].cpu()
    release(state, outcome)
    del dm, res
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    union, dense, want = reference(state)
    out = numbers(state.config["ingest"]["k"], got_words, got_matrix, got,
                  union, dense, want)
    print("[ingest_device] check: %.2f s" % (time.perf_counter() - t0),
          file=sys.stderr, flush=True)
    return out


CONTROLS = ("forward_strand", "no_filter")


def control(state, name):
    """A control's numbers: the reference with a guarantee broken, in the
    program's place, against the reference. ``forward_strand``: k-mers
    not made canonical; ``no_filter``: k-mers of one genome kept."""
    k = state.config["ingest"]["k"]
    union, dense, want = reference(state)
    kw = {"forward_strand": {"canonical": False},
          "no_filter": {"min_genomes": 1}}[name]
    c_union, c_dense, got = reference(state, **kw)
    return numbers(k, ref.key_words(c_union, k).cpu(),
                   ref.pack_rows(c_dense).cpu(), got, union, dense, want)
