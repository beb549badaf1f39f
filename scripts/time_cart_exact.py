#!/usr/bin/env python3
"""Time the exact CART kernels (``cart_exact_tuples``, ``cart_exact_select``)
of one checkout on one NVIDIA GPU, first at the grid cell's shapes, then
at ``chip_smoke.py`` phase 6's.

The grid's: the dataset of ``benchmark/configs/mtb-isoniazid-5022-gui-
grid.json`` (5022 genomes, W = 157 words, x 11,700,000 k-mers) made from
seed 7 as the benchmark makes it, one ``learn_CART`` job over its 16
class-importance combinations (engine device) with every exact launch's
inputs recorded, then each tuple-table launch of 200 nodes or more (the
grid's rounds give 246 on average, up to ~290) and the largest equiv and
gather launches replayed on their own: CUDA-event ms a launch, the least
time (``benchmark/metrics/cart_exact_roofline.py``'s), the share of it,
and the reads of the matrix the launch's plan makes (``exact_layout``'s
``reads``: its grid rows); then the sum
over the job's launches of each kernel. The benchmark's own files come
from the checkout holding this script.

Phase 6's:
the published median matrix (342 genomes x 9,600,000 k-mers, built in
memory from seed 0), Gini, two classes, the tuple tables at a frontier of
18 nodes and at an all-hit node, the gather compaction at that frontier,
the equivalence compaction at 3 nodes and at an all-hit node (18 and 3 are
the largest frontiers phase 5's ``tree-device`` gives each kernel). Each
kernel is held against its plain version first. Then one
``learn_CART(engine="device")`` run on the same matrix (``tree-device``)
counts the nodes of its tuple-table launches by count lattice and those
whose tables a block keeps in shared memory (``exact_layout``'s private
tables), and three more give the device time of those launches, summed over
a run.

    python3 scripts/time_cart_exact.py [--repo DIR] [--grid-only]

``--repo`` names the checkout whose package and ``chip_smoke.py`` helpers
are used (default: the one holding this script), so that two versions of
the kernels compare inside one machine: parent, change, change, parent.
Prints one JSON line per row (device ms per call from torch.profiler, CUDA
events beside it) with the card's ``nvidia-smi`` name and power limit.
"""

import argparse
import json
import os
import sys

import numpy as np

FRONTIERS = [("cart_exact_tuples", 18, 2), ("cart_exact_select:equiv", 3, 2)]
REPS = 10
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_CONFIG = os.path.join(HERE, "benchmark", "configs",
                           "mtb-isoniazid-5022-gui-grid.json")
GRID_SEED = 7
GRID_REPS = 3
GRID_LEAST = 200  # the tuple launches replayed one by one: this many nodes


def matrix_reads(ce, mode, n, c, w):
    """Reads of the matrix a launch's plan makes: ``exact_layout``'s, or
    its grid rows in a checkout whose plan does not count them."""
    lay = ce.exact_layout(mode, [1] * n, c, w)
    if hasattr(lay, "reads"):
        return lay.reads
    return -(-(-(-n // 4)) // lay.gpb)


def grid_rows(torch, cs, card, repo):
    """The grid cell's launches (module docstring)."""
    sys.path.insert(1, os.path.join(HERE, "benchmark"))
    import importlib

    from harness.artifact import SPLIT, make_artifact

    from grm_tpu_torch.dataset import GrmDataset
    from grm_tpu_torch.learning.experiments import learn_CART
    from grm_tpu_torch.ops import cart_exact as ce
    from grm_tpu_torch.parallel import cart_exact as engine

    least_s = importlib.import_module("metrics.cart_exact_roofline").least_s
    device = torch.device("cuda")
    with open(GRID_CONFIG) as f:
        cfg = json.load(f)
    mem, _, _ = make_artifact(cfg, GRID_SEED, device)
    ds = GrmDataset(mem, device=device)
    matrix = ds.bit_matrix().data
    calls = []
    wrapped = {name: getattr(engine, name)
               for name in ("cart_exact_tuples", "cart_exact_select")}

    def recorder(name):
        def call(*args, **kw):
            calls.append((name, args, kw))
            return wrapped[name](*args, **kw)
        return call

    s = cfg["cart"]
    for name in wrapped:
        setattr(engine, name, recorder(name))
    try:
        learn_CART(
            dataset_file=ds, split_name=SPLIT, criterion=[s["criterion"]],
            max_depth=[s["max_depth"]],
            min_samples_split=[s["min_samples_split"]],
            class_importance=[{int(k): float(v) for k, v in ci.items()}
                              for ci in s["class_importance"]],
            bound_delta=s["bound_delta"],
            bound_max_genome_size=ds.kmer_count, parameter_selection="cv",
            engine=s["engine"], device=device)
    finally:
        for name, fn in wrapped.items():
            setattr(engine, name, fn)
    torch.cuda.synchronize()

    def kind(name, args):
        return name if name == "cart_exact_tuples" else \
            "cart_exact_select:" + args[7]

    largest = {}  # each select mode's largest launch
    for i, (name, args, _) in enumerate(calls):
        what = kind(name, args)
        j = largest.get(what)
        if j is None or args[3].shape[0] > calls[j][1][3].shape[0]:
            largest[what] = i
    sums = {}
    w, k_cols = matrix.shape
    for i, (name, args, kw) in enumerate(calls):
        what = kind(name, args)
        fn = getattr(ce, name)
        ms = cs.time_cuda(lambda: fn(*args, **kw), GRID_REPS)
        n, c = args[3].shape
        least = 1e3 * least_s(name == "cart_exact_tuples",
                              tuple(args[0].shape), args[3].cpu().numpy())
        tot = sums.setdefault(what, {"launches": 0, "nodes": 0, "ms": 0.0,
                                     "least_ms": 0.0, "reads": 0})
        mode = "tuples" if name == "cart_exact_tuples" else args[7]
        reads = matrix_reads(ce, mode, n, c, w)
        tot["launches"] += 1
        tot["nodes"] += n
        tot["ms"] += ms
        tot["least_ms"] += least
        tot["reads"] += reads
        if n >= GRID_LEAST if what == "cart_exact_tuples" else \
                largest[what] == i:
            sizes = ce.lattice_sizes(args[3]).cpu().numpy()
            print(json.dumps({
                "repo": repo, "grid": what, "N": n, "C": c, "W": w,
                "K": k_cols, "ms": ms, "least_ms": least,
                "share": least / ms, "matrix_reads": reads,
                "lattice min/median/max": [int(sizes.min()),
                                           float(np.median(sizes)),
                                           int(sizes.max())],
                "card": card}), flush=True)
    for what, tot in sums.items():
        print(json.dumps(dict(tot, repo=repo, grid_job=what,
                              share=tot["least_ms"] / tot["ms"],
                              reads_a_launch=tot["reads"] / tot["launches"],
                              card=card)), flush=True)
    del matrix, ds, mem, calls
    torch.cuda.empty_cache()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=HERE)
    parser.add_argument("--grid-only", action="store_true",
                        help="time the grid cell's launches alone")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_cart_exact: CUDA is not available", file=sys.stderr)
        return 2
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    os.chdir(repo)
    import chip_smoke as cs

    from grm_tpu_torch.dataset import GrmDataset
    from grm_tpu_torch.ops import _build
    from grm_tpu_torch.ops import cart_exact as ce
    from grm_tpu_torch.parallel import cart_exact as engine

    _build.build_all()
    device = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    grid_rows(torch, cs, card, repo)
    if args.grid_only:
        return 0
    mem = cs.build_artifact(cs.MEDIAN_GENOMES, cs.MEDIAN_KMERS, 0, device)
    matrix = GrmDataset(mem, device=device).bit_matrix().data
    torch.cuda.synchronize()

    def row(name, kernel, plain, *bounds_and_shape, compare, key=None,
            **rates):
        # time_exact_kernels passes phase 6's bound inputs; only the shape
        # (the last positional argument) is printed here.
        compare(kernel(), plain())
        ms, timed_by = cs.device_ms(kernel, REPS, cs.KERNEL_FUNCTIONS[name])
        print(json.dumps({"repo": repo, "kernel": key or name,
                          "shape": bounds_and_shape[-1], "ms": ms,
                          "timed_by": timed_by,
                          "event_ms": cs.time_cuda(kernel, REPS),
                          "card": card}), flush=True)

    cs.time_exact_kernels(row, np.random.RandomState(7), matrix, device,
                          FRONTIERS, card)

    lattices, private = [], 0
    tuples = engine.cart_exact_tuples

    def recording(matrix, class_masks, train_masks, n_node, *rest, **kw):
        nonlocal private
        sizes = ce.lattice_sizes(n_node).cpu().numpy()
        lattices.append(sizes)
        lay = ce.exact_layout("tuples", sizes, n_node.shape[1],
                              matrix.shape[0])
        private += int((lay.priv_off >= 0).sum())
        return tuples(matrix, class_masks, train_masks, n_node, *rest, **kw)

    def tree_device():
        cs.learn_tree(mem, "device", device, list(cs.CART_CRITERIA), 10)

    engine.cart_exact_tuples = recording
    try:
        tree_device()
    finally:
        engine.cart_exact_tuples = tuples
    ms, timed_by = cs.device_ms(tree_device, 3,
                                cs.KERNEL_FUNCTIONS["cart_exact_tuples"])
    sizes = np.concatenate(lattices)
    print(json.dumps({
        "repo": repo, "tree-device tuples launches": len(lattices),
        "nodes": int(sizes.size), "tuples ms a run": ms,
        "timed_by": timed_by,
        "nodes with lattice <= %d" % ce.PRIV_LATTICE:
            int((sizes <= ce.PRIV_LATTICE).sum()),
        "nodes with private tables": private,
        "lattice min/median/max": [int(np.min(sizes)),
                                   float(np.median(sizes)),
                                   int(np.max(sizes))],
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
