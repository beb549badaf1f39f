#!/usr/bin/env python3
"""Time the exact CART kernels (``cart_exact_tuples``, ``cart_exact_select``)
of one checkout on one NVIDIA GPU at ``chip_smoke.py`` phase 6's shapes:
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

    python3 scripts/time_cart_exact.py [--repo DIR]

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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
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
