#!/usr/bin/env python3
"""Run the port's meshes that span processes on one NVIDIA GPU, apart from
the rest of ``chip_smoke.py``: phase 4's process-spanning cases
(``grm_tpu``'s two multi-process yardsticks at 60 genomes x 517 k-mers
over two and four gloo processes, and a mismatched rank), then phase 5's
``*-procs`` paths at the published median (342 genomes x 9,600,000
k-mers, built in memory from seed 0): the four resident device paths are
learned unsharded and on a (1, 4) mesh of cuda:0 in this process, for
their fingerprints and launch counts, and then by two processes on a
(1, 4) mesh that spans them (``chip_smoke.run_mesh_procs``), which must
give the same fingerprints and the same launch sums.

    python3 scripts/time_mesh_procs.py

Prints each process's start, load (and the same load again from the
touched mapping), peak device bytes, each path's walls (a first and a
second run), launches and collectives, with the card's ``nvidia-smi``
name and power limit; the last line is the launches of the ``*-procs``
paths as JSON. Exits 1 where a check fails, 2 without CUDA.
"""

import json
import os
import sys
import time


def main():
    import torch

    if not torch.cuda.is_available():
        print("time_mesh_procs: CUDA is not available", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke as cs

    from grm_tpu_torch.dataset import GrmDataset
    from grm_tpu_torch.ops import _build
    from grm_tpu_torch.parallel.mesh import MeshSharding

    t_start = time.time()
    device = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    cs.log("card: %s" % card)
    t0 = time.time()
    _build.build_all()
    cs.log("built in %.1f s" % (time.time() - t0))
    t0 = time.time()
    for line in cs.check_mesh_procs_small(device, 0):
        cs.log("mesh across processes: %s" % line)
    cs.log("meshes across processes checked in %.1f s" % (time.time() - t0))
    t0 = time.time()
    mem = cs.build_artifact(cs.MEDIAN_GENOMES, cs.MEDIAN_KMERS, 0, device)
    cs.log("artifact %dx%d built in %.1f s (set-up)"
           % (cs.MEDIAN_GENOMES, cs.MEDIAN_KMERS, time.time() - t0))
    fingerprints, walls, paths = {}, {}, {}
    mesh = cs.card_mesh(device, cs.MESH_CARDS)
    for path in cs.SHARDED_PATHS:
        for on, name in ((None, path), (mesh, path + "-sharded")):
            ds = GrmDataset(mem, device=device)
            _build.reset_launches()
            t0 = time.time()
            ds.bit_matrix(sharding=None if on is None else MeshSharding(on))
            if path.startswith("tree-"):
                fingerprints[name] = cs.tree_fingerprint(cs.learn_tree(
                    ds, path[len("tree-"):], device, list(cs.CART_CRITERIA),
                    10, on))
            else:
                fingerprints[name] = cs.fingerprint(cs.learn(ds, path, device,
                                                             on))
            torch.cuda.synchronize()
            walls[name] = time.time() - t0
            paths[name] = dict(_build.launches)
            del ds
        if fingerprints[path] != fingerprints[path + "-sharded"]:
            raise AssertionError("%s-sharded learned another model" % path)
        cs.log("%s (%s): %.2f s unsharded, %.2f s on (1, %d) of cuda:0"
               % (path, card, walls[path], walls[path + "-sharded"],
                  cs.MESH_CARDS))
    cs.run_mesh_procs(mem, torch.device("cuda", 0), fingerprints, walls,
                      paths, card)
    cs.log("time_mesh_procs: %.1f s in all" % (time.time() - t_start))
    print(json.dumps({k: {kk: v for kk, v in paths[k].items() if v}
                      for k in paths if k.endswith("-procs")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
