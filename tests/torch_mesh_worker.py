"""One process of the port's multi-process mesh tests: it joins a gloo
group through a file store, runs the cases its spec names on a mesh that
spans the group's processes (each process naming the CPU several times as
its devices), and pickles each case's outputs for the test to compare.

Run as ``python tests/torch_mesh_worker.py SPEC RANK``; SPEC is a JSON
file: ``store`` (a ``file://`` URL), ``world``, ``local_devices``,
``timeout`` (seconds a collective may wait), ``inputs`` (a pickle the test
wrote), ``cases``, ``out`` (a path prefix) and, for the fault cases,
``fault``. A failure writes ``GRM_FAULT: <message>`` to standard error and
exits 3 at once (the group's shutdown would wait on a dead peer). This
module imports no JAX: the test process holds ``grm_tpu``'s side.
"""

import json
import os
import pickle
import sys

import torch

from grm_tpu_torch.ops.popcount import BitMatrix
from grm_tpu_torch.parallel import mesh as tmesh
from grm_tpu_torch.parallel.cart_device import cart_frontier_splits_sharded
from grm_tpu_torch.parallel.distributed import initialize
from grm_tpu_torch.parallel.scm_device import scm_cv_batch_device
from grm_tpu_torch.parallel.scm_grid import scm_cv_grid_sharded

CRITERIA = ("gini", "cross-entropy")


def _mesh(spec, n_devices=None, row_devices=1):
    return tmesh.make_mesh(
        n_devices, row_devices=row_devices,
        devices=[torch.device("cpu")] * spec["local_devices"])


def _held(matrix):
    """The positions whose shards this process holds, and the words it
    holds: the memory check's evidence."""
    return {"positions": [(r, c) for r, c, _ in matrix.local_positions()],
            "none": sum(t is None for row in matrix.shards for t in row),
            "words": sum(t.numel() for _, _, t in matrix.local_positions()),
            "owners": matrix.mesh.owners}


def case_grid(spec, rank, inp):
    """scm_cv_grid_sharded on a (1, all devices) mesh, with and without
    the blacklist."""
    mesh = _mesh(spec)
    out = {}
    for name, excl in (("plain", None), ("blacklist", inp["grid_excl"])):
        out[name] = scm_cv_grid_sharded(inp["packed"], inp["fits"],
                                        inp["n_kmers"], inp["max_rules"],
                                        mesh, excl_rules=excl)
    out["held"] = _held(tmesh.MeshSharding(mesh).place(inp["packed"]))
    return out


def case_cart(spec, rank, inp):
    """cart_frontier_splits_sharded for both criteria, on a matrix loaded
    on the mesh, with and without the column blacklist."""
    mesh = _mesh(spec)
    bm = BitMatrix(inp["packed"], inp["n_genomes"],
                   columns_sharding=tmesh.MeshSharding(mesh))
    return {(crit, excl is not None): cart_frontier_splits_sharded(
        bm, inp["node_sets"], inp["priors"], inp["totals"], crit, mesh,
        excl=excl)
        for crit in CRITERIA for excl in (None, inp["cart_excl"])}


def case_rows(spec, rank, inp):
    """On a (2, 4) mesh, whose both axes cross the processes:
    scm_device_step three times, sharded_presence_counts and the scan
    engine; then the column-shard engines' refusal."""
    mesh = _mesh(spec, row_devices=2)
    matrix, k = tmesh.shard_bit_matrix(inp["packed"], mesh)
    pos, neg = inp["pos_mask"], inp["neg_mask"]
    steps = []
    for _ in range(3):
        best, util, pos, neg, n_neg = tmesh.scm_device_step(
            matrix, pos, neg, 1.0, k)
        steps.append((int(best), float(util), int(n_neg)))
        if int(n_neg) == 0:
            break
    counts = tmesh.sharded_presence_counts(matrix, inp["count_masks"], mesh)
    scan = scm_cv_batch_device(matrix, inp["row_fits"], inp["n_kmers"],
                               inp["max_rules"])
    try:
        matrix.column_shards()
        refusal = None
    except ValueError as e:
        refusal = str(e)
    return {"steps": steps, "counts": counts, "scan": scan,
            "held": _held(matrix), "refusal": refusal}


def case_learn(spec, rank, inp):
    """learn_SCM and learn_CART through both device engines on a (1, all
    devices) mesh: each learn's outputs, and its report files written into
    this process's own directory; then the shards the artifact's load
    holds."""
    from grm_tpu_torch.dataset import GrmDataset
    from grm_tpu_torch.learning.experiments import learn_CART, learn_SCM
    from grm_tpu_torch.reports import write_cart_outputs, write_scm_outputs

    mesh = _mesh(spec)
    out = {}
    for engine in ("device", "device-argmax"):
        for what, learner, kwargs, writer in (
                ("scm", learn_SCM, inp["scm_kwargs"], write_scm_outputs),
                ("cart", learn_CART, inp["cart_kwargs"], write_cart_outputs)):
            path = inp[what + "_path"]
            res = learner(dataset_file=path, engine=engine, mesh=mesh,
                          device="cpu", **kwargs)
            out[(what, engine)] = res
            reports = os.path.join(inp["reports"], "rank%d" % rank,
                                   "%s-%s" % (what, engine))
            (best_hp, best_hp_score, train_m, test_m, model, imps, equiv,
             cls) = res
            more = ({"classification_type": "binary"} if what == "cart"
                    else {})
            writer(output_dir=reports, dataset=GrmDataset(path, device="cpu"),
                   split_name="sp", config={"engine": engine},
                   best_hp=best_hp, best_hp_score=best_hp_score,
                   train_metrics=train_m, test_metrics=test_m, model=model,
                   rule_importances=imps, equivalent_rules=equiv,
                   classifications=cls, running_time_seconds=0.0, **more)
    ds = GrmDataset(inp["scm_path"], device="cpu")
    out["held"] = _held(ds.bit_matrix(tmesh.MeshSharding(mesh)).data)
    return out


def case_train(spec, rank, inp):
    """train_scm over a (1, all devices) mesh on an in-memory dataset of
    the k-mer matrix the test built: its rules, split and metrics."""
    from grm_tpu_torch.pipeline import InMemoryDataset, train_scm

    ds = InMemoryDataset(inp["km"], inp["labels"], device="cpu")
    out = {}
    for model_type, p, seed in inp["train_runs"]:
        r = train_scm(ds, model_type=model_type, p=p, max_rules=4,
                      random_seed=seed, mesh=_mesh(spec))
        out[model_type] = ([str(x) for x in r.rules],
                           [str(x) for x in r.model.rules],
                           r.train_idx.tolist(), r.test_idx.tolist(),
                           repr(r.train_metrics), repr(r.test_metrics))
    return out


def case_fault(spec, rank, inp):
    """A rank that disagrees on its fits or on the matrix's shape, or that
    dies before the first collective after the mesh is made."""
    mesh = _mesh(spec)
    fits, packed = inp["fits"], inp["packed"]
    if rank == 1:
        if spec["fault"] == "fits":
            fits = [dict(f, p=f["p"] * 2) for f in fits]
        elif spec["fault"] == "shape":
            packed = packed[:, :-1]
        elif spec["fault"] == "dead":
            os._exit(4)
    return scm_cv_grid_sharded(packed, fits, inp["n_kmers"],
                               inp["max_rules"], mesh)


CASES = {"grid": case_grid, "cart": case_cart, "rows": case_rows,
         "learn": case_learn, "train": case_train, "fault": case_fault}


def main(spec_path, rank):
    with open(spec_path) as f:
        spec = json.load(f)
    with open(spec["inputs"], "rb") as f:
        inp = pickle.load(f)  # written by the test that started this worker
    initialize(spec["store"], spec["world"], rank, timeout=spec["timeout"])
    try:
        out = {case: CASES[case](spec, rank, inp) for case in spec["cases"]}
    except Exception as e:  # a faulted worker must not wait on its peers
        sys.stderr.write("GRM_FAULT: %s: %s\n" % (type(e).__name__, e))
        sys.stderr.flush()
        os._exit(3)
    with open("%s%d.pkl" % (spec["out"], rank), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
