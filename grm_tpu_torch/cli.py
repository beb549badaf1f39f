"""Command-line interface of the port: ``learn scm`` and ``learn tree``,
with the flags and defaults of ``grm learn scm`` (``grm_tpu/cli.py:332``)
and ``grm learn tree`` (``grm_tpu/cli.py:480``) and a ``--device`` flag that
defaults to ``cuda``.

    python -m grm_tpu_torch learn scm --dataset ds.h5 --split sp [--device cpu]
    python -m grm_tpu_torch learn tree --dataset ds.h5 --split sp \
        --engine device-argmax [--device cpu]

``learn tree`` keeps ``grm learn tree``'s engines and its default: the exact
device engine on the card, ``host`` with ``--device cpu``. The exact CART
engine is not ported yet, so on the card pass ``--engine device-argmax`` or
``--engine host``; ``--engine device`` ends with an error and runs nothing
else in its place.

The other commands of ``grm_tpu.cli`` are still to port (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from time import time

# The reference GUI's default p grid (src/kover.py:183-194; 10 values), the
# default of ``grm learn scm``.
DEFAULT_P = [0.1, 0.178, 0.316, 0.562, 1.0, 1.778, 3.162, 5.623, 10.0,
             999999.0]


def _progress_printer(enabled):
    if not enabled:
        return None
    state = {"task": None}

    def progress(task, p):
        if task != state["task"]:
            state["task"] = task
            sys.stdout.write("\n%s: " % task)
        sys.stdout.write("\r%s: %5.1f%%" % (task, 100.0 * p))
        sys.stdout.flush()

    return progress


def _cmd_learn_scm(argv):
    parser = argparse.ArgumentParser(
        prog="python -m grm_tpu_torch learn scm",
        description="Learn a conjunction/disjunction model using the Set "
                    "Covering Machine algorithm.",
    )
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--split", required=True)
    parser.add_argument("--model-type", choices=["conjunction", "disjunction"],
                        nargs="+", default=["conjunction", "disjunction"])
    parser.add_argument("--p", type=float, nargs="+", default=DEFAULT_P)
    parser.add_argument("--kmer-blacklist")
    parser.add_argument("--max-rules", type=int, default=10)
    parser.add_argument("--max-equiv-rules", type=int, default=10000)
    parser.add_argument("--hp-choice", choices=["bound", "cv", "none"], default="cv")
    parser.add_argument("--bound-max-genome-size", type=int)
    parser.add_argument("--random-seed", type=int)
    parser.add_argument("--n-cpu", "--n-cores", type=int, default=1)
    parser.add_argument("--engine",
                        choices=["host", "device", "device-argmax"],
                        default="device",
                        help="host = reference selection on the host; "
                             "device = exact device engine (bit-identical "
                             "to host; the default); device-argmax = "
                             "fastest CV, lowest-index tie resolution.")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; fails without CUDA) or cpu "
                             "(plain PyTorch versions of the kernels).")
    parser.add_argument("--output-dir", default=".")
    parser.add_argument("-x", "--progress", action="store_true")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--authorized-rules", type=str, default="",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.verbose:
        logging.basicConfig(level=logging.DEBUG)
    progress = _progress_printer(args.progress)

    from .dataset import GrmDataset
    from .learning.experiments import learn_SCM
    from .reports import write_scm_outputs

    pre = GrmDataset(args.dataset, device=args.device)
    if pre.classification_type != "binary":
        print("Error: The SCM cannot learn a multi-class classifier")
        sys.exit(1)
    try:
        split = pre.get_split(args.split)
    except KeyError:
        print("Error: The split (%s) does not exist in the dataset. Use 'grm "
              "dataset split' to create it." % args.split)
        sys.exit(1)
    if args.hp_choice == "cv" and len(split.folds) < 2:
        print("Error: The split must contain at least 2 folds in order to "
              "perform cross-validation. Use 'grm dataset split' to create folds.")
        sys.exit(1)

    args.bound_delta = 0.05  # fixed, as in the reference (kover:552)
    bound_max_genome_size = (
        args.bound_max_genome_size
        if args.bound_max_genome_size is not None
        else pre.kmer_count
    )

    start = time()
    (best_hp, best_hp_score, train_metrics, test_metrics, model,
     rule_importances, equivalent_rules, classifications) = learn_SCM(
        dataset_file=args.dataset,
        split_name=args.split,
        model_type=args.model_type,
        p=args.p,
        kmer_blacklist_file=os.path.abspath(args.kmer_blacklist)
        if args.kmer_blacklist else None,
        max_rules=args.max_rules,
        max_equiv_rules=args.max_equiv_rules,
        bound_delta=args.bound_delta,
        bound_max_genome_size=bound_max_genome_size,
        parameter_selection=args.hp_choice,
        n_cpu=args.n_cpu,
        random_seed=args.random_seed,
        authorized_rules=args.authorized_rules,
        engine=args.engine,
        progress_callback=progress,
        device=args.device,
    )
    running_time = time() - start
    if args.progress:
        print()

    report = write_scm_outputs(
        output_dir=args.output_dir, dataset=pre,
        split_name=args.split, config=vars(args), best_hp=best_hp,
        best_hp_score=best_hp_score, train_metrics=train_metrics,
        test_metrics=test_metrics, model=model,
        rule_importances=rule_importances, equivalent_rules=equivalent_rules,
        classifications=classifications, running_time_seconds=running_time,
    )
    print(report)


def _parse_class_importances(class_importance_input, phenotype_tags):
    """Class-importance grammar 'class1: v1 v2 class2: ...' (kover:783-859)."""
    from collections import defaultdict
    from itertools import product as iproduct

    for class_name in phenotype_tags:
        if (class_name + ":") not in class_importance_input:
            print('Error: no class importances defined for class "%s" which is '
                  "in the dataset." % class_name)
            sys.exit(1)
    for class_name in [x[:-1] for x in class_importance_input if x.endswith(":")]:
        if class_name not in phenotype_tags:
            print('Error: unknown class "%s" in class importances.' % class_name)
            sys.exit(1)
    for i in range(len(class_importance_input)):
        if class_importance_input[i].endswith(":"):
            if (i + 1 >= len(class_importance_input)
                    or class_importance_input[i + 1].endswith(":")):
                print("Error: no class importances defined for class %s which "
                      "is in the dataset." % class_importance_input[i][:-1])
                sys.exit(1)
    for v in class_importance_input:
        if not v.endswith(":"):
            try:
                float(v)
            except ValueError:
                print('Error: invalid value "%s" encountered in class importances.' % v)
                sys.exit(1)

    class_importances = defaultdict(list)
    current_class = None
    for v in class_importance_input:
        if v.endswith(":"):
            current_class = v[:-1]
        else:
            class_importances[phenotype_tags.index(current_class)].append(float(v))
    grid_classes = list(class_importances.keys())
    grid = iproduct(*class_importances.values())
    return [
        {c: importance for c, importance in zip(grid_classes, row)} for row in grid
    ]


def _cmd_learn_tree(argv):
    parser = argparse.ArgumentParser(
        prog="python -m grm_tpu_torch learn tree",
        description="Learn a decision tree model using the Classification And "
                    "Regression Trees algorithm.",
    )
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--split", required=True)
    parser.add_argument("--criterion", type=str, nargs="+",
                        choices=["gini", "crossentropy", "cross-entropy"],
                        default=["gini"])
    parser.add_argument("--max-depth", type=int, nargs="+", default=[10])
    parser.add_argument("--min-samples-split", type=int, nargs="+", default=[2])
    parser.add_argument("--class-importance", type=str, nargs="+", default=None)
    parser.add_argument("--kmer-blacklist")
    parser.add_argument("--hp-choice", choices=["bound", "cv"], default="cv")
    parser.add_argument("--bound-max-genome-size", type=int)
    parser.add_argument("--n-cpu", "--n-cores", type=int, default=1)
    parser.add_argument("--engine",
                        choices=["host", "device", "device-argmax"],
                        default=None,
                        help="host = reference split selection on the host; "
                             "device = exact device engine (not ported yet: "
                             "ends with an error); device-argmax = frontier "
                             "scoring on the device, lowest-column tie "
                             "resolution. Default: device on cuda, host "
                             "with --device cpu.")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; fails without CUDA) or cpu "
                             "(plain PyTorch versions of the kernels).")
    parser.add_argument("--output-dir", default=".")
    parser.add_argument("-x", "--progress", action="store_true")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--authorized-rules", type=str, default="",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.engine is None:
        args.engine = "host" if args.device == "cpu" else "device"
    if args.verbose:
        logging.basicConfig(level=logging.DEBUG)
    progress = _progress_printer(args.progress)

    from .dataset import GrmDataset
    from .learning.cart import EXACT_ENGINE_MESSAGE
    from .learning.experiments import learn_CART
    from .reports import write_cart_outputs

    if args.engine == "device":
        print("Error: %s." % EXACT_ENGINE_MESSAGE)
        sys.exit(1)
    pre = GrmDataset(args.dataset, device=args.device)
    try:
        split = pre.get_split(args.split)
    except KeyError:
        print("Error: The split (%s) does not exist in the dataset. Use 'grm "
              "dataset split' to create it." % args.split)
        sys.exit(1)
    if args.hp_choice == "cv" and len(split.folds) < 2:
        print("Error: The split must contain at least 2 folds in order to "
              "perform cross-validation. Use 'grm dataset split' to create folds.")
        sys.exit(1)

    phenotype_tags = [str(t) for t in pre.phenotype.tags]

    # normalize the reference's 'crossentropy' spelling to the learner's name
    criterion = ["cross-entropy" if c == "crossentropy" else c for c in args.criterion]

    if args.class_importance:
        if args.class_importance[0].endswith(":"):
            class_importances = _parse_class_importances(
                args.class_importance, phenotype_tags)
        else:
            tmp = []
            for c in phenotype_tags:
                tmp.append(c + ":")
                tmp += args.class_importance
            class_importances = _parse_class_importances(tmp, phenotype_tags)
    else:
        class_importances = [{c: 1.0 for c in range(len(phenotype_tags))}]

    args.bound_delta = 0.05
    bound_max_genome_size = (
        args.bound_max_genome_size
        if args.bound_max_genome_size is not None
        else pre.kmer_count
    )

    start = time()
    (best_hp, best_hp_score, train_metrics, test_metrics, model,
     rule_importances, equivalent_rules, classifications) = learn_CART(
        dataset_file=args.dataset,
        split_name=args.split,
        criterion=criterion,
        max_depth=args.max_depth,
        min_samples_split=args.min_samples_split,
        class_importance=class_importances,
        bound_delta=args.bound_delta,
        bound_max_genome_size=bound_max_genome_size,
        kmer_blacklist_file=os.path.abspath(args.kmer_blacklist)
        if args.kmer_blacklist else None,
        parameter_selection=args.hp_choice,
        authorized_rules=args.authorized_rules,
        n_cpu=args.n_cpu,
        engine=args.engine,
        progress_callback=progress,
        device=args.device,
    )
    running_time = time() - start
    if args.progress:
        print()

    config = dict(vars(args))
    config["bound_max_genome_size"] = bound_max_genome_size
    report = write_cart_outputs(
        output_dir=args.output_dir, dataset=pre,
        split_name=args.split, config=config, best_hp=best_hp,
        best_hp_score=best_hp_score, train_metrics=train_metrics,
        test_metrics=test_metrics, model=model,
        rule_importances=rule_importances, equivalent_rules=equivalent_rules,
        classifications=classifications, running_time_seconds=running_time,
        classification_type=pre.classification_type,
    )
    print(report)


_COMMANDS = {
    ("learn", "scm"): _cmd_learn_scm,
    ("learn", "tree"): _cmd_learn_tree,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    top = argparse.ArgumentParser(
        prog="python -m grm_tpu_torch",
        description="GRM on PyTorch and CUDA: interpretable AMR rule learning.",
    )
    top.add_argument("command", choices=sorted({c for c, _ in _COMMANDS}))
    top.add_argument("subcommand", choices=sorted({s for _, s in _COMMANDS}))
    if len(argv) < 2 or (argv[0], argv[1]) not in _COMMANDS:
        top.parse_args(argv[:2] or ["-h"])
        return
    _COMMANDS[(argv[0], argv[1])](argv[2:])


if __name__ == "__main__":
    main()
