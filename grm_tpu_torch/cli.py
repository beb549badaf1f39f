"""Command-line interface of the port (port of ``grm_tpu/cli.py``): the
commands below, with the flags, messages and exit codes of ``grm``'s and a
``--device`` flag that defaults to ``cuda`` (and fails without CUDA;
``--device cpu`` runs the kernels' plain PyTorch versions).

    python -m grm_tpu_torch dataset create from-contigs|from-reads|from-tsv ...
    python -m grm_tpu_torch dataset split --dataset ds.h5 --id sp ...
    python -m grm_tpu_torch dataset info --dataset ds.h5 --all
    python -m grm_tpu_torch learn scm --dataset ds.h5 --split sp
    python -m grm_tpu_torch learn tree --dataset ds.h5 --split sp
    python -m grm_tpu_torch kmer count --genome g.fna --out g.tsv
    python -m grm_tpu_torch kmer matrix --genome-dir dir --out m.tsv

``dataset create`` (``grm_tpu/cli.py:91``) counts each genome's k-mers on
the device and merges the union on the host; ``kmer count`` / ``kmer
matrix`` (:607, :626) likewise. ``learn scm`` and ``learn tree`` (:332,
:480) keep the reference's engines and its default: the exact device engine
(``--engine device``) on the card, ``host`` with ``--device cpu``, as
``grm`` picks ``host`` on a CPU backend; ``--engine device --device cpu``
runs the exact engine's plain PyTorch versions. ``collect``, ``results``
and ``settings`` are still to port (ROADMAP.md).
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


def _device_flag(parser):
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; fails without CUDA) or cpu "
                             "(plain PyTorch versions of the kernels).")


# ---------------------------------------------------------------------------
# dataset commands
# ---------------------------------------------------------------------------
def _cmd_dataset_create(argv):
    parser = argparse.ArgumentParser(
        prog="python -m grm_tpu_torch dataset create",
        description="Creates a dataset from genomic data and optionally phenotypic metadata.",
    )
    sub = parser.add_subparsers(dest="source", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--output", required=True)
    common.add_argument("--phenotype-description")
    common.add_argument("--phenotype-metadata")
    common.add_argument("--compression", type=int, default=4,
                        help="gzip compression level (0-9)")
    _device_flag(common)
    common.add_argument("-x", "--progress", action="store_true")
    common.add_argument("-v", "--verbose", action="store_true")

    p_tsv = sub.add_parser("from-tsv", parents=[common])
    p_tsv.add_argument("--genomic-data", required=True)

    p_contigs = sub.add_parser("from-contigs", parents=[common])
    p_contigs.add_argument("--genomic-data", required=True)
    p_contigs.add_argument("--kmer-size", type=int, default=31)
    p_contigs.add_argument("--singleton-kmers", action="store_true",
                           help="Include k-mers that occur in only one genome "
                                "(disables the singleton filter).")
    p_contigs.add_argument("--n-cpu", "--n-cores", type=int, default=0,
                           help="Cores used for the union merge; 0 = all "
                                "(reference kover:117).")
    p_contigs.add_argument("--temp-dir", default=None,
                           help="Accepted for reference compatibility "
                                "(kover:121); the in-process pipeline writes "
                                "no temporary files.")

    p_reads = sub.add_parser("from-reads", parents=[common])
    p_reads.add_argument("--genomic-data", required=True)
    p_reads.add_argument("--kmer-size", type=int, default=31)
    p_reads.add_argument("--kmer-min-abundance", "--abundance-min",
                         dest="abundance_min", type=int, default=1,
                         help="Minimum k-mer occurrences in a genome's reads "
                              "(reference kover:174).")
    p_reads.add_argument("--singleton-kmers", action="store_true")
    p_reads.add_argument("--n-cpu", "--n-cores", type=int, default=0,
                         help="Cores used for the union merge; 0 = all.")
    p_reads.add_argument("--temp-dir", default=None,
                         help="Accepted for reference compatibility; unused.")

    args = parser.parse_args(argv)
    if args.verbose:
        logging.basicConfig(level=logging.DEBUG)
    progress = _progress_printer(args.progress)

    # Directory convenience (the GUI's create_contigs_path_tsv role,
    # src/kover.py:40-49): a directory of genome files stands in for the
    # genome-id -> path TSV, ids = file stems, sorted for determinism.
    # FASTA files (gzipped too) for from-contigs; FASTQ files or per-genome
    # subdirectories for from-reads.
    if (args.source in ("from-contigs", "from-reads")
            and os.path.isdir(args.genomic_data)):
        from .kmer.counter import FASTA_EXTENSIONS, READS_EXTENSIONS

        if args.source == "from-contigs":
            exts = FASTA_EXTENSIONS
        else:
            exts = READS_EXTENSIONS
        entries = sorted(
            f for f in os.listdir(args.genomic_data)
            if f.endswith(exts)
            or (args.source == "from-reads"
                and os.path.isdir(os.path.join(args.genomic_data, f)))
        )
        if not entries:
            print("Error: no %s found in %s."
                  % ("FASTA files (%s)" % "/".join(FASTA_EXTENSIONS)
                     if args.source == "from-contigs"
                     else "FASTQ files or per-genome read directories",
                     args.genomic_data))
            sys.exit(1)
        # Written beside the output dataset (never into the possibly
        # read-only input directory, never over a user's own TSV).
        tsv_path = args.output + ".paths.tsv"
        stems = {}
        for name in entries:
            stem = name
            for ext in sorted(exts, key=len, reverse=True):
                if stem.endswith(ext):
                    stem = stem[: -len(ext)]
                    break
            if stem in stems:
                print("Error: duplicate genome id %r (%s and %s); rename "
                      "one or provide an explicit TSV."
                      % (stem, stems[stem], name))
                sys.exit(1)
            stems[stem] = name
        with open(tsv_path, "w") as f:
            for stem, name in stems.items():
                f.write("%s\t%s\n"
                        % (stem, os.path.join(args.genomic_data, name)))
        args.genomic_data = tsv_path

    from .dataset import from_contigs, from_reads, from_tsv

    if (args.phenotype_description is None) != (args.phenotype_metadata is None):
        print("Error: The phenotype description and metadata file must be "
              "specified simultaneously.")
        sys.exit(1)

    if args.source == "from-tsv":
        from_tsv(args.genomic_data, args.output,
                 phenotype_description=args.phenotype_description,
                 phenotype_metadata_path=args.phenotype_metadata,
                 gzip=args.compression, progress_callback=progress,
                 device=args.device)
    elif args.source == "from-contigs":
        from_contigs(args.genomic_data, args.output, kmer_size=args.kmer_size,
                     filter_singleton=not args.singleton_kmers,
                     phenotype_description=args.phenotype_description,
                     phenotype_metadata_path=args.phenotype_metadata,
                     gzip=args.compression, n_cpu=args.n_cpu,
                     progress_callback=progress, device=args.device)
    else:
        from_reads(args.genomic_data, args.output, kmer_size=args.kmer_size,
                   abundance_min=args.abundance_min,
                   filter_singleton=not args.singleton_kmers,
                   phenotype_description=args.phenotype_description,
                   phenotype_metadata_path=args.phenotype_metadata,
                   gzip=args.compression, n_cpu=args.n_cpu,
                   progress_callback=progress, device=args.device)
    if args.progress:
        print()


def _cmd_dataset_split(argv):
    parser = argparse.ArgumentParser(
        prog="python -m grm_tpu_torch dataset split",
        description="Splits a dataset file into a training set, a testing set "
                    "and optionally cross-validation folds",
    )
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--id", required=True)
    parser.add_argument("--train-size", type=float, default=0.5)
    parser.add_argument("--train-ids")
    parser.add_argument("--test-ids")
    parser.add_argument("--folds", type=int, default=0)
    parser.add_argument("--random-seed", type=int)
    _device_flag(parser)
    parser.add_argument("-x", "--progress", action="store_true")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    if args.folds == 1:
        print("Error: The number of cross-validation folds must be 0 or >= 2.")
        sys.exit(1)
    if (args.train_ids is None) != (args.test_ids is None):
        print("Error: Training and testing genome identifiers must be specified simultaneously.")
        sys.exit(1)
    if args.verbose:
        logging.basicConfig(level=logging.DEBUG)
    if args.random_seed is None:
        from random import randint

        args.random_seed = randint(0, 4294967295)
    progress = _progress_printer(args.progress)

    from .dataset.split import split_with_ids, split_with_proportion

    if args.train_ids is not None:
        split_with_ids(args.dataset, args.id, args.train_ids, args.test_ids,
                       args.random_seed, args.folds,
                       progress_callback=progress, device=args.device)
    else:
        split_with_proportion(args.dataset, args.id, args.train_size,
                              args.random_seed, args.folds,
                              progress_callback=progress, device=args.device)
    if args.progress:
        print()


def _cmd_dataset_info(argv):
    parser = argparse.ArgumentParser(
        prog="python -m grm_tpu_torch dataset info",
        description="Prints information about the content of a dataset",
    )
    parser.add_argument("--dataset", required=True)
    for flag in ["all", "genome-type", "genome-source", "genome-ids",
                 "genome-count", "kmers", "kmer-len", "kmer-count",
                 "phenotype-description", "phenotype-metadata", "phenotype-tags",
                 "splits", "uuid", "compression", "classification-type"]:
        parser.add_argument("--" + flag, action="store_true")
    _device_flag(parser)
    args = parser.parse_args(argv)

    from .dataset import GrmDataset

    ds = GrmDataset(args.dataset, device=args.device)
    if args.genome_type or args.all:
        print("Genome type:", ds.genome_source_type, end="\n\n")
    if args.genome_source or args.all:
        print("Genome source:", ds.genome_source, end="\n\n")
    if args.genome_ids or args.all:
        print("Genome IDs:")
        for gid in ds.genome_identifiers:
            print(gid)
        print()
    if args.genome_count or args.all:
        print("Genome count:", ds.genome_count, end="\n\n")
    if args.kmers or args.all:
        print("Kmer sequences (fasta):")
        for i, k in enumerate(ds.kmer_sequences):
            print(">k%d" % (i + 1))
            print(k.decode() if isinstance(k, bytes) else k)
        print()
    if args.kmer_len or args.all:
        print("K-mer length:", ds.kmer_length, end="\n\n")
    if args.kmer_count or args.all:
        print("K-mer count:", ds.kmer_count, end="\n\n")
    if args.phenotype_description or args.all:
        print("Phenotype description:", ds.phenotype.description, end="\n\n")
    if args.phenotype_metadata or args.all:
        if ds.phenotype.description != "NA":
            print("Phenotype metadata source:", ds.phenotype.metadata_source, end="\n\n")
        else:
            print("No phenotype metadata.", end="\n\n")
    if args.phenotype_tags or args.all:
        print("Phenotype tags: ", ", ".join(str(t) for t in ds.phenotype.tags), end="\n\n")
    if args.splits or args.all:
        splits = ds.splits
        if splits:
            print("The following splits are available for learning:")
            for split in splits:
                print(split)
        else:
            print("There are no splits available for learning.")
        print()
    if args.uuid or args.all:
        print("UUID:", ds.uuid, end="\n\n")
    if args.compression or args.all:
        print("Compression:", ds.compression, end="\n\n")
    if args.classification_type or args.all:
        print("Classification type:", ds.classification_type, end="\n\n")


# ---------------------------------------------------------------------------
# learn commands
# ---------------------------------------------------------------------------
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
                        default=None,
                        help="host = reference selection on the host; "
                             "device = exact device engine (bit-identical "
                             "to host); device-argmax = fastest CV, "
                             "lowest-index tie resolution. Default: device "
                             "on cuda, host with --device cpu.")
    _device_flag(parser)
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
                             "device = exact device engine (bit-identical "
                             "to host); device-argmax = frontier scoring on "
                             "the device, lowest-column tie resolution. "
                             "Default: device on cuda, host with --device "
                             "cpu.")
    _device_flag(parser)
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
    from .learning.experiments import learn_CART
    from .reports import write_cart_outputs

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


# ---------------------------------------------------------------------------
# kmer commands (DSK / Ray Surveyor equivalents)
# ---------------------------------------------------------------------------
def _cmd_kmer_count(argv):
    parser = argparse.ArgumentParser(
        prog="python -m grm_tpu_torch kmer count",
        description="Count canonical k-mers of one genome (DSK equivalent); "
                    "writes a kmer<TAB>count TSV.",
    )
    parser.add_argument("--genome", required=True, help="FASTA file (.fna/.fa[.gz])")
    parser.add_argument("--kmer-size", type=int, default=31)
    parser.add_argument("--out", required=True)
    _device_flag(parser)
    args = parser.parse_args(argv)

    from .kmer.counter import count_fasta
    from .kmer.matrix import counts_to_tsv

    g = count_fasta(args.genome, args.kmer_size, keep_counts=True,
                    device=args.device)
    counts_to_tsv(g, args.out)
    print("%d distinct canonical %d-mers -> %s" % (g.n_kmers, args.kmer_size, args.out))


def _cmd_kmer_matrix(argv):
    parser = argparse.ArgumentParser(
        prog="python -m grm_tpu_torch kmer matrix",
        description="Build the genome x k-mer presence matrix over a set of "
                    "genomes (Ray Surveyor equivalent); writes a presence TSV.",
    )
    parser.add_argument("--genome-dir", help="Directory of .fna/.fasta files")
    parser.add_argument("--genome-list",
                        help="Two-column file: genome_id <tab> fasta_path")
    parser.add_argument("--reads-list",
                        help="Two-column file: genome_id <tab> fastq_dir "
                             "(reads mode; pairs with --kmer-min-abundance)")
    parser.add_argument("--survey-conf",
                        help="Ray Surveyor survey.conf (the reference's "
                             "generated config, src/app.py:3812-3835): takes "
                             "k and the genome list from the file; --out "
                             "defaults to the conf's -output path + "
                             "'.kmer_matrix.tsv'.")
    parser.add_argument("--kmer-size", type=int, default=21)
    parser.add_argument("--kmer-min-abundance", "--abundance-min",
                        dest="abundance_min", type=int, default=1,
                        help="Reads mode: drop k-mers seen fewer times in a "
                             "genome's reads (multidsk -abundance-min).")
    parser.add_argument("--filter-singleton", action="store_true")
    parser.add_argument("--n-cpu", "--n-cores", type=int, default=0)
    parser.add_argument("--out")
    _device_flag(parser)
    args = parser.parse_args(argv)

    from .kmer.counter import count_fasta_many, count_reads_many
    from .kmer.matrix import (build_presence_matrix, matrix_to_tsv,
                              parse_survey_conf)

    # Normalize empty strings so source counting and dispatch agree.
    for attr in ("genome_dir", "genome_list", "reads_list", "survey_conf"):
        if getattr(args, attr) == "":
            setattr(args, attr, None)
    n_sources = sum(
        x is not None
        for x in (args.genome_dir, args.genome_list, args.reads_list,
                  args.survey_conf)
    )
    if n_sources != 1:
        print("Error: specify exactly one of --genome-dir / --genome-list / "
              "--reads-list / --survey-conf.")
        sys.exit(1)
    if args.survey_conf:
        try:
            args.kmer_size, conf_pairs, conf_output = parse_survey_conf(
                args.survey_conf
            )
        except (OSError, ValueError) as e:
            print("Error: cannot read survey.conf: %s" % e)
            sys.exit(1)
        if args.out is None and conf_output:
            args.out = conf_output + ".kmer_matrix.tsv"
    if args.out is None:
        print("Error: --out is required (or a survey.conf with -output).")
        sys.exit(1)

    n_cpu = args.n_cpu or None
    if args.reads_list:
        with open(args.reads_list) as fh:
            pairs = [tuple(l.split()) for l in fh if l.strip()]
        genome_kmers = count_reads_many(
            pairs, args.kmer_size, abundance_min=args.abundance_min,
            device=args.device,
        )
    else:
        if args.survey_conf:
            pairs = conf_pairs
        elif args.genome_dir:
            files = sorted(
                f for f in os.listdir(args.genome_dir)
                if f.endswith((".fna", ".fa", ".fasta", ".fna.gz", ".fa.gz", ".fasta.gz"))
            )
            pairs = [
                (os.path.splitext(f.replace(".gz", ""))[0],
                 os.path.join(args.genome_dir, f))
                for f in files
            ]
        else:
            with open(args.genome_list) as fh:
                pairs = [tuple(l.split()) for l in fh if l.strip()]
        genome_kmers = count_fasta_many(pairs, args.kmer_size,
                                        device=args.device)
    km = build_presence_matrix(genome_kmers,
                               filter_singleton=args.filter_singleton,
                               n_threads=n_cpu)
    matrix_to_tsv(km, args.out)
    print(
        "%d genomes x %d k-mers -> %s" % (km.n_genomes, km.n_kmers, args.out)
    )


_COMMANDS = {
    ("dataset", "create"): _cmd_dataset_create,
    ("dataset", "split"): _cmd_dataset_split,
    ("dataset", "info"): _cmd_dataset_info,
    ("learn", "scm"): _cmd_learn_scm,
    ("learn", "tree"): _cmd_learn_tree,
    ("kmer", "count"): _cmd_kmer_count,
    ("kmer", "matrix"): _cmd_kmer_matrix,
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
