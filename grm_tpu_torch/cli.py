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
runs the exact engine's plain PyTorch versions.

    python -m grm_tpu_torch collect amr --amr-metadata PATRIC_genomes_AMR.txt ...
    python -m grm_tpu_torch collect genomes --ids 511145.12 --dest dir
    python -m grm_tpu_torch results site --run SPECIES DRUG dir --output-dir site
    python -m grm_tpu_torch results serve --site-dir site
    python -m grm_tpu_torch settings show|get KEY|set KEY VALUE
    python -m grm_tpu_torch --version|--cite|--license

``collect``, ``results`` and ``settings`` (:729-921) run on the host, as
``grm``'s ``_JAX_FREE`` commands do: they take no ``--device`` and never
touch CUDA. They read and write the settings file ``grm`` does.
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


# ---------------------------------------------------------------------------
# collect commands (PATRIC data collection, src/app.py data tabs). These and
# the results and settings commands run on the host: no --device, no CUDA.
# ---------------------------------------------------------------------------
def _cmd_collect_amr(argv):
    parser = argparse.ArgumentParser(
        prog="python -m grm_tpu_torch collect amr",
        description="Filter the PATRIC AMR metadata table and export the "
                    "per-dataset TSVs (full / phenotype metadata / id-name / "
                    "description).",
    )
    parser.add_argument("--amr-metadata",
                        help="Path to PATRIC_genomes_AMR.txt (default: the "
                             "persisted amr_database setting — "
                             "`grm settings set amr_database <path>`)")
    parser.add_argument("--species", default="All")
    parser.add_argument("--antibiotic", default="All")
    parser.add_argument("--drop-intermediate", action="store_true")
    parser.add_argument("--filter-contradictions", action="store_true")
    parser.add_argument("--numeric-phenotypes", action="store_true")
    parser.add_argument("--list-datasets", action="store_true",
                        help="Print available (species, antibiotic) pairs "
                             "with >=50 Resistant and >=50 Susceptible rows.")
    parser.add_argument("--output-dir")
    args = parser.parse_args(argv)

    from .collect.amr import AmrDatabase
    from .settings import get_setting, set_setting

    amr_path = args.amr_metadata or get_setting("amr_database")
    if not amr_path:
        print("Error: no --amr-metadata given and no amr_database setting "
              "persisted (grm settings set amr_database <path>).")
        sys.exit(1)
    amr_path = os.path.abspath(amr_path)

    db = AmrDatabase.load(amr_path)
    if args.amr_metadata:
        # Persist the last-used database path AFTER a successful load,
        # absolute, like the GUI's file-dialog paths (src/app.py:213-223),
        # so bare invocations from any cwd keep working.
        set_setting("amr_database", amr_path)
    if args.list_datasets:
        for species, antibiotic in db.dataset_list(min_group_count=50):
            print("%s\t%s" % (species, antibiotic))
        return
    data = db.select(
        species=args.species, antibiotic=args.antibiotic,
        drop_intermediate=args.drop_intermediate,
        filter_contradictions=args.filter_contradictions,
        numeric_phenotypes=args.numeric_phenotypes,
    )
    phenotypes = [str(v) for v in data["resistant_phenotype"]]
    n_res = sum(v in ("Resistant", "1") for v in phenotypes)
    n_sus = sum(v in ("Susceptible", "0") for v in phenotypes)
    print("Total: %d (Resistant: %d, Susceptible: %d)" % (len(data), n_res, n_sus))
    if args.output_dir:
        folder = db.export(data, args.output_dir, args.species, args.antibiotic)
        print("Exported TSVs to %s" % folder)


def _cmd_collect_genomes(argv):
    parser = argparse.ArgumentParser(
        prog="python -m grm_tpu_torch collect genomes",
        description="Download contig FASTAs (and optionally feature tables) "
                    "from the BV-BRC FTP server.",
    )
    parser.add_argument("--ids", nargs="+",
                        help="Genome identifiers (e.g. 511145.12)")
    parser.add_argument("--ids-file", help="File with one genome id per line")
    parser.add_argument("--dest", required=True)
    parser.add_argument("--features", action="store_true")
    args = parser.parse_args(argv)

    from .collect.patric import download_genomes

    ids = list(args.ids or [])
    if args.ids_file:
        with open(args.ids_file) as f:
            ids += [l.strip() for l in f if l.strip()]
    if not ids:
        print("Error: no genome ids specified.")
        sys.exit(1)
    results, errors = download_genomes(
        ids, args.dest, features=args.features,
        progress_callback=_progress_printer(True),
    )
    print()
    print("Downloaded %d genomes; %d errors." % (len(results), len(errors)))
    for gid, err in errors.items():
        print("  %s: %s" % (gid, err))
    if errors:
        sys.exit(1)


# ---------------------------------------------------------------------------
# results site (analysis page replacement)
# ---------------------------------------------------------------------------
def _cmd_results_site(argv):
    parser = argparse.ArgumentParser(
        prog="python -m grm_tpu_torch results site",
        description="Aggregate learn output directories into the published "
                    "results-site schema (summary.json + per-dataset "
                    "overview/model/repeats JSON + static index.html).",
    )
    parser.add_argument(
        "--run", action="append", nargs=3, required=True,
        metavar=("SPECIES", "ANTIBIOTIC", "RESULTS_DIR"),
        help="One learn run; repeat for multiple runs/repeats.",
    )
    parser.add_argument("--output-dir", required=True)
    args = parser.parse_args(argv)

    from .results_site import write_site

    runs = [
        {"species": s, "antibiotic": a, "results_dir": d}
        for s, a, d in args.run
    ]
    summary = write_site(runs, args.output_dir)
    print("Wrote results site for %d datasets to %s" % (len(summary), args.output_dir))


def _cmd_results_serve(argv):
    parser = argparse.ArgumentParser(
        prog="python -m grm_tpu_torch results serve",
        description="Serve an emitted results site over HTTP — the "
                    "reference's embedded analysis-page server "
                    "(ThreadingHTTPServer on port 5503, src/app.py:114-122) "
                    "without the WebView2 browser.",
    )
    parser.add_argument("--site-dir", required=True,
                        help="Directory written by `grm results site`.")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5503,
                        help="TCP port (default 5503, the reference's; "
                             "0 picks an ephemeral port).")
    args = parser.parse_args(argv)

    from .results_site import serve_site

    server = serve_site(args.site_dir, host=args.host, port=args.port)
    url = "http://%s:%d/" % server.server_address[:2]
    print("Serving results site at %s (ctrl-c to stop)" % url, flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


# ---------------------------------------------------------------------------
# settings commands (the GUI settings page's persistence,
# src/app.py:62-64, 213-223)
# ---------------------------------------------------------------------------
def _cmd_settings_show(argv):
    import json

    from .settings import load_settings, settings_path

    argparse.ArgumentParser(
        prog="python -m grm_tpu_torch settings show",
        description="Print the persisted settings.").parse_args(argv)
    print("# %s" % settings_path())
    print(json.dumps(load_settings(), indent=2))


def _cmd_settings_get(argv):
    from .settings import get_setting

    parser = argparse.ArgumentParser(prog="python -m grm_tpu_torch settings get")
    parser.add_argument("key", help="e.g. amr_database, amr_date")
    args = parser.parse_args(argv)
    value = get_setting(args.key)
    if value is None:
        print("Error: unknown setting %r" % args.key)
        sys.exit(1)
    print(value)


def _cmd_settings_set(argv):
    from .settings import set_setting, settings_path

    parser = argparse.ArgumentParser(prog="python -m grm_tpu_torch settings set")
    parser.add_argument("key")
    parser.add_argument("value")
    args = parser.parse_args(argv)
    set_setting(args.key, args.value)
    print("Saved %s=%s to %s" % (args.key, args.value, settings_path()))


_COMMANDS = {
    ("dataset", "create"): _cmd_dataset_create,
    ("dataset", "split"): _cmd_dataset_split,
    ("dataset", "info"): _cmd_dataset_info,
    ("learn", "scm"): _cmd_learn_scm,
    ("learn", "tree"): _cmd_learn_tree,
    ("kmer", "count"): _cmd_kmer_count,
    ("kmer", "matrix"): _cmd_kmer_matrix,
    ("collect", "amr"): _cmd_collect_amr,
    ("collect", "genomes"): _cmd_collect_genomes,
    ("results", "site"): _cmd_results_site,
    ("results", "serve"): _cmd_results_serve,
    ("settings", "show"): _cmd_settings_show,
    ("settings", "get"): _cmd_settings_get,
    ("settings", "set"): _cmd_settings_set,
}

# grm's informational flags (bin/kover/kover:1095-1151), with its texts.
_CITE = (
    "The algorithms implemented by this framework were introduced "
    "in:\n\n"
    "Drouin, A. et al. (2019). Interpretable genotype-to-phenotype "
    "classifiers with performance guarantees. Scientific Reports, "
    "9(1), 4071.\n\n"
    "Drouin, A. et al. (2016). Predictive computational phenotyping "
    "and biomarker discovery using reference-free genome "
    "comparisons. BMC Genomics, 17(1), 754."
)
_LICENSE = (
    "grm-tpu is free software: you can redistribute it and/or "
    "modify it under the terms of the GNU General Public License "
    "as published by the Free Software Foundation, either version "
    "3 of the License, or (at your option) any later version. It "
    "is distributed WITHOUT ANY WARRANTY; see "
    "<http://www.gnu.org/licenses/> for details."
)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    top = argparse.ArgumentParser(
        prog="python -m grm_tpu_torch",
        description="GRM on PyTorch and CUDA: interpretable AMR rule learning.",
    )
    top.add_argument("command", choices=sorted({c for c, _ in _COMMANDS}))
    top.add_argument("subcommand", choices=sorted({s for _, s in _COMMANDS}))
    top.add_argument("--version", action="version", version="grm-tpu 0.1.0")
    if argv and argv[0] == "--cite":
        print(_CITE)
        return
    if argv and argv[0] == "--license":
        print(_LICENSE)
        return
    if len(argv) < 2 or (argv[0], argv[1]) not in _COMMANDS:
        top.parse_args(argv[:2] or ["-h"])
        return
    _COMMANDS[(argv[0], argv[1])](argv[2:])


if __name__ == "__main__":
    main()
