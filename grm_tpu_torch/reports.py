"""SCM learning-report emission: report.txt / results.json / config.json /
FASTAs (the port's copy of ``write_scm_outputs`` from ``grm_tpu/reports.py``).

Output formats mirror the reference CLI's artifacts (``bin/kover/kover:580-696``)
so downstream tooling consumes either implementation's outputs.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["write_scm_outputs"]


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        v = float(o)
        return v if np.isfinite(v) else None
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.str_, bytes)):
        return str(o)
    raise TypeError("Not JSON serializable: %r" % type(o))


def _metric_rows(metrics, aliases):
    out = ""
    for key, alias in aliases:
        if key == "confusion_matrix":
            continue
        out += "%s: %s\n" % (alias, str(round(metrics[key][0], 5)))
    return out


BINARY_METRIC_ALIASES = [
    ("risk", "Error Rate"), ("sensitivity", "Sensitivity"),
    ("specificity", "Specificity"), ("precision", "Precision"),
    ("recall", "Recall"), ("f1_score", "F1 Score"),
    ("tp", "True Positives"), ("tn", "True Negatives"),
    ("fp", "False Positives"), ("fn", "False Negatives"),
]


def _data_summary(dataset, split_name, split, phenotype_tags):
    labels = dataset.phenotype.metadata
    s = "Data summary:\n" + "-" * 13 + "\n"
    s += "Dataset file: %s\n" % os.path.abspath(dataset.path)
    s += "Dataset UUID: %s\n" % dataset.uuid
    s += "Phenotype: %s\n" % str(dataset.phenotype.description).title()
    s += "Genomic data type: %s\n" % dataset.genome_source_type
    s += "Split: %s\n" % split_name
    s += "Number of genomes used for training: %d " % len(split.train_genome_idx)
    groups = [
        "Group %s: %d" % (phenotype_tags[c], (labels[split.train_genome_idx] == c).sum())
        for c in range(len(phenotype_tags))
    ]
    s += "(%s)\n" % ", ".join(groups)
    s += "Number of genomes used for testing: %d " % len(split.test_genome_idx)
    groups = [
        "Group %s: %d"
        % (
            phenotype_tags[c],
            (labels[split.test_genome_idx] == c).sum()
            if len(split.test_genome_idx) > 0
            else 0,
        )
        for c in range(len(phenotype_tags))
    ]
    s += "(%s)\n" % ", ".join(groups)
    return s


def write_scm_outputs(output_dir, dataset, split_name, config, best_hp,
                      best_hp_score, train_metrics, test_metrics, model,
                      rule_importances, equivalent_rules, classifications,
                      running_time_seconds):
    """SCM report + json + fasta outputs (reference kover:580-696)."""
    os.makedirs(output_dir, exist_ok=True)
    split = dataset.get_split(split_name)
    phenotype_tags = [str(t) for t in dataset.phenotype.tags]

    report = "Kover Learning Report\n" + "=" * 21 + "\n\n"
    report += "Running time: %s\n\n" % _format_timedelta(running_time_seconds)
    report += "Configuration:\n" + "-" * 14 + "\n"
    for key in sorted(config):
        report += "%s: %s\n" % (key, config[key])
    report += "\n"
    report += _data_summary(dataset, split_name, split, phenotype_tags)
    report += "Number of k-mers: %d\n" % dataset.kmer_count
    if dataset.genome_source_type == "contigs":
        report += "K-mer size : %s\n" % dataset.kmer_length
        report += "K-mer filtering : %s\n" % dataset.kmer_filter
    report += "\n"
    report += "Hyperparameter Values:\n" + "-" * 22 + "\n"
    hp_choice = config.get("hp_choice", "none")
    if hp_choice == "cv":
        report += "Selection strategy: %d-fold cross-validation (score = %.5f)\n" % (
            len(split.folds), best_hp_score)
    elif hp_choice == "bound":
        report += "Selection strategy: bound selection (score = %.5f)\n" % best_hp_score
    else:
        report += "Selection strategy: No selection\n"
    report += "Model type: %s\n" % best_hp["model_type"]
    report += "p: %f\n" % best_hp["p"]
    report += "Maximum number of rules: %d\n" % best_hp["max_rules"]
    report += "\n"
    report += "Metrics (training data)\n" + "-" * 23 + "\n"
    report += _metric_rows(train_metrics, BINARY_METRIC_ALIASES)
    report += "\n"
    if test_metrics is not None:
        report += "Metrics (testing data)\n" + "-" * 22 + "\n"
        report += _metric_rows(test_metrics, BINARY_METRIC_ALIASES)
        report += "\n"
    model_type_title = str(model.type).title()
    header = "Model (%s - %d rules):" % (model_type_title, len(model))
    report += header + "\n" + "-" * len(header) + "\n"
    report += ("\n%s\n" % ("AND" if model.type == "conjunction" else "OR")).join(
        "%s [Importance: %.2f, %d equivalent rules]"
        % (str(rule), importance, len(equivalent_rules[i]))
        for i, (rule, importance) in enumerate(zip(model, rule_importances))
    )
    report += "\n"

    with open(os.path.join(output_dir, "report.txt"), "w") as f:
        f.write(report)

    results = {
        "data": {"uuid": str(dataset.uuid), "path": dataset.path, "split": split_name},
        "cv": {
            "best_hp": {"values": dict(best_hp), "score": best_hp_score},
            "candidate_hp": {
                "model_type": config.get("model_type"),
                "p": config.get("p"),
                "max_rules": config.get("max_rules"),
            },
            "strategy": hp_choice,
        },
        "metrics": {"train": dict(train_metrics),
                    "test": dict(test_metrics) if test_metrics else None},
        "model": {
            "n_rules": len(model),
            "rules": [str(r) for r in model],
            "rule_importances": np.asarray(rule_importances).tolist(),
            "equivalent_rule_counts": [len(e) for e in equivalent_rules],
            "type": best_hp["model_type"],
        },
        "classifications": dict(classifications),
        "running_time": int(running_time_seconds),
    }
    with open(os.path.join(output_dir, "results.json"), "w") as f:
        json.dump(results, f, default=_json_default)
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(dict(config), f, default=_json_default)

    with open(os.path.join(output_dir, "model.fasta"), "w") as f:
        for i, (rule, importance) in enumerate(zip(model, rule_importances)):
            f.write(
                ">rule-%d %s, importance: %.2f\n%s\n\n"
                % (i + 1, rule.type, importance, rule.kmer_sequence)
            )
            with open(
                os.path.join(output_dir, "model_rule_%i_equiv.fasta" % (i + 1)), "w"
            ) as f_equiv:
                f_equiv.write(
                    "\n\n".join(
                        ">rule-%d-equiv-%d,%s\n%s"
                        % (i + 1, j + 1, r.type, r.kmer_sequence)
                        for j, r in enumerate(equivalent_rules[i])
                    )
                )
    return report


def _format_timedelta(seconds):
    from datetime import timedelta

    return str(timedelta(seconds=seconds))
