"""Learning-report emission: report.txt / results.json / config.json / FASTAs
(the port's copy of ``grm_tpu/reports.py``).

Output formats mirror the reference CLI's artifacts (``bin/kover/kover:580-696``
for SCM, ``:906-1053`` for CART) so downstream tooling consumes either
implementation's outputs.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .profiling import spanned

__all__ = ["write_scm_outputs", "write_cart_outputs", "confusion_matrix_to_str"]


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


def confusion_matrix_to_str(confusion_matrix, phenotype_tags):
    """ASCII confusion matrix table (reference kover:916-932)."""
    phenotype_tags = [str(t) for t in phenotype_tags]
    size_header = len(max(phenotype_tags, key=len)) + 5
    col_width = 5
    bar = (
        "+-" + "-" * size_header + "+"
        + "+".join("-" * col_width for _ in phenotype_tags) + "+\n"
    )
    s = bar
    s += "| " + " " * size_header + "|"
    s += "|".join(str(c).center(col_width) for c in range(len(phenotype_tags)))
    s += "|\n" + bar.replace("-", "=")
    for c in range(len(phenotype_tags)):
        s += "| " + phenotype_tags[c].ljust(size_header - 5) + ("(%d)" % c).center(5) + "|"
        s += "|".join(str(v).center(col_width) for v in confusion_matrix[c]) + "|\n"
        s += bar
    return s


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


@spanned("report.write")
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


@spanned("report.write")
def write_cart_outputs(output_dir, dataset, split_name, config, best_hp,
                       best_hp_score, train_metrics, test_metrics, model,
                       rule_importances, equivalent_rules, classifications,
                       running_time_seconds, classification_type):
    """CART report + json + fasta outputs (reference kover:906-1053)."""
    os.makedirs(output_dir, exist_ok=True)
    split = dataset.get_split(split_name)
    phenotype_tags = [str(t) for t in dataset.phenotype.tags]

    if classification_type == "binary":
        metric_aliases = BINARY_METRIC_ALIASES
    else:
        metric_aliases = [("risk", "Error rate"), ("confusion_matrix", "Confusion Matrix")]

    # Rule identifiers encoding tree structure (reference kover:934-942).
    rule_ids = {}
    id_by_node = {}
    for i, n in model.decision_tree:
        if not n.is_leaf:
            id_by_node[n] = "%d___ex_%d___eq_%d" % (
                i, n.n_examples, len(equivalent_rules[n.rule]))
        else:
            id_by_node[n] = "leaf___ex_%d___%s" % (
                n.n_examples,
                "__".join(
                    "%s_%d_%.8f"
                    % (
                        model.class_tags[c],
                        len(n.class_examples_idx[c]),
                        n.breiman_info.p_j_given_t[c],
                    )
                    for c in sorted(n.class_proportions)
                ),
            )
    for node_id, node in model.decision_tree:
        if not node.is_leaf:
            rule_ids[node.rule] = {
                "simple": str(node_id),
                "fasta": "rule_id: %s, left_child: %s, right_child: %s"
                % (id_by_node[node], id_by_node[node.left_child],
                   id_by_node[node.right_child]),
            }

    report = "Kover Learning Report\n" + "=" * 21 + "\n\n"
    report += "Running time: %s\n\n" % _format_timedelta(running_time_seconds)
    report += "Configuration:\n" + "-" * 14 + "\n"
    for key in sorted(config):
        report += "%s: %s\n" % (key, config[key])
    report += "\n"
    report += _data_summary(dataset, split_name, split, phenotype_tags)
    report += "\n"
    report += "Hyperparameter Values:\n" + "-" * 22 + "\n"
    hp_choice = config.get("hp_choice", "cv")
    if hp_choice == "cv":
        report += (
            "Selection strategy: %d-fold cross-validation (score = %.5f)\n"
            % (len(split.folds), best_hp_score)
        )
    else:
        report += (
            "Selection strategy: sample-compression bound (delta = %.3f, "
            "max-genome-size = %d, value = %.5f)\n"
            % (config.get("bound_delta", 0.05),
               config.get("bound_max_genome_size", 0), best_hp_score)
        )
    report += "Criterion: %s\n" % best_hp["criterion"]
    report += "Class importance: %s\n" % ", ".join(
        "class %s: %.3f" % (phenotype_tags[c], v)
        for c, v in sorted(best_hp["class_importance"].items())
    )
    report += "Maximum tree depth: %d\n" % best_hp["max_depth"]
    report += "Minimum samples to split a node (examples): %.3f\n" % best_hp["min_samples_split"]
    report += "Pruning alpha: %.8f\n" % best_hp["pruning_alpha"]
    report += "\n"
    report += "Metrics (training data)\n" + "-" * 23 + "\n"
    for key, alias in metric_aliases:
        if key == "confusion_matrix":
            report += "%s :\n%s\n" % (
                alias, confusion_matrix_to_str(train_metrics[key][0], phenotype_tags))
        else:
            report += "%s: %s\n" % (alias, str(round(train_metrics[key][0], 5)))
    report += "\n"
    if test_metrics is not None:
        report += "Metrics (testing data)\n" + "-" * 22 + "\n"
        for key, alias in metric_aliases:
            if key == "confusion_matrix":
                report += "%s :\n%s\n" % (
                    alias, confusion_matrix_to_str(test_metrics[key][0], phenotype_tags))
            else:
                report += "%s: %s\n" % (alias, str(round(test_metrics[key][0], 5)))
        report += "\n"
    report += "Model (%d rules, depth = %d):\n" % (
        len(model.decision_tree.rules), model.depth)
    report += str(model) + "\n\n"

    with open(os.path.join(output_dir, "report.txt"), "w") as f:
        f.write(report)

    model_rules = model.decision_tree.rules
    results = {
        "data": {"uuid": str(dataset.uuid), "path": dataset.path, "split": split_name},
        "cv": {
            "best_hp": {
                "values": {
                    k: (dict(v) if isinstance(v, dict) else v)
                    for k, v in best_hp.items()
                },
                "score": best_hp_score,
            },
            "candidate_hp": {
                "criterion": config.get("criterion"),
                "max_depth": config.get("max_depth"),
            },
            "strategy": hp_choice,
        },
        "metrics": {"train": dict(train_metrics),
                    "test": dict(test_metrics) if test_metrics else None},
        "model": {
            "n_rules": len(model_rules),
            "depth": model.depth,
            "rules": [str(r) for r in model_rules],
            "rule_importances": [rule_importances[r] for r in model_rules],
            "equivalent_rule_counts": [
                len(equivalent_rules.get(r, [r])) for r in model_rules
            ],
            "rule_identifiers": [rule_ids[r]["simple"] for r in model_rules],
        },
        "classifications": dict(classifications),
        "running_time": int(running_time_seconds),
    }
    with open(os.path.join(output_dir, "results.json"), "w") as f:
        json.dump(results, f, default=_json_default)
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(dict(config), f, default=_json_default)

    with open(os.path.join(output_dir, "model.fasta"), "w") as f:
        for rule in model_rules:
            f.write(
                ">%s, importance: %.2f\n%s\n\n"
                % (rule_ids[rule]["fasta"], rule_importances[rule], rule.kmer_sequence)
            )
            with open(
                os.path.join(
                    output_dir, "model_rule_%s_equiv.fasta" % rule_ids[rule]["simple"]
                ),
                "w",
            ) as f_equiv:
                f_equiv.write(
                    "\n\n".join(
                        ">rule-%s-equiv-%d\n%s"
                        % (rule_ids[rule]["simple"], j + 1, r.kmer_sequence)
                        for j, r in enumerate(equivalent_rules[rule])
                    )
                )
    return report


def _format_timedelta(seconds):
    from datetime import timedelta

    return str(timedelta(seconds=seconds))
