"""Results-site emission: aggregate learn runs into the published schema
(port of ``grm_tpu/results_site.py``; every file it writes equals
``grm_tpu``'s byte for byte on the same ``results.json`` directories).

The reference bundles a static results viewer (``page/``) fed by
``results/summary.json`` (one row of mean-over-repeats metrics per dataset,
``page/index.html:77``) and per-dataset ``overview.json`` / ``model.json`` /
``repeats.json`` (``page/details.html:485-520``). This module reproduces
those artifacts from a collection of `grm learn` output directories so the
analysis capability survives without the embedded WebView2 browser:

- schema-compatible ``summary.json`` + per-dataset ``overview.json`` /
  ``model.json`` / ``repeats.json`` / ``<name>.fasta``;
- a standalone ``index.html`` with the summary table AND a dependency-free
  SVG scatter explorer (genomes / k-mers / sensitivity / specificity — the
  role of the reference's Plotly scatter matrix, ``page/index.html:473-626``);
- a per-dataset ``details.html`` (model rules, importances, equivalent-rule
  counts, overview + repeats tables, model FASTA download — the role of
  ``page/details.html:485-520``).

Everything is self-contained static HTML/SVG/vanilla-JS: no CDN, no Plotly,
no Bootstrap — it renders offline exactly like the artifacts ship.
"""

from __future__ import annotations

import html
import json
import os

import numpy as np

__all__ = ["aggregate_runs", "write_site", "serve_site"]

_METRIC_KEYS = [
    "risk", "sensitivity", "specificity", "precision", "recall", "f1_score",
    "tp", "tn", "fp", "fn",
]


def _one_repeat_row(results, species, antibiotic):
    """One repeats.json row from a results.json payload."""
    test = results["metrics"]["test"] or {}
    row = {
        "antibiotic": antibiotic,
        "species": species,
        "n_rules": results["model"]["n_rules"],
        "running_time": results.get("running_time", 0),
    }
    for key in _METRIC_KEYS:
        if key in test:
            value = test[key][0]
            row[key] = None if value is None else float(value)
    n_train = len(results["classifications"].get("train_correct", [])) + len(
        results["classifications"].get("train_errors", [])
    )
    n_test = len(results["classifications"].get("test_correct", [])) + len(
        results["classifications"].get("test_errors", [])
    )
    row["ds_n_train_examples"] = n_train
    row["ds_n_test_examples"] = n_test
    row["ds_n_examples"] = n_train + n_test
    return row


def _dataset_dims(results):
    """(n_genomes, n_kmers) from the run's artifact, when still readable
    (``h5py`` is imported here only: without it, or without the file, both
    are None)."""
    path = (results.get("data") or {}).get("path")
    if not path or not os.path.exists(path):
        return None, None
    try:
        import h5py

        with h5py.File(path, "r") as f:
            return int(f["genome_identifiers"].shape[0]), int(
                f["kmer_sequences"].shape[0])
    except Exception:
        return None, None


def aggregate_runs(runs, out_dir):
    """Aggregate learn output dirs into summary.json + per-dataset files.

    ``runs``: list of dicts {species, antibiotic, results_dir} where
    results_dir contains a results.json written by :mod:`grm_tpu_torch.reports`
    (or ``grm_tpu``'s).
    Repeats of the same (species, antibiotic) are averaged like the
    reference's mean-over-repeats summary rows.
    """
    by_dataset = {}
    for run in runs:
        species = run["species"]
        antibiotic = run["antibiotic"]
        ds_full_name = "%s___%s" % (
            antibiotic.lower().replace(" ", "_"),
            species.lower().replace(" ", "_"),
        )
        with open(os.path.join(run["results_dir"], "results.json")) as f:
            results = json.load(f)
        entry = by_dataset.setdefault(
            ds_full_name,
            {"species": species, "antibiotic": antibiotic, "repeats": [],
             "models": [], "run_dirs": []},
        )
        row = _one_repeat_row(results, species, antibiotic)
        n_genomes, n_kmers = _dataset_dims(results)
        if n_genomes is not None:
            row["ds_n_genomes"] = n_genomes
            row["ds_n_kmers"] = n_kmers
        entry["repeats"].append(row)
        entry["models"].append(results["model"])
        entry["run_dirs"].append(run["results_dir"])

    summary = []
    datasets_dir = os.path.join(out_dir, "datasets")
    os.makedirs(datasets_dir, exist_ok=True)
    for ds_full_name, entry in sorted(by_dataset.items()):
        repeats = entry["repeats"]
        row = {
            "antibiotic": entry["antibiotic"].title(),
            "species": entry["species"].title(),
            "ds_full_name": ds_full_name,
        }
        numeric_keys = set()
        for r in repeats:
            numeric_keys.update(
                k for k, v in r.items() if isinstance(v, (int, float))
            )
        for key in sorted(numeric_keys):
            values = [r[key] for r in repeats
                      if isinstance(r.get(key), (int, float))]
            if values:
                row[key] = round(float(np.mean(values)), 4)
        summary.append(row)

        ds_dir = os.path.join(datasets_dir, ds_full_name)
        os.makedirs(ds_dir, exist_ok=True)
        with open(os.path.join(ds_dir, "repeats.json"), "w") as f:
            json.dump(repeats, f)
        with open(os.path.join(ds_dir, "overview.json"), "w") as f:
            json.dump(
                [{
                    "mean_risk": row.get("risk"),
                    "mean_sensitivity": row.get("sensitivity"),
                    "mean_specificity": row.get("specificity"),
                    "running_time": row.get("running_time"),
                    "ds_n_genomes": row.get("ds_n_examples"),
                }],
                f,
            )
        # model.json from the first repeat's model (reference shows one).
        with open(os.path.join(ds_dir, "model.json"), "w") as f:
            json.dump(entry["models"][0], f)
        # <name>.fasta: the displayed model's FASTA (the details page's
        # download target, page/details.html:490-497).
        src_fasta = os.path.join(entry["run_dirs"][0], "model.fasta")
        if os.path.exists(src_fasta):
            with open(src_fasta) as f_in, open(
                    os.path.join(ds_dir, ds_full_name + ".fasta"), "w") as f_out:
                f_out.write(f_in.read())
        _write_details_page(ds_dir, ds_full_name, entry, row)

    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f)
    return summary


# Shared style: one accent (categorical slot 1) for the single "datasets"
# series, text in ink tokens (never the series color), recessive grid,
# light/dark from the same roles.
_BASE_STYLE = """
:root { color-scheme: light dark;
  --surface: #fcfcfb; --ink: #0b0b0b; --ink-2: #52514e; --grid: #e4e3df;
  --accent: #2a78d6; --accent-ink: #205a9e; }
@media (prefers-color-scheme: dark) {
  :root { --surface: #1a1a19; --ink: #ffffff; --ink-2: #c3c2b7;
          --grid: #33322f; --accent: #3987e5; --accent-ink: #7fb3f0; } }
body { font-family: system-ui, sans-serif; margin: 2em; background: var(--surface);
       color: var(--ink); }
h1, h2 { font-weight: 600; }
table { border-collapse: collapse; margin: 1em 0; }
th, td { border: 1px solid var(--grid); padding: 4px 10px; text-align: right;
         font-variant-numeric: tabular-nums; }
th { background: color-mix(in srgb, var(--grid) 40%, var(--surface)); text-align: right; }
td.l, th.l { text-align: left; }
a { color: var(--accent-ink); }
.muted { color: var(--ink-2); }
svg text { fill: var(--ink-2); font-size: 11px; }
svg .axis { stroke: var(--grid); stroke-width: 1; }
svg .pt { fill: var(--accent); fill-opacity: 0.85; stroke: var(--surface);
          stroke-width: 2; }
svg .pt:hover { fill-opacity: 1; }
.panels { display: flex; flex-wrap: wrap; gap: 24px; }
#tip { position: fixed; pointer-events: none; background: var(--surface);
       color: var(--ink); border: 1px solid var(--grid); border-radius: 4px;
       padding: 4px 8px; font-size: 12px; display: none; z-index: 10;
       box-shadow: 0 2px 8px rgba(0,0,0,0.15); }
"""

_TIP_JS = """
var tip = document.getElementById('tip');
document.querySelectorAll('svg .pt').forEach(function (c) {
  c.addEventListener('mousemove', function (e) {
    tip.style.display = 'block';
    tip.style.left = (e.clientX + 12) + 'px';
    tip.style.top = (e.clientY + 12) + 'px';
    tip.textContent = c.getAttribute('data-tip');
  });
  c.addEventListener('mouseleave', function () { tip.style.display = 'none'; });
  c.addEventListener('click', function () {
    var href = c.getAttribute('data-href');
    if (href) window.location = href;
  });
});
"""


def _svg_scatter(points, xkey, ykey, xlabel, ylabel, w=300, h=240):
    """One scatter panel: datasets as 8px dots, linear axes, min/max ticks.

    ``points``: list of dicts carrying xkey/ykey plus "label" and "href".
    Dependency-free replacement for one cell of the reference's Plotly
    scatter matrix (page/index.html:473-626).
    """
    pts = [p for p in points
           if isinstance(p.get(xkey), (int, float))
           and isinstance(p.get(ykey), (int, float))]
    if not pts:
        return ""
    ml, mr, mt, mb = 52, 12, 10, 36
    xs = [p[xkey] for p in pts]
    ys = [p[ykey] for p in pts]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if x0 == x1:
        x0, x1 = x0 - 0.5, x1 + 0.5
    if y0 == y1:
        y0, y1 = y0 - 0.5, y1 + 0.5

    def sx(v):
        return ml + (v - x0) / (x1 - x0) * (w - ml - mr)

    def sy(v):
        return (h - mb) - (v - y0) / (y1 - y0) * (h - mt - mb)

    def fmt(v):
        if abs(v) >= 1e6:
            return "%.1fM" % (v / 1e6)
        if abs(v) >= 1e3:
            return "%.1fk" % (v / 1e3)
        return ("%.2f" % v).rstrip("0").rstrip(".")

    parts = ['<svg viewBox="0 0 %d %d" width="%d" height="%d" role="img" '
             'aria-label="%s vs %s">' % (w, h, w, h, html.escape(xlabel),
                                         html.escape(ylabel))]
    parts.append('<line class="axis" x1="%d" y1="%d" x2="%d" y2="%d"/>'
                 % (ml, h - mb, w - mr, h - mb))
    parts.append('<line class="axis" x1="%d" y1="%d" x2="%d" y2="%d"/>'
                 % (ml, mt, ml, h - mb))
    for v in (x0, x1):
        parts.append('<text x="%.1f" y="%d" text-anchor="middle">%s</text>'
                     % (sx(v), h - mb + 16, fmt(v)))
    for v in (y0, y1):
        parts.append('<text x="%d" y="%.1f" text-anchor="end">%s</text>'
                     % (ml - 6, sy(v) + 4, fmt(v)))
    parts.append('<text x="%.1f" y="%d" text-anchor="middle" '
                 'font-weight="600">%s</text>'
                 % ((ml + w - mr) / 2, h - 6, html.escape(xlabel)))
    parts.append('<text x="14" y="%.1f" text-anchor="middle" font-weight="600"'
                 ' transform="rotate(-90 14 %.1f)">%s</text>'
                 % ((mt + h - mb) / 2, (mt + h - mb) / 2, html.escape(ylabel)))
    for p in pts:
        tipt = "%s — %s: %s, %s: %s" % (p["label"], xlabel, fmt(p[xkey]),
                                        ylabel, fmt(p[ykey]))
        parts.append(
            '<circle class="pt" cx="%.1f" cy="%.1f" r="4" data-tip="%s"'
            ' data-href="%s"/>'
            % (sx(p[xkey]), sy(p[ykey]), html.escape(tipt, quote=True),
               html.escape(p.get("href", ""), quote=True)))
    parts.append("</svg>")
    return "".join(parts)


_PANEL_SPECS = [
    ("ds_n_genomes", "risk", "Genomes", "Error rate"),
    ("ds_n_kmers", "risk", "k-mers", "Error rate"),
    ("sensitivity", "specificity", "Sensitivity", "Specificity"),
    ("ds_n_genomes", "ds_n_kmers", "Genomes", "k-mers"),
]


def _details_rows(keys, row_dicts):
    head = "<tr>" + "".join("<th>%s</th>" % html.escape(k) for k in keys) + "</tr>"
    body = []
    for r in row_dicts:
        body.append("<tr>" + "".join(
            "<td>%s</td>" % html.escape(str(r.get(k, "")))
            for k in keys) + "</tr>")
    return head + "\n" + "\n".join(body)


def _write_details_page(ds_dir, ds_full_name, entry, summary_row):
    """Per-dataset details.html: model view + overview + repeats + FASTA
    (the reference page/details.html role)."""
    model = entry["models"][0]
    rules = model.get("rules", [])
    importances = model.get("rule_importances", [])
    equiv = model.get("equivalent_rule_counts", [])
    rule_rows = []
    for i, r in enumerate(rules):
        imp = importances[i] if i < len(importances) else ""
        eq = equiv[i] if i < len(equiv) else ""
        rule_rows.append(
            "<tr><td class='l'><code>%s</code></td><td>%s</td><td>%s</td></tr>"
            % (html.escape(str(r)),
               "%.3f" % imp if isinstance(imp, (int, float)) else "",
               eq))
    overview_keys = ["risk", "sensitivity", "specificity", "f1_score",
                     "n_rules", "running_time", "ds_n_genomes", "ds_n_kmers"]
    repeat_keys = [k for k in ["risk", "sensitivity", "specificity",
                               "f1_score", "tp", "tn", "fp", "fn", "n_rules",
                               "running_time"]
                   if any(k in r for r in entry["repeats"])]
    page = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>%(title)s — GRM-TPU results</title>
<style>%(style)s</style></head><body>
<p><a href="../../index.html">&larr; all datasets</a></p>
<h1><i>%(species)s</i> — %(antibiotic)s</h1>
<h2>Model (%(mtype)s, %(n_rules)s rules)</h2>
<table><tr><th class="l">Rule</th><th>Importance</th><th>Equivalent rules</th></tr>
%(rule_rows)s</table>
<p><a href="%(fasta)s" download>Download model FASTA</a></p>
<h2>Overview (mean over %(n_rep)d repeats)</h2>
<table>%(overview)s</table>
<h2>Repeats</h2>
<table>%(repeats)s</table>
<p class="muted">Schema-compatible JSON: <a href="model.json">model.json</a>,
<a href="overview.json">overview.json</a>, <a href="repeats.json">repeats.json</a></p>
</body></html>
""" % {
        "title": html.escape(ds_full_name),
        "style": _BASE_STYLE,
        "species": html.escape(entry["species"].title()),
        "antibiotic": html.escape(entry["antibiotic"].title()),
        "mtype": html.escape(str(model.get("type", "CART"))),
        "n_rules": model.get("n_rules", len(rules)),
        "rule_rows": "\n".join(rule_rows),
        "fasta": html.escape(ds_full_name + ".fasta"),
        "n_rep": len(entry["repeats"]),
        "overview": _details_rows(overview_keys, [summary_row]),
        "repeats": _details_rows(repeat_keys, entry["repeats"]),
    }
    with open(os.path.join(ds_dir, "details.html"), "w") as f:
        f.write(page)


_INDEX_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>GRM-TPU results</title>
<style>{style}</style></head><body>
<h1>GRM-TPU learning results</h1>
<p class="muted">{n} datasets (mean over repeats). Click a row or a point
for the dataset's details page.</p>
<h2>Explorer</h2>
<div class="panels">{panels}</div>
<h2>Summary</h2>
<table>
<tr><th class="l">Species</th><th class="l">Antibiotic</th><th>Error rate</th>
<th>Sensitivity</th><th>Specificity</th><th>F1</th><th>Rules</th>
<th>Time (s)</th></tr>
{rows}
</table>
<div id="tip"></div>
<script>{tipjs}</script>
</body></html>
"""


def write_site(runs, out_dir):
    """Aggregate + emit the browsable static site (WebView2 replacement):
    index.html (summary table + SVG scatter explorer) and per-dataset
    details.html pages."""
    summary = aggregate_runs(runs, out_dir)
    rows = []
    points = []
    for r in summary:
        href = "datasets/%s/details.html" % r["ds_full_name"]
        cells = "".join(
            "<td%s>%s</td>" % (" class='l'" if k in ("species", "antibiotic")
                               else "", html.escape(str(r.get(k, ""))))
            for k in ["species", "antibiotic", "risk", "sensitivity",
                      "specificity", "f1_score", "n_rules", "running_time"]
        )
        rows.append(
            "<tr onclick=\"window.location='%s'\" style='cursor:pointer'>"
            "%s</tr>" % (href, cells))
        p = dict(r)
        # Genomes fall back to the classification counts when the artifact
        # is no longer readable at aggregation time.
        p.setdefault("ds_n_genomes", p.get("ds_n_examples"))
        p["label"] = "%s / %s" % (r.get("species"), r.get("antibiotic"))
        p["href"] = href
        points.append(p)
    panels = "\n".join(
        _svg_scatter(points, xk, yk, xl, yl)
        for xk, yk, xl, yl in _PANEL_SPECS
    )
    with open(os.path.join(out_dir, "index.html"), "w") as f:
        f.write(_INDEX_TEMPLATE.format(style=_BASE_STYLE, n=len(summary),
                                       panels=panels, rows="\n".join(rows),
                                       tipjs=_TIP_JS))
    return summary


def serve_site(site_dir, host="127.0.0.1", port=5503):
    """Serve an emitted site directory over HTTP.

    The reference embeds a daemonized ``ThreadingHTTPServer`` on port 5503
    whose document root is the app directory, and points the WebView2
    browser at it (``src/app.py:114-122``, ``src/app.py:2978-2987``). This
    is the same server without the embedded browser: any local browser (or
    curl) renders the explorer. Port 0 picks an ephemeral port (tests).

    Returns the started server; the caller drives ``serve_forever`` (the
    CLI does) or ``shutdown()`` + ``server_close()`` (tests do).
    """
    from functools import partial
    from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

    if not os.path.isdir(site_dir):
        raise ValueError("results site directory does not exist: %s" % site_dir)

    class _QuietHandler(SimpleHTTPRequestHandler):
        def log_message(self, fmt, *args):  # no per-request stderr spam
            pass

    handler = partial(_QuietHandler, directory=os.path.abspath(site_dir))
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server
