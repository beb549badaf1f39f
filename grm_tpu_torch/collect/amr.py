"""PATRIC/BV-BRC AMR phenotype metadata: loading, filtering, export (port
of ``grm_tpu/collect/amr.py``, without pandas).

Headless re-implementation of the GUI's data-collection AMR tab
(``src/app.py:3430-3810``): the same column set, cleaning rules, group
filters and the four-file TSV export, driving dataset construction instead
of a table widget. ``grm_tpu`` keeps the table in a pandas DataFrame; here
it is a :class:`Table` of plain tuples read with :mod:`csv`, with the same
rows in the same order:

- the file is read as ``pandas.read_csv(sep="\\t", usecols=..., converters=
  ...)`` reads it: every cell the raw string (``NA``, ``nan`` and ``N/A``
  stay strings, an empty or missing cell is ``""``), quotes stripped, blank
  lines skipped, the six columns in the file's order;
- genome_name normalized to the first two lower-cased words, brackets
  stripped (app.py:3458-3460);
- duplicate rows dropped, the first kept; rows with any empty field
  dropped; disk-diffusion rows (measurement_unit == "mm") dropped;
  measurement and unit merged (app.py:3475-3488);
- the "phenotype count >= 50" list filter requires >=50 Resistant AND >=50
  Susceptible rows per (species, antibiotic) group (app.py:3494-3501);
- drop-intermediate keeps only Resistant/Susceptible rows (app.py:3676-3686);
- the contradiction filter drops genomes whose rows disagree on the
  phenotype (app.py:3688-3698);
- the numeric phenotype mask maps Susceptible->0, Resistant->1, other->2
  (app.py:3615-3635);
- export writes ``<base>_full.tsv``, ``<base>_phenotype_metadata.tsv``
  (genome_id -> label, deduplicated, no header), ``<base>_id_name.tsv`` and
  ``<base>_description.tsv`` (app.py:3739-3808).

Every filter keeps the table's row order, as pandas' boolean masks,
``groupby(...).filter`` and ``drop_duplicates`` keep it.
"""

from __future__ import annotations

import csv
import os
import re
from collections import Counter, defaultdict

__all__ = ["AmrDatabase", "Table", "sanitize_filename"]

AMR_COLUMNS = [
    "genome_id",
    "genome_name",
    "antibiotic",
    "resistant_phenotype",
    "measurement",
    "measurement_unit",
]


def sanitize_filename(name):
    return re.sub(r"[^A-Za-z0-9._-]+", "_", name.strip())


def _normalize_genome_name(x):
    return " ".join(str(x).lower().split()[:2]).replace("[", "").replace("]", "")


class Table:
    """Rows (tuples) under named columns: what ``grm_tpu`` holds in a
    DataFrame. ``table["col"]`` is the column as a list, ``table[["a",
    "b"]]`` the table of those columns."""

    def __init__(self, columns, rows):
        self.columns = list(columns)
        self.rows = [tuple(r) for r in rows]

    def __len__(self):
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def __getitem__(self, key):
        if isinstance(key, str):
            i = self.columns.index(key)
            return [r[i] for r in self.rows]
        idx = [self.columns.index(c) for c in key]
        return Table(key, [tuple(r[i] for i in idx) for r in self.rows])

    def where(self, column, keep):
        """The rows whose value in ``column`` passes ``keep``, in order."""
        i = self.columns.index(column)
        return Table(self.columns, [r for r in self.rows if keep(r[i])])

    def drop_duplicates(self):
        """Each distinct row once, at its first occurrence."""
        seen = set()
        rows = []
        for r in self.rows:
            if r not in seen:
                seen.add(r)
                rows.append(r)
        return Table(self.columns, rows)


def _read_amr(path):
    """The six AMR columns of a tab-separated file, as ``grm_tpu``'s
    ``read_csv`` call gives them (module docstring)."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f, delimiter="\t")
        header = next((row for row in reader if row), [])
        missing = [c for c in AMR_COLUMNS if c not in header]
        if missing:
            raise ValueError("Usecols do not match columns, columns expected "
                             "but not found: %s" % missing)
        columns = [c for c in header if c in AMR_COLUMNS]
        idx = [header.index(c) for c in columns]
        name = columns.index("genome_name")
        names = {}  # raw genome_name -> normalized
        rows = []
        for row in reader:
            if not row or (len(row) == 1 and not row[0].strip()):
                continue  # a blank line
            cells = [row[i] if i < len(row) else "" for i in idx]
            raw = cells[name]
            if raw not in names:
                names[raw] = _normalize_genome_name(raw)
            cells[name] = names[raw]
            rows.append(tuple(cells))
    return Table(columns, rows)


class AmrDatabase:
    """A loaded, cleaned PATRIC_genomes_AMR.txt table."""

    def __init__(self, frame):
        self.frame = frame

    @classmethod
    def load(cls, path):
        frame = _read_amr(path).drop_duplicates()
        m = frame.columns.index("measurement")
        u = frame.columns.index("measurement_unit")
        # The six columns are the table's: a row is kept without an empty
        # cell and without the disk-diffusion unit.
        return cls(Table(frame.columns, [
            r[:m] + (r[m] + r[u],) + r[m + 1:] for r in frame.rows
            if "" not in r and r[u] != "mm"]))

    # -- dataset lists ------------------------------------------------------
    def dataset_list(self, min_group_count=None):
        """(species, antibiotic) pairs; optionally the >=50/50 filter."""
        pairs = self.frame[["genome_name", "antibiotic"]]
        if min_group_count is None:
            return pairs.drop_duplicates()
        n = min_group_count
        counts = Counter(zip(self.frame["genome_name"],
                             self.frame["antibiotic"],
                             self.frame["resistant_phenotype"]))
        return Table(pairs.columns, [
            p for p in pairs.rows
            if counts[p + ("Resistant",)] >= n
            and counts[p + ("Susceptible",)] >= n]).drop_duplicates()

    def species(self):
        return sorted(set(self.frame["genome_name"]))

    def antibiotics(self):
        return sorted(set(self.frame["antibiotic"]))

    # -- per-dataset selection ---------------------------------------------
    def select(self, species="All", antibiotic="All", drop_intermediate=False,
               filter_contradictions=False, numeric_phenotypes=False):
        """Rows for one (species, antibiotic) with the reference's filters."""
        data = self.frame
        if antibiotic != "All":
            data = data.where("antibiotic", lambda v: v == antibiotic)
        if species != "All":
            data = data.where("genome_name", lambda v: v == species)

        data = data[["genome_id", "genome_name", "resistant_phenotype",
                     "measurement"]]

        if drop_intermediate:
            data = data.where("resistant_phenotype",
                              lambda v: v in ("Resistant", "Susceptible"))

        if filter_contradictions:
            phenotypes = defaultdict(set)
            for gid, _, phenotype, _ in data.rows:
                phenotypes[gid].add(phenotype)
            data = data.where("genome_id",
                              lambda v: len(phenotypes[v]) == 1)

        if numeric_phenotypes:
            data = self._phenotype_mask(data)
        return data

    @staticmethod
    def _phenotype_mask(data):
        codes = {"Susceptible": 0, "Resistant": 1}
        i = data.columns.index("resistant_phenotype")
        return Table(data.columns, [r[:i] + (codes.get(r[i], 2),) + r[i + 1:]
                                    for r in data.rows])

    # -- export -------------------------------------------------------------
    def export(self, data, out_dir, species, antibiotic):
        """Write the four reference TSVs; returns the dataset directory."""
        species_s = sanitize_filename(species)
        anti_s = sanitize_filename(antibiotic)
        base = "%s_%s" % (species_s, anti_s)
        folder = os.path.join(out_dir, species_s, anti_s)
        os.makedirs(folder, exist_ok=True)

        with open(os.path.join(folder, base + "_full.tsv"), "w", newline="") as f:
            w = csv.writer(f, delimiter="\t")
            w.writerow(data.columns)
            w.writerows(data.rows)

        with open(
            os.path.join(folder, base + "_phenotype_metadata.tsv"), "w", newline=""
        ) as f:
            w = csv.writer(f, delimiter="\t")
            w.writerows(data[[data.columns[0], data.columns[2]]]
                        .drop_duplicates().rows)

        with open(os.path.join(folder, base + "_id_name.tsv"), "w", newline="") as f:
            w = csv.writer(f, delimiter="\t")
            w.writerow(data.columns[:2])
            w.writerows(data[data.columns[:2]].rows)

        with open(os.path.join(folder, base + "_description.tsv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Species: %s" % species_s])
            w.writerow(["Antibiotics: %s" % anti_s])
        return folder
