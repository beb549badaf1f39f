"""Comparison of a job's fingerprint with the reference's.

A fingerprint is a dict: ``floats`` maps names to numbers, every other key
holds values compared exactly (rules, tie sets, hyperparameters, counts,
classifications, k-mers). Two readings come out: how many exact entries
differ, and the widest relative gap between paired floats.
"""

from __future__ import annotations

import math


def float_gap(a, b):
    """|a - b| relative to |b| (the reference's); equal infinities are 0
    apart, a NaN or an unpaired infinity infinitely."""
    if a == b:
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-300)


def compare(got, want):
    """(entries that differ, widest float gap) between fingerprints."""
    mismatches = 0
    for key in sorted(set(got) | set(want)):
        if key == "floats":
            continue
        g, w = got.get(key), want.get(key)
        if isinstance(w, dict) and isinstance(g, dict):
            for sub in set(g) | set(w):
                mismatches += int(g.get(sub) != w.get(sub))
        elif isinstance(w, list) and isinstance(g, list):
            mismatches += sum(x != y for x, y in zip(g, w))
            mismatches += abs(len(g) - len(w))
        else:
            mismatches += int(g != w)
    gf, wf = got.get("floats", {}), want.get("floats", {})
    mismatches += len(set(gf) ^ set(wf))
    gap = max([float_gap(gf[k], wf[k]) for k in set(gf) & set(wf)],
              default=0.0)
    return mismatches, gap


def exact_differences(got, want):
    """Entries that differ, the floats compared exactly too."""
    mismatches, _ = compare(got, want)
    gf, wf = got.get("floats", {}), want.get("floats", {})
    return mismatches + sum(gf[k] != wf[k] for k in set(gf) & set(wf))
