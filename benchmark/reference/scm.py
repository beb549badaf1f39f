"""A plain reference of ``grm learn scm`` with cross-validation: the split
and its risk tables, the greedy Set Covering Machine over every fold and
hyperparameter, the choice of hyperparameters, the full training with its
equivalent rules and importances, the predictions, metrics, bound and
classifications.

It follows Kover's published code (``learning/learners/scm.py``,
``learning/experiments/experiment_scm.py``, ``dataset/split.py``; Drouin
et al. 2019): the utilities in float64 scanned in blocks of 1,000,000
rules with NumPy's ``allclose``/``isclose`` accumulating ties across
blocks, rules that cover no negative and err on no positive skipped, ties
broken by the fold's rounded risk table, a model's test risk at every
length with the last length repeated. It uses NumPy and plain PyTorch
only, and nothing of the program: it reads the artifact's arrays as the
benchmark made them.

The counts come from products of 0/1 int8 matrices (``torch._int_mm``):
a chunk of columns unpacked from the packed words times a row of 0/1 per
example set. ``dtype`` is the precision of the utilities, risks, scores
and importances: float64 as Kover computes them, float32 for the control.
"""

from __future__ import annotations

import contextlib
import time
from itertools import product
from math import ceil, comb, exp, log as ln, pi

import numpy as np
import torch

UTIL_BLOCK = 1_000_000  # Kover's utility scan block (scm.py:29)


@contextlib.contextmanager
def phase(timings, name, device):
    """Add the seconds of the block to ``timings[name]`` (a dict, or None
    to time nothing), the card synchronized at both ends."""
    if timings is None:
        yield
        return
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    yield
    sync()
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def min_uint(max_value):
    """The smallest unsigned dtype that holds ``max_value``."""
    for dt in (np.uint8, np.uint16, np.uint32):
        if max_value <= np.iinfo(dt).max:
            return dt
    return np.uint64


class PackedMatrix:
    """The artifact's (W64, K) uint64 MSB-first matrix on ``device``, and
    column counts over sets of examples."""

    def __init__(self, m64, n_genomes, device, chunk_cols=1 << 20):
        self.m64 = m64
        self.n = int(n_genomes)
        self.w64, self.k = m64.shape
        self.device = torch.device(device)
        self.chunk = chunk_cols
        self.words = torch.from_numpy(m64.view(np.int64)).to(self.device)
        # A chunk unpacks to 64 positions a word: position 64 w + 8 j + u
        # is bit 7 - u of little-endian byte j, genome 64 w + 8 (7 - j) + u.
        pos = np.arange(self.w64 * 64)
        self.genome_at = (64 * (pos // 64) + 8 * (7 - (pos % 64) // 8)
                          + pos % 8)
        self._mm_transposed = True
        # Byte v -> the int64 whose little-endian byte u is bit 7 - u of v.
        v = np.arange(256)
        bits = sum(((v >> (7 - u)) & 1).astype(np.int64) << (8 * u)
                   for u in range(8))
        self._bits = torch.from_numpy(bits).to(self.device)

    def column(self, col):
        """(n,) uint8: the presence of k-mer ``col`` in each genome."""
        bits = np.unpackbits(self.m64[:, col].astype(">u8").view(np.uint8))
        return bits[:self.n]

    def words32(self, lo, hi):
        """Columns [lo, hi) as (ceil(n / 32), hi - lo) int32 word rows:
        row 2 w the high half of uint64 row w, row 2 w + 1 the low half."""
        w = self.words[:, lo:hi]
        halves = torch.stack(((w >> 32).to(torch.int32), w.to(torch.int32)),
                             dim=1).reshape(2 * self.w64, hi - lo)
        return halves[:-(-self.n // 32)]

    def _dense_t(self, lo, hi):
        """Columns [lo, hi) unpacked: (hi - lo padded to 8, 64 W64) int8,
        a row a column, in the storage order of ``genome_at``: each byte
        of the packed words looked up as the int64 whose bytes are its
        bits, most significant first."""
        c = hi - lo
        cp = -(-c // 8) * 8
        b = self.words[:, lo:hi].t().contiguous().reshape(-1).view(
            torch.uint8).view(c, self.w64 * 8)
        out = torch.zeros((cp, self.w64 * 8), dtype=torch.int64,
                          device=self.device)
        out[:c] = self._bits[b.to(torch.int64)]
        return out.view(torch.int8).view(cp, self.w64 * 64)

    def counts(self, masks):
        """(R, K) int32 on the device: for each 0/1 row of ``masks`` (R, n),
        the number of its examples in which each k-mer is present."""
        masks = np.asarray(masks, dtype=np.int8)
        r = masks.shape[0]
        rp = max(24, -(-r // 8) * 8)
        a = np.zeros((rp, self.w64 * 64), np.int8)
        ok = self.genome_at < self.n
        a[:r, ok] = masks[:, self.genome_at[ok]]
        a = torch.from_numpy(a).to(self.device)
        out = torch.empty((r, self.k), dtype=torch.int32, device=self.device)
        for lo in range(0, self.k, self.chunk):
            hi = min(self.k, lo + self.chunk)
            dense = self._dense_t(lo, hi)
            out[:, lo:hi] = self._product(a, dense)[:r, :hi - lo]
            del dense
        return out

    def _product(self, a, dense_t):
        if self.device.type != "cuda":
            return (a.float() @ dense_t.t().float()).to(torch.int32)
        if self._mm_transposed:
            try:
                return torch._int_mm(a, dense_t.t())
            except RuntimeError:
                self._mm_transposed = False
        return torch._int_mm(a, dense_t.t().contiguous())


# -- the split (dataset/split.py:86-231) -------------------------------------

def split_indices(n_genomes, train_prop, random_seed, n_folds):
    """(train, test, fold of each training genome), as Kover draws them:
    one RandomState shuffles the genomes, then the folds."""
    rng = np.random.RandomState(random_seed)
    n_train = int(ceil(train_prop * n_genomes))
    idx = np.arange(n_genomes)
    rng.shuffle(idx)
    train, test = idx[:n_train], idx[n_train:]
    fold_of = None
    if n_folds > 0:
        fold_of = np.arange(len(train)) % n_folds
        rng.shuffle(fold_of)
    return train, test, fold_of


def risk_table(n_pos, n_neg, counts_pos, counts_neg):
    """(unique risks, index of each k-mer's, of each anti-k-mer's): risks
    rounded to 5 decimals (split.py:178-188)."""
    risk = ((float(n_pos) - counts_pos.to(torch.float64)) + counts_neg
            .to(torch.float64)) / float(n_pos + n_neg)
    risk = torch.round(risk, decimals=5)
    anti = torch.round(1.0 - risk, decimals=5)
    uniq, inv = torch.unique(torch.cat((risk, anti)), sorted=True,
                             return_inverse=True)
    k = counts_pos.shape[0]
    return uniq.cpu().numpy(), inv[:k].cpu().numpy(), inv[k:].cpu().numpy()


def make_split(pm, labels, train_prop, random_seed, n_folds):
    """The split and its risk tables, as a dict of NumPy arrays."""
    labels = np.asarray(labels)
    train, test, fold_of = split_indices(pm.n, train_prop, random_seed,
                                         n_folds)
    sets = [(train, None)]
    for f in range(n_folds):
        sets.append((train[fold_of != f], train[fold_of == f]))
    rows = []
    for tr, _ in sets:
        for cls in (1, 0):
            row = np.zeros(pm.n, np.int8)
            row[tr[labels[tr] == cls]] = 1
            rows.append(row)
    counts = pm.counts(np.stack(rows))
    out = {"train": np.sort(train), "test": np.sort(test), "folds": []}
    for i, (tr, te) in enumerate(sets):
        n_pos = int((labels[tr] == 1).sum())
        table = risk_table(n_pos, len(tr) - n_pos, counts[2 * i],
                           counts[2 * i + 1])
        if te is None:
            out["risks"] = table
        else:
            out["folds"].append({"train": np.sort(tr), "test": np.sort(te),
                                 "risks": table})
    return out


def write_split(group, split, name, random_seed, n_genomes):
    """Write ``split`` under ``group`` (the artifact's root, h5py-like) as
    ``splits/<name>``, in Kover's layout."""
    idx_dt = min_uint(n_genomes)
    splits = group["splits"] if "splits" in group else \
        group.create_group("splits")
    grp = splits.create_group(name)
    grp.attrs["random_seed"] = random_seed
    grp.attrs["n_folds"] = len(split["folds"])
    grp.attrs["train_proportion"] = len(split["train"]) / n_genomes
    grp.attrs["test_proportion"] = len(split["test"]) / n_genomes

    def put(g, tr, te, risks):
        g.create_dataset("train_genome_idx", data=tr, dtype=idx_dt)
        g.create_dataset("test_genome_idx", data=te, dtype=idx_dt)
        uniq, by_kmer, by_anti = risks
        dt = min_uint(len(uniq))
        g.create_dataset("unique_risks", data=uniq)
        g.create_dataset("unique_risk_by_kmer", data=by_kmer, dtype=dt)
        g.create_dataset("unique_risk_by_anti_kmer", data=by_anti, dtype=dt)

    put(grp, split["train"], split["test"], split["risks"])
    if split["folds"]:
        folds = grp.create_group("folds")
        for i, f in enumerate(split["folds"]):
            put(folds.create_group("fold_%d" % (i + 1)), f["train"],
                f["test"], f["risks"])


# -- metrics and bound (metrics.py:24-92, experiment_scm.py:349-398) ---------

def binary_metrics(pred, answers, dtype=np.float64):
    """Kover's binary metrics of one row of predictions."""
    pred, y = np.asarray(pred), np.asarray(answers)
    tp = int(((pred == 1) & (y == 1)).sum())
    fp = int(((pred == 1) & (y == 0)).sum())
    tn = int(((pred == 0) & (y == 0)).sum())
    fn = int(((pred == 0) & (y == 1)).sum())
    f = dtype

    def ratio(a, b):
        return float(f(a) / f(b)) if b != 0 else float("-inf")

    precision, recall = ratio(tp, tp + fp), ratio(tp, tp + fn)
    pr = f(precision) + f(recall)
    f1 = float(f(2.0) * f(precision) * f(recall) / pr) if pr > 0 \
        else float("-inf")
    return {"risk": [float(f((pred != y).sum()) / f(len(y)))],
            "tp": [tp], "fp": [fp], "tn": [tn], "fn": [fn],
            "precision": [precision], "sensitivity": [recall],
            "recall": [recall], "specificity": [ratio(tn, fp + tn)],
            "f1_score": [f1]}


def compression_set(presence):
    """Chvatal's greedy set cover of the model's k-mer columns by
    training examples (experiment_scm.py:358-372)."""
    out = []
    presence = np.asarray(presence)
    while presence.shape[1] != 0:
        score = presence.sum(axis=1)
        if score.max() == 0:
            break
        best = int(np.argmax(score))
        out.append(best)
        presence = presence[:, presence[best] == 0]
    return out


def scm_bound(pred, answers, presence, n_rules, delta, max_genome_size,
              dtype=np.float64):
    """The SCM sample-compression bound as Kover computes it, including
    its operator precedence: a non-empty model's bound leaves out the
    combinations terms."""
    cs = compression_set(presence) if n_rules else []
    f = dtype
    h, m, mz = f(n_rules), f(len(answers)), f(len(cs))
    z = f(len(cs) * max_genome_size)
    pred, answers = np.asarray(pred), np.asarray(answers)
    r = f((pred != answers).sum() - (pred[cs] != answers[cs]).sum())
    if h == 0:
        inner = f(ln(comb(int(m), int(mz)))) + f(ln(comb(int(m - mz),
                                                          int(r))))
    else:
        inner = h * f(ln(f(2) * z)) + f(ln(f(pi ** 6) * (h + 1) ** 2
                                           * (r + 1) ** 2 * (mz + 1) ** 2
                                           / (f(216) * f(delta))))
    return float(f(1.0) - f(exp(f(-1.0) / (m - mz - r) * inner)))


# -- the greedy fits (scm.py:60-288) -----------------------------------------

class Fit:
    """One greedy SCM run: its examples (swapped for a disjunction), its p
    and the tie-break table; the rules and tie sets it chose."""

    def __init__(self, model_type, p, pos, neg, risks, test=None):
        if model_type == "disjunction":
            pos, neg = neg, pos
        self.model_type, self.p = model_type, p
        self.pos, self.neg = np.asarray(pos), np.asarray(neg)
        self.train = np.hstack((self.pos, self.neg))
        self.risks = risks  # (unique risks, by k-mer, by anti-k-mer)
        self.test = test
        self.rules, self.ties = [], []
        self.done = len(self.neg) == 0


def block_parts(block_max, dtype):
    """Kover's scan over the blocks' maxima (scm.py:258-286): the blocks
    whose ties count, each with the maximum its ties are close to. Ties
    accumulate while a block's maximum is ``allclose`` to the best so far
    (with the arguments in Kover's order); a larger one starts afresh."""
    best, parts = dtype(-np.inf), []
    for b, bmax in enumerate(block_max):
        if bmax > best or np.allclose(best, bmax):
            if np.allclose(bmax, best):
                parts.append((b, bmax))
            else:
                best, parts = bmax, [(b, bmax)]
    return parts


def greedy_steps(group, cn, cp, n_kmers, dtype):
    """Kover's ``_get_best_utility_rules`` and tie-break for a group of
    fits, from the device counts ``cn`` / ``cp`` (G, K) of their remaining
    negatives and positives. Returns each fit's tie set (rule indices), or
    None where it stops."""
    dev = cn.device
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    g = len(group)
    n_neg = torch.tensor([[len(f.neg)] for f in group], device=dev)
    n_pos = torch.tensor([[len(f.pos)] for f in group], device=dev)
    p = torch.tensor([[f.p] for f in group], dtype=tdt, device=dev)
    n_rules = 2 * n_kmers
    sizes = [UTIL_BLOCK] * (n_rules // UTIL_BLOCK)
    if n_rules % UTIL_BLOCK:
        sizes.append(n_rules % UTIL_BLOCK)
    util = torch.empty((g, n_rules), dtype=tdt, device=dev)
    live = torch.empty((g, n_rules), dtype=torch.bool, device=dev)
    for half, (cover, err) in enumerate((((n_neg - cn), (n_pos - cp)),
                                         (cn, cp))):
        cover, err = cover.to(torch.int64), err.to(torch.int64)
        lo = half * n_kmers
        util[:, lo:lo + n_kmers] = cover.to(tdt) - p * err.to(tdt)
        live[:, lo:lo + n_kmers] = (cover != 0) | (err != 0)
        del cover, err
    block_max = torch.stack([b.amax(dim=1) for b in
                             torch.split(util, sizes, dim=1)], 1)
    block_max = block_max.cpu().numpy()
    thr = np.full((g, len(sizes)), np.nan, dtype)
    for i in range(g):
        for b, bmax in block_parts(block_max[i], dtype):
            thr[i, b] = bmax
    thr = torch.repeat_interleave(
        torch.from_numpy(thr).to(dev),
        torch.tensor(sizes, device=dev), dim=1)
    close = torch.isclose(util, thr, rtol=1e-5, atol=1e-8) & live
    del util, live, thr
    hits = torch.nonzero(close).cpu().numpy()
    out = []
    for i, f in enumerate(group):
        cands = hits[hits[:, 0] == i, 1]
        if len(cands) <= 1:
            out.append(cands if len(cands) else None)
            continue
        by_kmer, by_anti = f.risks[1], f.risks[2]
        risks = np.where(cands < n_kmers,
                         by_kmer[np.minimum(cands, n_kmers - 1)],
                         by_anti[np.maximum(cands - n_kmers, 0)]
                         ).astype(np.int64)
        pick = risks.min() if f.model_type == "conjunction" else risks.max()
        out.append(cands[np.isclose(risks, pick)])
    return out


def run_fits(pm, fits, max_rules, dtype, group=16, timings=None):
    """Every fit's greedy run: all fits' counts of a step in one pass over
    the matrix, their choices ``group`` fits at a time."""
    k = pm.k
    while True:
        live = [f for f in fits if not f.done]
        if not live:
            return
        rows = np.zeros((2 * len(live), pm.n), np.int8)
        for i, f in enumerate(live):
            rows[2 * i, f.neg] = 1
            rows[2 * i + 1, f.pos] = 1
        with phase(timings, "counts", pm.device):
            counts = pm.counts(rows)
        for g0 in range(0, len(live), group):
            part = live[g0:g0 + group]
            with phase(timings, "choices", pm.device):
                ties_list = greedy_steps(
                    part, counts[2 * g0:2 * (g0 + len(part)):2],
                    counts[2 * g0 + 1:2 * (g0 + len(part)):2], k, dtype)
            for f, ties in zip(part, ties_list):
                if ties is None:
                    f.done = True
                    continue
                win = int(ties[0])
                col = pm.column(win % k)
                votes = col if win < k else 1 - col
                f.rules.append(win)
                f.ties.append(ties)
                f.neg = f.neg[votes[f.neg] != 0]
                f.pos = f.pos[votes[f.pos] != 0]
                f.done = len(f.neg) == 0 or len(f.rules) >= max_rules
        del counts


def rule_votes(pm, rule_idx):
    """(n, len(rule_idx)) uint8: each rule's vote on every genome."""
    k = pm.k
    out = np.empty((pm.n, len(rule_idx)), np.uint8)
    for j, r in enumerate(rule_idx):
        col = pm.column(r % k)
        out[:, j] = col if r < k else 1 - col
    return out


def predict(pm, model_type, rule_idx, examples):
    """The model's predictions on ``examples``. ``rule_idx`` are the rules
    as the greedy run chose them: a disjunction's model holds their
    inverses, and predicts 1 where any of them votes 0."""
    votes = rule_votes(pm, rule_idx)[examples]
    all_one = votes.prod(axis=1) if len(rule_idx) else \
        np.ones(len(examples), np.uint8)
    if model_type == "conjunction":
        return all_one.astype(np.uint8)
    return (1 - all_one).astype(np.uint8)


def hp_selection(hp_list, scores_by_hp):
    """Kover's choice among (model type, p) by CV score: a better score; an
    equal (allclose) one with a shorter model; an equal length with p
    closer to 1 (experiment_scm.py:233-246)."""
    best_score = 1.0
    best = {"model_type": None, "p": None, "max_rules": None}
    for (mt, p), (length, score) in zip(hp_list, scores_by_hp):
        close = np.allclose(score, best_score)
        if ((not close and score < best_score)
                or (close and best["max_rules"] is not None
                    and length < best["max_rules"])
                or (close and best["max_rules"] is not None
                    and length == best["max_rules"]
                    and not np.allclose(p, best["p"])
                    and abs(1.0 - p) < abs(1.0 - best["p"]))):
            best = {"model_type": mt, "p": p, "max_rules": length}
            best_score = score
    return best_score, best


def learn_scm(pm, labels, genome_ids, kmer_sequences, split, settings,
              dtype=np.float64, timings=None):
    """Everything ``learn_SCM(parameter_selection="cv")`` decides, as a
    fingerprint (see :func:`fingerprint`). ``split`` as
    :func:`make_split` gives it; ``settings`` the configuration's SCM
    settings."""
    labels = np.asarray(labels)
    k = pm.k
    model_types = sorted(set(settings["model_type"]))
    p_values = sorted(set(float(p) for p in settings["p"]))
    max_rules = int(settings["max_rules"])
    hp_list = list(product(model_types, p_values))

    def pos_neg(idx):
        return idx[labels[idx] == 1], idx[labels[idx] == 0]

    cv = [Fit(mt, p, *pos_neg(f["train"]), f["risks"],
              test=f["test"]) for mt, p in hp_list for f in split["folds"]]
    full = [Fit(mt, p, *pos_neg(split["train"]), split["risks"])
            for mt, p in hp_list]
    run_fits(pm, cv + full, max_rules, dtype, timings=timings)
    t_rest = time.perf_counter()

    n_folds = len(split["folds"])
    scores = []
    for h in range(len(hp_list)):
        fold_risk = np.empty((n_folds, max_rules + 1), dtype)
        for i, f in enumerate(cv[h * n_folds:(h + 1) * n_folds]):
            y = labels[f.test]
            for length in range(max_rules + 1):
                pred = predict(pm, f.model_type, f.rules[:length], f.test)
                fold_risk[i, length] = dtype((pred != y).sum()) / dtype(
                    len(y))
        by_len = np.mean(fold_risk, axis=0)
        best_len = int(np.argmin(by_len))
        scores.append((best_len, by_len[best_len]))
    best_score, best = hp_selection(hp_list, scores)

    fit = full[hp_list.index((best["model_type"], best["p"]))]
    n_rules = best["max_rules"]
    rule_idx = fit.rules[:n_rules]
    rng = np.random.RandomState(settings["random_seed"])
    equiv = []
    for ties in fit.ties[:n_rules]:
        ties = np.asarray(ties)
        if len(ties) > settings["max_equiv_rules"]:
            pick = rng.choice(len(ties), settings["max_equiv_rules"],
                              replace=False)
            pick.sort()
            ties = ties[pick]
        if fit.model_type == "disjunction":
            ties = (ties + k) % (2 * k)
        equiv.append(ties)
    if rule_idx:
        votes = rule_votes(pm, rule_idx)[fit.train]
        rejected = np.where(np.prod(votes, axis=1) == 0)[0]
        importances = (dtype(len(rejected)) - votes[rejected].sum(axis=0)
                       .astype(dtype)) / dtype(len(rejected))
    else:
        importances = np.array([])

    train, test = split["train"], split["test"]
    mt = fit.model_type
    train_pred = predict(pm, mt, rule_idx, train)
    test_pred = predict(pm, mt, rule_idx, test)
    train_m = binary_metrics(train_pred, labels[train], dtype)
    kmers = [r % k for r in rule_idx]
    presence = np.stack([pm.column(c) for c in kmers], axis=1)[train] \
        if kmers else np.zeros((len(train), 0), np.uint8)
    train_m["bound"] = scm_bound(train_pred, labels[train], presence,
                                 len(rule_idx), settings["bound_delta"], k,
                                 dtype)
    test_m = binary_metrics(test_pred, labels[test], dtype) if len(test) \
        else None

    cls = {}
    ids = np.asarray(genome_ids)
    ok_tr = train_pred == labels[train]
    cls["train_correct"] = ids[train[ok_tr]].tolist() \
        if train_m["risk"][0] < 1.0 else []
    cls["train_errors"] = ids[train[~ok_tr]].tolist() \
        if train_m["risk"][0] > 0 else []
    if len(test):
        ok_te = test_pred == labels[test]
        cls["test_correct"] = ids[test[ok_te]].tolist() \
            if test_m["risk"][0] < 1.0 else []
        cls["test_errors"] = ids[test[~ok_te]].tolist() \
            if test_m["risk"][0] > 0 else []

    def rule(i, invert):
        rtype = "absence" if i >= k else "presence"
        if invert:
            rtype = "presence" if rtype == "absence" else "absence"
        seq = kmer_sequences[int(i % k)]
        return (seq.decode() if isinstance(seq, bytes) else str(seq), rtype)

    if timings is not None:
        timings["the rest"] = time.perf_counter() - t_rest
    return {
        "hp": [best["model_type"], float(best["p"]), int(n_rules)],
        "rules": [rule(i, mt == "disjunction") for i in rule_idx],
        "equiv": [[rule(int(i), False) for i in e] for e in equiv],
        "cls": {key: sorted(v) for key, v in cls.items()},
        "floats": dict(
            [("score", float(best_score))]
            + [("importance.%d" % i, float(v))
               for i, v in enumerate(importances)]
            + metric_floats("train", train_m)
            + (metric_floats("test", test_m) if test_m else [])),
        "ints": dict(metric_ints("train", train_m)
                     + (metric_ints("test", test_m) if test_m else [])),
    }


INT_METRICS = ("tp", "fp", "tn", "fn")


def metric_floats(prefix, metrics):
    return [("%s.%s" % (prefix, key), float(np.asarray(v).ravel()[0]))
            for key, v in sorted(metrics.items()) if key not in INT_METRICS]


def metric_ints(prefix, metrics):
    return [("%s.%s" % (prefix, key), int(np.asarray(v).ravel()[0]))
            for key, v in sorted(metrics.items()) if key in INT_METRICS]
