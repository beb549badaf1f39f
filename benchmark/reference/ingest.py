"""A plain reference of the device ingest and the fit after it: the union
of the genomes' canonical k-mers, the packed presence matrix, and the
greedy SCM of ``pipeline.train_scm``.

A k-mer is the canonical (lexicographically smaller) of a window and its
reverse complement, with A < C < G < T and a window over a code past 3
(an invalid base or a contig separator) left out; the union is every
k-mer present in at least ``min_genomes`` genomes (2: the singleton
filter), sorted. The matrix holds genome g at bit 31 - g % 32 of word row
g // 32 (int32 bit patterns), a column a union k-mer. A union k-mer's
words: big-endian, bases MSB-first, the last word left-aligned.

The fit is ``train_scm``'s: a seeded shuffle and ``ceil(0.75 n)``
training genomes, then greedy steps with utility = negatives covered - p
x positives missed, each step's best presence rule first, an absence rule
only where strictly better, the lowest column among equals; no rule that
covers nothing and misses nothing. Plain PyTorch on the card and NumPy;
nothing of the program.
"""

from __future__ import annotations

from math import ceil

import numpy as np
import torch

from . import scm as scm_ref


def canonical_keys(codes, k, canonical=True):
    """The sorted distinct k-mers of one genome's codes ((L,) int8 tensor):
    (n,) int64, base 0 most significant. ``canonical=False`` keeps the
    forward strand only (a control)."""
    n_win = codes.shape[0] - k + 1
    if n_win <= 0:
        return torch.empty(0, dtype=torch.int64, device=codes.device)
    c = codes.to(torch.int64)
    fwd = torch.zeros(n_win, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        cj = c[j:j + n_win]
        fwd = (fwd << 2) | (cj & 3)
        rc |= (3 - (cj & 3)) << (2 * j)
    bad = torch.cumsum(torch.cat((torch.zeros(1, dtype=torch.int64,
                                              device=c.device),
                                  (c > 3).to(torch.int64))), 0)
    valid = (bad[k:] - bad[:n_win]) == 0
    keys = torch.minimum(fwd, rc) if canonical else fwd
    return torch.unique(keys[valid], sorted=True)


def union_of(genome_keys, min_genomes, n_parts=16):
    """The sorted k-mers present in at least ``min_genomes`` of the genomes'
    sorted key arrays, counted in ``n_parts`` ranges of the key space."""
    dev = genome_keys[0].device
    top = 1 << 62
    edges = torch.tensor([p * (top // n_parts) for p in range(1, n_parts)]
                         + [top], dtype=torch.int64, device=dev)
    cuts = [torch.searchsorted(g, edges).cpu().tolist() for g in genome_keys]
    out, lo = [], [0] * len(genome_keys)
    for p in range(n_parts):
        part = torch.cat([g[lo[i]:cuts[i][p]]
                          for i, g in enumerate(genome_keys)])
        lo = [c[p] for c in cuts]
        if part.numel() == 0:
            continue
        keys, counts = torch.unique(part, sorted=True, return_counts=True)
        out.append(keys[counts >= min_genomes])
    return torch.cat(out) if out else torch.empty(0, dtype=torch.int64,
                                                  device=dev)


def presence(genome_keys, union):
    """(n_genomes, U) bool: which genome holds which union k-mer."""
    out = torch.empty((len(genome_keys), union.numel()), dtype=torch.bool,
                      device=union.device)
    for g, keys in enumerate(genome_keys):
        if keys.numel() == 0:
            out[g] = False
            continue
        pos = torch.searchsorted(keys, union).clamp_(max=keys.numel() - 1)
        out[g] = keys[pos] == union
    return out


def pack_rows(dense):
    """(ceil(n / 32), U) int32: genome g at bit 31 - g % 32 of row g // 32."""
    n, u = dense.shape
    out = torch.zeros((-(-n // 32), u), dtype=torch.int32,
                      device=dense.device)
    for g in range(n):
        out[g // 32] |= dense[g].to(torch.int32) << (31 - g % 32)
    return out


def key_words(keys, k):
    """(U, ceil(k / 16)) int32: each k-mer's words, big-endian, bases
    MSB-first, the last word left-aligned (k <= 31)."""
    pad = 32 * -(-k // 16) - 2 * k
    v = keys << pad  # left-align the k-mer in 64 bits of words
    return torch.stack(((v >> 32).to(torch.int32), v.to(torch.int32)),
                       dim=1)[:, :-(-k // 16)]


def decode(key, k):
    """One k-mer's bases as a string."""
    return "".join("ACGT"[(int(key) >> (2 * (k - 1 - j))) & 3]
                   for j in range(k))


def train_scm(dense, labels, model_type, p, max_rules, train_prop,
              random_seed):
    """``pipeline.train_scm``'s fit on the (n, U) presence ``dense``.
    Returns (rule indices, train index, test index); a rule index past U
    is the absence of k-mer index - U."""
    labels = np.asarray(labels)
    n, u = dense.shape
    rng = np.random.RandomState(random_seed)
    idx = np.arange(n)
    rng.shuffle(idx)
    n_train = int(ceil(train_prop * n))
    train, test = np.sort(idx[:n_train]), np.sort(idx[n_train:])
    pos, neg = train[labels[train] == 1], train[labels[train] == 0]
    if model_type == "disjunction":
        pos, neg = neg, pos
    rules = []
    dev = dense.device
    while len(rules) < max_rules and len(neg) > 0:
        cn = dense[torch.as_tensor(neg, device=dev)].sum(0, dtype=torch.int64)
        cp = dense[torch.as_tensor(pos, device=dev)].sum(0, dtype=torch.int64)
        n_neg, n_pos = len(neg), len(pos)
        u_pres = (n_neg - cn).double() - p * (n_pos - cp).double()
        u_pres[(cn == n_neg) & (cp == n_pos)] = -np.inf
        u_abs = cn.double() - p * cp.double()
        u_abs[(cn == 0) & (cp == 0)] = -np.inf
        bp, ba = int(torch.argmax(u_pres)), int(torch.argmax(u_abs))
        use_abs = bool(u_abs[ba] > u_pres[bp])
        col = ba if use_abs else bp
        votes = dense[:, col].cpu().numpy().astype(np.uint8)
        if use_abs:
            votes = 1 - votes
        rules.append(col + u if use_abs else col)
        neg = neg[votes[neg] != 0]
        pos = pos[votes[pos] != 0]
    return rules, train, test


def fit_fingerprint(dense, union, labels, fit, k):
    """The fit's rules and metrics, in the form the job compares."""
    rules, train, test = train_scm(dense, labels, **fit)
    u = union.numel()
    model = [(decode(union[r % u], k), "absence" if r >= u else "presence")
             for r in rules]
    if fit["model_type"] == "disjunction":
        model = [(s, "presence" if t == "absence" else "absence")
                 for s, t in model]
    votes = np.ones(dense.shape[0], np.uint8)
    for s_t, r in zip(model, rules):
        col = dense[:, r % u].cpu().numpy().astype(np.uint8)
        v = col if s_t[1] == "presence" else 1 - col
        votes = votes * v if fit["model_type"] == "conjunction" else \
            votes * (1 - v)
    pred = votes if fit["model_type"] == "conjunction" else 1 - votes
    labels = np.asarray(labels)
    train_m = scm_ref.binary_metrics(pred[train], labels[train])
    test_m = scm_ref.binary_metrics(pred[test], labels[test])
    return {"rules": model,
            "floats": dict(scm_ref.metric_floats("train", train_m)
                           + scm_ref.metric_floats("test", test_m)),
            "ints": dict(scm_ref.metric_ints("train", train_m)
                         + scm_ref.metric_ints("test", test_m))}


def ingest(codes_list, k, min_genomes, device, canonical=True):
    """(union keys (U,) int64, (n, U) presence) of the genomes' codes."""
    keys = [canonical_keys(torch.from_numpy(np.asarray(c)).to(device), k,
                           canonical) for c in codes_list]
    union = union_of(keys, min_genomes)
    dense = presence(keys, union)
    del keys
    return union, dense
