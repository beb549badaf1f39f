#!/usr/bin/env python3
"""Smoke run of grm_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, checks the device engines
against the host engines at reduced size, then drives ``learn scm`` and
``learn tree`` at the published median scale, each through two engines.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero and prints no result):

1. Device: the card's name, power limit and maximum SM clock.
2. Build: ``nvcc`` for ``sm_90a``, one process per source, from
   ``grm_tpu_torch/csrc``; the build seconds and each kernel's registers.
3. Kernels against their plain versions, exact equality: popcount_colsum
   at W = 11, K = 1,000,003, C = 1, 2, 10, 12; the pair-batched entry with
   ragged offsets; both scm_sweep epilogues at F = 100 and 128, K ragged and
   K below one block, the published p grid and dyadic p, with and without
   an exclusion mask; at the largest published genome count (W = 157); and
   fit counts, depths and widths that leave the tensor-core tiles ragged:
   F = 1, 3, 5, 101 and 256, W = 1, 12, 13 and 157, K = 5001 with the limit
   inside it, a 16-column tile banned in both rows.
   cart_sweep at the same widths: N = 1, 37 and 200 nodes, C = 2 and 3
   classes, Gini and cross-entropy, shared and per-node priors, with and
   without an exclusion mask, a node with an empty class and a node with no
   valid split; and frontiers and depths that leave the kernel's tiles
   ragged: N = 9, 17, 18 and (W = 157) 65 nodes, W = 12 (exactly three
   128-bit steps) and W = 13 (a fourth), C = 3 and 5. Gini: columns and
   scores equal. Cross-entropy: columns equal, scores equal or at most 2
   ulps apart (the kernel's logf and torch.log come from two toolkits); the
   largest distance is printed.
4. Correctness at reduced size: a 342 x 200,000 in-memory artifact with a
   5-fold split; ``learn_SCM(engine="device")`` must give the host
   engine's fingerprint (hyperparameters, score, rules, tie sets,
   importances, metrics, classifications), and ``learn_CART(engine=
   "device-argmax")`` the host engine's tree and train and test metrics
   (the argmax engine keeps no tie sets).
5. The main paths at full scale: 342 genomes x 9,600,000 k-mers (the
   published median, BASELINE.md), 5-fold split, built in memory from
   --seed with the benchmark's recipe (a planted 3-marker conjunction plus
   decoys). Four paths, each driven with the launch counts set to 0 just
   before it and read just after: ``learn_SCM(engine="device")`` over the
   2 model types x 10 p grid, max 10 rules, plus ``write_scm_outputs``
   (what ``learn scm`` runs by default); ``learn_SCM(engine=
   "device-argmax")``; ``learn_CART(engine="device-argmax")`` with both
   criteria, depth 10, plus ``write_cart_outputs``; and
   ``learn_CART(engine="host")`` with Gini, depth 3. Each path must launch
   the kernels it is built on (PATH_KERNELS) and learn a model with at
   least one rule and finite importances. One more SCM run through each
   device engine and one more argmax CART run under torch.profiler must
   give the same fingerprints, and give the device time by kernel and the
   device's busy share of the run.
6. The card's measured instruction rates (csrc/bmma_probe.cu): the 1-bit
   tensor-core product (AND + POPC, ``mma.sync`` k256 and k128), scalar
   POPC, the special-function unit and the two together, and whether the
   machine code holds the tensor-core instruction (BMMA); the BMMA, POPC
   and IMMA counts of the scm_sweep and cart_sweep libraries (the run fails
   if scm_sweep holds no BMMA or any POPC; skipped, and said, where the
   toolkit has no cuobjdump). Then each kernel
   at the main paths' shapes (cart_sweep at the largest frontier phase 5
   saw, by look-up scores with two classes and by direct scores with
   three): its device time per call from torch.profiler (CUDA events only
   if the profiler sees no device time), its plain version timed once, and
   ``bound_ms``, the least time the card could take: the largest of the
   bytes over the memory rate, the AND + POPC counting as a 1-bit product
   at the measured tensor-core rate, and the divisions and logs of the
   distinct splits at the measured special-function rate.
   ``bound_ms_popc`` keeps, for comparison with earlier readings, the
   bound with the counting and one score per (node, column) on the scalar
   POPC pipe. Both scm_sweep shapes are also timed under a k-mer blacklist
   (a banned k-mer bans its presence and its absence rule) of 0.1%, 1% and
   20% of the columns at random, and with 1% of the presence rules banned
   alone (the kernel's one-tile path), each equal to its plain version.

The last lines of standard output are the kernels' JSON line, the card's
``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``. In the kernels' line, ``launches`` is
the sum of the four paths' counts and ``launches_by_path`` gives each
path's own. Kernel libraries are built into ``grm_tpu_torch/_kernels/``.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
P_GRID = [0.1, 0.178, 0.316, 0.562, 1.0, 1.778, 3.162, 5.623, 10.0,
          999999.0]
MEDIAN_GENOMES, MEDIAN_KMERS = 342, 9_600_000  # BASELINE.md
SMALL_KMERS = 200_000
SMALL_DEPTH = 3  # phase 4: the depth of the planted 3-marker conjunction
N_FOLDS = 5
MAX_RULES = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
POPC_PER_CLOCK_PER_SM = 16  # CUDA C++ Programming Guide, throughput, cc 9.0

KERNELS = {
    "popcount_colsum": ("grm_tpu_torch/csrc/popcount_colsum.cu",
                        "grm_tpu/ops/pallas_popcount.py:94"),
    "popcount_colsum_pairs": ("grm_tpu_torch/csrc/popcount_colsum.cu",
                              "grm_tpu/ops/pallas_popcount.py:94"),
    "scm_sweep_argmax": ("grm_tpu_torch/csrc/scm_sweep.cu",
                         "grm_tpu/ops/pallas_scm_sweep.py:211"),
    "scm_sweep_sbmax": ("grm_tpu_torch/csrc/scm_sweep.cu",
                        "grm_tpu/ops/pallas_scm_sweep.py:105"),
    "cart_sweep": ("grm_tpu_torch/csrc/cart_sweep.cu",
                   "grm_tpu/ops/pallas_cart_sweep.py:194"),
}
# The kernels each main path is built on. learn scm: the exact engine's
# pass 1 and pass 2; the argmax engine's CV sweep, its winner-block recount,
# and its full-train fit (parallel/mesh.py). learn tree: the argmax engine's
# frontier sweep; the host engine's per-node class counts.
PATH_KERNELS = {
    "device": ("scm_sweep_sbmax", "popcount_colsum_pairs"),
    "device-argmax": ("scm_sweep_argmax", "popcount_colsum_pairs",
                      "popcount_colsum"),
    "tree-device-argmax": ("cart_sweep",),
    "tree-host": ("popcount_colsum",),
}
# The CUDA function each wrapper launches, as torch.profiler names it.
KERNEL_FUNCTIONS = {
    "popcount_colsum": "colsum_kernel",
    "popcount_colsum_pairs": "colsum_pairs_kernel",
    "scm_sweep_argmax": "scm_sweep_kernel<0,",
    "scm_sweep_sbmax": "scm_sweep_kernel<1,",
    "cart_sweep": ("cart_sweep_kernel", "cart_sweep_table_kernel"),
}
CART_CRITERIA = ("gini", "cross-entropy")
MAX_LOG_ULPS = 2  # cross-entropy scores: kernel logf against torch.log


def log(msg):
    print(msg, flush=True)


# -- data ---------------------------------------------------------------------

def _kmer_sequence_block(start, count, k):
    """(count,) distinct fixed-width k-mers (a base-4 counter)."""
    i = np.arange(start, start + count, dtype=np.uint64)
    out = np.empty((count, k), dtype=np.uint8)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    for j in range(k):
        out[:, k - 1 - j] = lut[((i >> np.uint64(2 * j))
                                 & np.uint64(3)).astype(np.int64)]
    return out.view("S%d" % k)[:, 0]


def synthetic_arrays(n_genomes, n_kmers, seed):
    """The benchmark artifact's recipe (bench.py:254-300), in memory: ~75%
    dense noise, a planted conjunction of three markers (marker i absent on
    third i of the negatives, lightly flip-noised) and 20 noisier decoys."""
    from grm_tpu_torch.utils import pack_binary_bytes_to_ints

    rng = np.random.RandomState(seed)
    labels = np.zeros(n_genomes, np.uint8)
    labels[n_genomes // 2:] = 1  # sorted by label, like the reference
    w64 = -(-n_genomes // 64)
    matrix = np.frombuffer(rng.bytes(w64 * n_kmers * 8),
                           dtype=np.uint64).reshape(w64, n_kmers).copy()
    matrix |= matrix << np.uint64(1)
    valid = pack_binary_bytes_to_ints(np.ones((n_genomes, 1), np.uint8),
                                      64)[:, 0]
    matrix &= valid[:, None]
    neg = np.where(labels == 0)[0]
    marker_cols = rng.choice(n_kmers, 23, replace=False)
    thirds = np.array_split(rng.permutation(neg), 3)
    for i in range(3):
        col = np.ones(n_genomes, np.uint8)
        col[thirds[i]] = 0
        flips = rng.choice(n_genomes, max(1, n_genomes * (1 + i) // 200),
                           replace=False)
        col[flips] = 1 - col[flips]
        matrix[:, marker_cols[i]] = pack_binary_bytes_to_ints(
            col[:, None], 64)[:, 0]
    for i, c in enumerate(marker_cols[3:]):
        col = labels.copy()
        flips = rng.choice(n_genomes, max(2, n_genomes * (30 + 2 * (i % 6))
                                          // 100), replace=False)
        col[flips] = 1 - col[flips]
        matrix[:, c] = pack_binary_bytes_to_ints(col[:, None], 64)[:, 0]
    arrays = {
        "genome_identifiers": np.array([("g%05d" % i).encode()
                                        for i in range(n_genomes)]),
        "phenotype": labels,
        "phenotype_tags": np.array([b"0", b"1"]),
        "kmer_sequences": _kmer_sequence_block(0, n_kmers, 31),
        "kmer_by_matrix_column": np.arange(n_kmers, dtype=np.uint32),
        "kmer_matrix": matrix,
    }
    attrs = {"uuid": "smoke-%dx%d-seed%d" % (n_genomes, n_kmers, seed),
             "genomic_data": "synthetic://median",
             "phenotype_description": "synthetic resistance",
             "phenotype_metadata_source": "synthetic://labels"}
    return arrays, attrs


def build_artifact(n_genomes, n_kmers, seed, device):
    from grm_tpu_torch.dataset import from_numpy_artifact, split_with_proportion

    arrays, attrs = synthetic_arrays(n_genomes, n_kmers, seed)
    mem = from_numpy_artifact(arrays, attrs)
    split_with_proportion(mem, "sp", train_prop=0.67, random_seed=42,
                          n_folds=N_FOLDS, device=device)
    return mem


def _s(x):
    return x.decode() if isinstance(x, bytes) else str(x)


def fingerprint(out):
    """Everything learn_SCM decides (tests/test_reference_oracle.py:114)."""
    best_hp, score, train_m, test_m, model, imps, equiv, cls = out
    norm = lambda m: None if m is None else {
        k: [float(x) for x in v] if isinstance(v, (list, np.ndarray))
        else float(v) for k, v in m.items()}
    key = lambda r: (_s(r.kmer_sequence), _s(r.type))
    return {
        "hp": (_s(best_hp["model_type"]), float(best_hp["p"]),
               int(best_hp["max_rules"])),
        "score": None if score is None else float(score),
        "rules": [key(r) for r in model.rules],
        "importances": [float(v) for v in np.asarray(imps).ravel()],
        "equiv": [sorted(key(e) for e in eq) for eq in equiv],
        "train": norm(train_m),
        "test": norm(test_m),
        "cls": {k: sorted(_s(g) for g in v) for k, v in cls.items()},
    }


def learn(mem, engine, device):
    from grm_tpu_torch.learning.experiments import learn_SCM

    return learn_SCM(
        dataset_file=mem, split_name="sp",
        model_type=["conjunction", "disjunction"], p=P_GRID,
        max_rules=MAX_RULES, max_equiv_rules=10000,
        parameter_selection="cv", random_seed=42, bound_delta=0.05,
        bound_max_genome_size=mem["kmer_sequences"].shape[0],
        engine=engine, device=device)


def learn_tree(mem, engine, device, criterion, max_depth):
    from grm_tpu_torch.learning.experiments import learn_CART

    return learn_CART(
        dataset_file=mem, split_name="sp", criterion=criterion,
        max_depth=[max_depth], min_samples_split=[2],
        class_importance=[{0: 1.0, 1: 1.0}], bound_delta=0.05,
        bound_max_genome_size=mem["kmer_sequences"].shape[0],
        parameter_selection="cv", engine=engine, device=device)


def tree_fingerprint(out, selection=True):
    """Everything learn_CART decides. Without ``selection``, only what the
    host and the argmax engine must agree on: the tree, its rules and
    importances, the metrics and the classifications. Exact ties between
    rules go to the most frequent k-mer on the host and to the lowest column
    in the argmax engine, so tie sets, fold trees, and with them the CV
    score and the pruning alpha, may differ by design."""
    best_hp, score, train_m, test_m, model, imps, equiv, cls = out
    norm = lambda m: None if m is None else {
        k: [float(x) for x in v] for k, v in m.items()}
    key = lambda r: (_s(r.kmer_sequence), _s(r.type))
    fp = {
        "tree": str(model),
        "rules": [key(r) for r in model.decision_tree.rules],
        "importances": [float(imps[r]) for r in model.decision_tree.rules],
        "train": norm(train_m),
        "test": norm(test_m),
        "cls": {k: sorted(_s(g) for g in v) for k, v in cls.items()},
    }
    if selection:
        fp["hp"] = (_s(best_hp["criterion"]), int(best_hp["max_depth"]),
                    float(best_hp["min_samples_split"]),
                    float(best_hp["pruning_alpha"]))
        fp["score"] = float(score)
        fp["equiv"] = [sorted(key(e) for e in equiv[r])
                       for r in model.decision_tree.rules]
    return fp


# -- kernels against their plain versions -------------------------------------

def _words(rng, shape, device):
    import torch

    words = rng.randint(0, 2**32, size=shape, dtype=np.uint64)
    return torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(device)


def fit_inputs(rng, f, n_genomes, p_values, device):
    """Random disjoint neg/pos example masks for f fits and their counts."""
    import torch

    from grm_tpu_torch.utils import build_row_mask

    w = -(-n_genomes // 32)
    neg = np.zeros((f, w), np.uint32)
    pos = np.zeros((f, w), np.uint32)
    for i in range(f):
        y = rng.rand(n_genomes)
        neg[i] = build_row_mask(np.where(y < 0.33)[0], n_genomes, 32)
        pos[i] = build_row_mask(np.where((y >= 0.33) & (y < 0.67))[0],
                                n_genomes, 32)
    count = lambda a: np.unpackbits(a.view(np.uint8), axis=1).sum(1)
    ps = np.asarray(p_values, np.float32)[np.arange(f) % len(p_values)]
    to = lambda a: torch.from_numpy(a).to(device)
    return (to(neg.view(np.int32)), to(pos.view(np.int32)),
            to(count(neg).astype(np.int32)), to(count(pos).astype(np.int32)),
            to(ps))


def frontier_inputs(rng, n, c, n_genomes, per_node, device):
    """A frontier of n nodes over c classes: random disjoint class masks;
    node 0's second class is empty, and (from two nodes on) the last node
    holds one example, so that no rule splits it. Priors and totals are
    shared (c,) or per node (n, c)."""
    import torch

    w = -(-n_genomes // 32)
    masks = np.zeros((n, c, w), np.uint32)
    pick = rng.rand(n, n_genomes) < 0.7
    owner = rng.randint(0, c, size=(n, n_genomes))
    if c > 1:
        owner[0][owner[0] == 1] = 0
    if n > 1:
        pick[-1] = False
        pick[-1, rng.randint(n_genomes)] = True
    bits = np.uint32(1) << (31 - np.arange(n_genomes) % 32).astype(np.uint32)
    for i in range(n):
        for ci in range(c):
            rows = np.where(pick[i] & (owner[i] == ci))[0]
            np.bitwise_or.at(masks[i, ci], rows // 32, bits[rows])
    n_node = np.unpackbits(masks.view(np.uint8), axis=2).sum(2)
    shape = (n, c) if per_node else (c,)
    priors = (rng.rand(*shape) + 0.1).astype(np.float32)
    totals = rng.randint(n_genomes // 2, n_genomes, size=shape)
    to = lambda a: torch.from_numpy(a).to(device)
    return (to(masks.view(np.int32)), to(n_node.astype(np.int32)),
            to(priors), to(totals.astype(np.float32)))


def max_ulps(got, want):
    """Largest distance in float32 steps between two float32 tensors that
    are infinite at the same places; inf if they are not."""
    import torch

    got, want = got.cpu(), want.cpu()
    if got.shape != want.shape or not torch.equal(torch.isinf(got),
                                                  torch.isinf(want)):
        return float("inf")
    fin = torch.isfinite(want)
    if not fin.any():
        return 0
    a = got[fin].view(torch.int32).long()
    b = want[fin].view(torch.int32).long()
    return int((a - b).abs().max())


def compare_cart_blocks(got, want, criterion):
    """(error, ulps) of cart_sweep's (score, col) blocks against the plain
    version's: columns must be equal; Gini scores equal; cross-entropy
    scores at most MAX_LOG_ULPS apart. Raises otherwise."""
    import torch

    if not torch.equal(got[1].cpu(), want[1].cpu()):
        raise AssertionError("cart_sweep (%s): winning columns differ from "
                             "the plain version's" % criterion)
    ulps = max_ulps(got[0], want[0])
    if ulps > (0 if criterion == "gini" else MAX_LOG_ULPS):
        raise AssertionError("cart_sweep (%s): scores %r ulps from the plain "
                             "version's" % (criterion, ulps))
    return max_abs_err(got[0], want[0]), ulps


def max_abs_err(got, want):
    """Exact comparison: equal infinities, then the largest finite gap.
    Tuples of tensors compare element by element."""
    import torch

    if isinstance(got, tuple):
        got = torch.cat([t.flatten() for t in got])
        want = torch.cat([t.flatten() for t in want])
    got, want = got.double().cpu(), want.double().cpu()
    if got.shape != want.shape or not torch.equal(torch.isinf(got),
                                                  torch.isinf(want)):
        return float("inf")
    fin = torch.isfinite(want)
    if not fin.any():
        return 0.0
    return float((got[fin] - want[fin]).abs().max())


def check_kernels(device, n_genomes=342, k=1_000_003):
    """Phase 3: every kernel equals its plain version exactly (the
    cross-entropy scores of cart_sweep to MAX_LOG_ULPS). Returns the largest
    absolute error per kernel and cart_sweep's largest distance in ulps per
    criterion."""
    from grm_tpu_torch.ops import cart_sweep as cs
    from grm_tpu_torch.ops import popcount as pc
    from grm_tpu_torch.ops import scm_sweep as sw

    rng = np.random.RandomState(3)
    w = -(-n_genomes // 32)
    matrix = _words(rng, (w, k), device)
    worst = {}

    def record(name, got, want, what):
        err = max_abs_err(got, want)
        worst[name] = max(worst.get(name, 0.0), err)
        if err != 0.0:
            raise AssertionError("%s differs from its plain version at %s "
                                 "(max abs err %r)" % (name, what, err))

    for c in (1, 2, 10, 12):
        masks = _words(rng, (c, w), device)
        record("popcount_colsum", pc.popcount_colsum(matrix, masks),
               pc.popcount_colsum_plain(matrix, masks), "C=%d" % c)
    import torch

    offsets = torch.tensor([0, 8192, k - 5000, k - 1, k + 10, k // 7],
                           dtype=torch.int64, device=device)
    masks = _words(rng, (len(offsets), 2, w), device)
    record("popcount_colsum_pairs",
           pc.popcount_colsum_pairs(matrix, masks, offsets, 8192),
           pc.popcount_colsum_pairs_plain(matrix, masks, offsets, 8192),
           "ragged offsets")
    for f in (100, 128):
        for kk in (k, 3001):
            for grid in ("published", "dyadic"):
                p_values = P_GRID if grid == "published" else [0.5, 1, 2, 4]
                fits = fit_inputs(rng, f, n_genomes, p_values, device)
                for excl_on in (False, True):
                    m = matrix[:, :kk].contiguous()
                    excl = None
                    if excl_on:
                        excl = torch.from_numpy(
                            (rng.rand(2, kk) < 0.2).astype(np.uint8)
                        ).to(device)
                    what = "F=%d K=%d p=%s excl=%s" % (f, kk, grid, excl_on)
                    limit = kk - 5
                    bk = min(sw.BLOCK_K, kk)
                    record("scm_sweep_argmax",
                           sw.scm_sweep_argmax_blocks(m, *fits, limit, bk,
                                                      excl),
                           sw.scm_sweep_argmax_blocks_plain(m, *fits, limit,
                                                            bk, excl), what)
                    record("scm_sweep_sbmax",
                           sw.scm_sweep_sbmax(m, *fits, limit, 8192, excl),
                           sw.scm_sweep_sbmax_plain(m, *fits, limit, 8192,
                                                    excl), what)
    # The largest published genome count (5022 genomes, W = 157): masks
    # split over several launches, fits over grid rows, shared memory past
    # the 48 KB default.
    wide, kw = 5022, 20_001
    m = _words(rng, (-(-wide // 32), kw), device)
    masks = _words(rng, (100, m.shape[0]), device)
    record("popcount_colsum", pc.popcount_colsum(m, masks),
           pc.popcount_colsum_plain(m, masks), "W=157 C=100")
    fits = fit_inputs(rng, 128, wide, P_GRID, device)
    excl = torch.from_numpy((rng.rand(2, kw) < 0.2).astype(np.uint8)
                            ).to(device)
    record("scm_sweep_argmax",
           sw.scm_sweep_argmax_blocks(m, *fits, kw, sw.BLOCK_K, excl),
           sw.scm_sweep_argmax_blocks_plain(m, *fits, kw, sw.BLOCK_K, excl),
           "W=157 F=128")
    record("scm_sweep_sbmax", sw.scm_sweep_sbmax(m, *fits, kw, 8192, excl),
           sw.scm_sweep_sbmax_plain(m, *fits, kw, 8192, excl), "W=157 F=128")
    # Fit counts, depths and widths that leave the tensor-core kernel's
    # tiles ragged: fits in groups of 4 and passes of 8 to 32 groups (256
    # fits: two passes, or grid rows at W = 157), W = 1, 12, 13 and 157 (128-
    # bit steps, chunks of 4 steps), K = 5001 (a multiple of neither 16 nor
    # the block) with the limit inside it, a column that every example has
    # and one that none has, and a 16-column tile banned in both rows.
    kr = 5001
    for i, (f, genomes) in enumerate((f, genomes)
                                     for f in (1, 3, 5, 101, 256)
                                     for genomes in (20, 384, 400, 5022)):
        rag = _words(rng, (-(-genomes // 32), kr), device)
        rag[:, 7] = -1
        rag[:, 8] = 0
        grid = P_GRID if i % 2 else [0.5, 1, 2, 4]
        fits = fit_inputs(rng, f, genomes, grid, device)
        ex = (rng.rand(2, kr) < 0.2).astype(np.uint8)
        ex[:, 32:48] = 1
        ex = torch.from_numpy(ex).to(device)
        for e in (None, ex):
            what = "ragged F=%d W=%d excl=%s" % (f, rag.shape[0],
                                                 e is not None)
            record("scm_sweep_argmax",
                   sw.scm_sweep_argmax_blocks(rag, *fits, kr - 7, sw.BLOCK_K,
                                              e),
                   sw.scm_sweep_argmax_blocks_plain(rag, *fits, kr - 7,
                                                    sw.BLOCK_K, e), what)
            record("scm_sweep_sbmax",
                   sw.scm_sweep_sbmax(rag, *fits, kr - 7, 2048, e),
                   sw.scm_sweep_sbmax_plain(rag, *fits, kr - 7, 2048, e),
                   what)

    ulps = {crit: 0 for crit in CART_CRITERIA}

    def cart_case(mat, genomes, n, c, criterion, per_node, excl_on):
        kk = mat.shape[1]
        masks, n_node, priors, totals = frontier_inputs(rng, n, c, genomes,
                                                        per_node, device)
        scale = (priors / totals).expand(n, c).contiguous()
        ex = None
        if excl_on:
            ex = torch.from_numpy((rng.rand(kk) < 0.2).astype(np.uint8)
                                  ).to(device)
        args = (mat, masks, n_node, scale, criterion, kk - 5,
                min(cs.BLOCK_K, kk), ex)
        try:
            err, u = compare_cart_blocks(cs.cart_sweep_blocks(*args),
                                         cs.cart_sweep_blocks_plain(*args),
                                         criterion)
        except AssertionError as e:
            raise AssertionError("%s at W=%d K=%d N=%d C=%d per-node=%s "
                                 "excl=%s" % (e, mat.shape[0], kk, n, c,
                                              per_node, excl_on))
        worst["cart_sweep"] = max(worst.get("cart_sweep", 0.0), err)
        ulps[criterion] = max(ulps[criterion], u)
        # The reduction over blocks: least score, then lowest column; the
        # nodes that no rule splits come back as (NO_COLUMN, +inf).
        col, best = cs.cart_frontier_scores(
            mat, masks, n_node, priors, totals, criterion, kk - 5, excl=ex)
        pcol, pbest = cs.cart_frontier_scores_plain(
            mat, masks, n_node, priors, totals, criterion, kk - 5, excl=ex)
        if not torch.equal(col, pcol) or max_ulps(best, pbest) > (
                0 if criterion == "gini" else MAX_LOG_ULPS):
            raise AssertionError("cart_frontier_scores differs from its "
                                 "plain version at N=%d C=%d" % (n, c))
        dead = torch.isinf(best).cpu()
        if bool(dead[:-1].any()) or (n > 1 and not bool(dead[-1])):
            raise AssertionError("cart_frontier_scores: the nodes without a "
                                 "valid split are %s" % dead.tolist())

    for kk in (k, 3001):
        mat = matrix if kk == k else matrix[:, :kk].contiguous()
        for n in (1, 37, 200):
            for c in (2, 3):
                for criterion in CART_CRITERIA:
                    for per_node, excl_on in ((False, False), (True, True)):
                        cart_case(mat, n_genomes, n, c, criterion, per_node,
                                  excl_on)
    # 5 classes run the kernel's 8-class build, filled up with empty classes.
    for criterion in CART_CRITERIA:
        cart_case(matrix[:, :3001].contiguous(), n_genomes, 37, 5, criterion,
                  True, True)
    # W = 157: 200 nodes x 2 classes of masks pass the shared-memory budget,
    # so the nodes split over grid rows.
    for criterion in CART_CRITERIA:
        cart_case(m, wide, 200, 2, criterion, True, True)
    # Frontiers and depths that leave the kernel's tiles ragged: nodes in
    # groups of 4 and passes of a few groups, depth in steps of 4 words, 16
    # columns a warp (K = 3001 and the limit K - 5 are multiples of neither
    # 8 nor 16).
    small = matrix[:, :3001].contiguous()
    for criterion in CART_CRITERIA:
        for n in (9, 17, 18):
            for c in (2, 3, 5):
                for excl_on in (False, True):
                    cart_case(small, n_genomes, n, c, criterion, True,
                              excl_on)
        cart_case(m, wide, 65, 2, criterion, True, True)
        for genomes in (384, 400):  # W = 12: three whole steps; W = 13
            deep = _words(rng, (-(-genomes // 32), 3001), device)
            for n, c in ((18, 2), (9, 3)):
                cart_case(deep, genomes, n, c, criterion, False, True)
    return worst, ulps


# -- timing -------------------------------------------------------------------

def time_cuda(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(event):
    us = getattr(event, "self_device_time_total", None)
    return getattr(event, "self_cuda_time_total", 0) if us is None else us


def _is_function(key, function):
    """Whether the profiler's kernel name ``key`` is ``function`` or, for a
    tuple, one of them."""
    names = (function,) if isinstance(function, str) else function
    return any(re.search(r"(^|\W)%s(\W|$)" % re.escape(f), key) is not None
               for f in names)


def device_ms(fn, reps, function):
    """Device time per call of ``fn``: the time torch.profiler records for
    the CUDA function ``function`` (or each of a tuple of them) over
    ``reps`` calls, divided by the launches it recorded, so that the host's
    gaps between launches do not count.
    Returns (ms, how it was timed); CUDA events time the calls, gaps
    included, when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # Per CUDA function the mean time of the launches the profiler recorded
    # (it can drop one) times the launches a call makes, summed over the
    # functions a call launches.
    ms = sum(_device_us(e) / 1e3 / e.count * max(1, round(e.count / reps))
             for e in prof.key_averages()
             if _is_function(e.key, function) and e.count > 0)
    if ms > 0:
        return ms, "profiler"
    return time_cuda(fn, reps), "cuda events"


def probe_card(popc_per_s):
    """Phase 6, first: the card's measured rates. Prints them and returns
    the 1-bit tensor-core rate in bit-ANDs per second (the better of the
    two ``mma`` shapes) and the special-function unit's instructions per
    second."""
    from grm_tpu_torch.ops import bmma_probe

    sass = bmma_probe.probe_sass()
    rates = bmma_probe.probe_rates()
    b1 = max(rates["bmma_k256"]["per_s"], rates["bmma_k128"]["per_s"])
    scalar = rates["popc"]["per_s"]
    if sass is None:
        how = "machine code not read (no cuobjdump)"
    elif sass["BMMA"] > 0:
        how = ("compiled to the tensor-core instruction (%d BMMA in the "
               "probe's SASS)" % sass["BMMA"])
    else:
        how = "lowered to other code (no BMMA in the probe's SASS)"
    # One POPC and one special function a round: the sum of their times if
    # they share one pipe, the larger if they do not.
    alone = 32 / scalar + 1 / rates["sfu"]["per_s"]
    both = 1 / rates["popc+sfu"]["per_s"]
    log(json.dumps({
        "probe": "b1 AND+POPC", "sass": sass, "mma": how,
        "bit_ands_per_s": {k: rates[k]["per_s"]
                           for k in ("bmma_k256", "bmma_k128", "popc")},
        "tensor_over_scalar": b1 / scalar,
        "scalar_popc_per_s": scalar / 32,
        "scalar_popc_per_s_at_16_per_clock": popc_per_s,
        "sfu_per_s": rates["sfu"]["per_s"],
        "popc_and_sfu_rounds_per_s": rates["popc+sfu"]["per_s"],
        "popc_and_sfu_time_over_sum_of_both": both / alone,
        "ms": {k: v["ms"] for k, v in rates.items()}}))
    return b1, rates["sfu"]["per_s"]


def machine_code():
    """Phase 6: how often the tensor-core (BMMA), scalar popcount (POPC) and
    integer matrix (IMMA) instructions occur in the sweeps' machine code.
    Fails unless scm_sweep counts on the tensor cores alone."""
    from grm_tpu_torch.ops import _build

    for name in ("scm_sweep", "cart_sweep"):
        ops = _build.sass_opcodes(name, ("BMMA", "POPC", "IMMA"))
        if ops is None:
            log("    %s: machine code not read (the toolkit has no "
                "cuobjdump)" % name)
            continue
        log(json.dumps({"sass": name, **ops}))
        if name == "scm_sweep" and (ops["BMMA"] == 0 or ops["POPC"] > 0):
            raise AssertionError("scm_sweep's machine code holds %d BMMA and "
                                 "%d POPC" % (ops["BMMA"], ops["POPC"]))


def distinct_splits(n_node, k):
    """How many different splits k columns can give the nodes of a
    frontier: a node with n_c examples of class c has prod(n_c + 1) vectors
    of left counts, and its score is a function of that vector alone."""
    per_node = np.prod(n_node.cpu().numpy().astype(np.float64) + 1, axis=1)
    return float(np.minimum(per_node, k).sum())


def time_kernels(bm, popc_per_s, b1_per_s, sfu_per_s, device, paths,
                 frontier):
    """Phase 6: each kernel at the main paths' shapes against its plain
    version on the same inputs, with its bounds; one JSON line each, with
    its launches on each main path. ``frontier`` is the number of nodes
    cart_sweep is timed at, ``b1_per_s`` and ``sfu_per_s`` the measured
    rates of the 1-bit tensor-core product and the special-function unit,
    ``popc_per_s`` the scalar POPC pipe's rate by the 16-a-clock rule."""
    import torch

    from grm_tpu_torch.ops import cart_sweep as cs
    from grm_tpu_torch.ops import popcount as pc
    from grm_tpu_torch.ops import scm_sweep as sw

    rng = np.random.RandomState(7)
    matrix = bm.data
    w, k = matrix.shape
    rows = {}

    def bound(nbytes, popc, special):
        """The least time for ``nbytes`` moved, ``popc`` AND + POPC word
        operations (32 bit-ANDs each, a 1-bit product on the tensor cores)
        and ``special`` divisions and logs: (ms, "bytes" or "operations",
        which of the three is the largest)."""
        times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "b1 product": 32 * popc / b1_per_s * 1e3,
                 "special-function": special / sfu_per_s * 1e3}
        what = max(times, key=times.get)
        return (times[what], "bytes" if what == "bytes" else "operations",
                what)

    def exact(name):
        def compare(got, want):
            err = max_abs_err(got, want)
            if err != 0.0:
                raise AssertionError("%s differs from its plain version at "
                                     "the main path's shapes (%r)"
                                     % (name, err))
            return err
        return compare

    def row(name, kernel, plain, nbytes, popc, reps, shape, special=0,
            special_popc=0, compare=None, key=None):
        err = (compare or exact(name))(kernel(), plain())
        ms, timed_by = device_ms(kernel, reps, KERNEL_FUNCTIONS[name])
        event_ms = time_cuda(kernel, reps)
        plain_ms = time_cuda(plain, 1)
        bound_ms, bound_by, bound_what = bound(nbytes, popc, special)
        # As up to now: counting, and ``special_popc`` divisions and logs
        # (one score per node and column), at the scalar POPC rate.
        popc_ms = max(nbytes / HBM_BYTES_PER_S,
                      max(popc, special_popc) / popc_per_s) * 1e3
        rows[key or name] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "bound_ms_popc": popc_ms}
        log(json.dumps({"kernel": key or name, "shape": shape,
                        **rows[key or name], "bound_what": bound_what,
                        "timed_by": timed_by, "event_ms": event_ms,
                        "launches": {e: paths[e][name] for e in paths}}))

    # The argmax engine's full-train step: two masks over the whole matrix.
    masks = _words(rng, (2, w), device)
    row("popcount_colsum", lambda: pc.popcount_colsum(matrix, masks),
        lambda: pc.popcount_colsum_plain(matrix, masks),
        4 * w * k + 4 * 2 * w + 4 * 2 * k, 2 * w * k, 20,
        "W=%d K=%d C=2" % (w, k))
    # The argmax engine's phase 2: 2F = 200 windows of one 4096-column block.
    n_pairs, width = 200, sw.BLOCK_K
    offsets = torch.from_numpy(rng.randint(0, k - width, n_pairs)
                               .astype(np.int64)).to(device)
    pmasks = _words(rng, (n_pairs, 2, w), device)
    row("popcount_colsum_pairs",
        lambda: pc.popcount_colsum_pairs(matrix, pmasks, offsets, width),
        lambda: pc.popcount_colsum_pairs_plain(matrix, pmasks, offsets, width),
        4 * n_pairs * (width * w + 2 * w + 2 * width) + 8 * n_pairs,
        2 * n_pairs * width * w, 20,
        "W=%d P=%d width=%d" % (w, n_pairs, width))
    # The argmax CV: 2 model types x 10 p x 5 folds = 100 fits.
    fits_cv = fit_inputs(rng, 100, bm.n_rows, P_GRID, device)
    nb = -(-k // sw.BLOCK_K)
    row("scm_sweep_argmax",
        lambda: sw.scm_sweep_argmax_blocks(matrix, *fits_cv, k, sw.BLOCK_K),
        lambda: sw.scm_sweep_argmax_blocks_plain(matrix, *fits_cv, k,
                                                 sw.BLOCK_K),
        4 * w * k + 100 * (8 * w + 12) + 8 * nb * 100, 2 * 100 * w * k, 5,
        "W=%d K=%d F=100 block=%d" % (w, k, sw.BLOCK_K))
    # The exact CV: 100 CV fits + 20 full-train fits, superblocks of 8192.
    fits_ex = fit_inputs(rng, 120, bm.n_rows, P_GRID, device)
    nsb = -(-k // 8192)
    row("scm_sweep_sbmax",
        lambda: sw.scm_sweep_sbmax(matrix, *fits_ex, k, 8192),
        lambda: sw.scm_sweep_sbmax_plain(matrix, *fits_ex, k, 8192),
        4 * w * k + 120 * (8 * w + 12) + 4 * nsb * 120, 2 * 120 * w * k, 5,
        "W=%d K=%d F=120 sb=8192" % (w, k))
    # The same shapes under a k-mer blacklist, which bans both rules of a
    # k-mer: 0.1%, 1% and 20% of the columns at random (a few genes, a
    # plasmid, a stress case); then 1% of the presence rules banned alone,
    # which sends nearly every tile down the kernel's one-tile path.
    # Columns banned in both rows need no counting.
    mask_rng = np.random.RandomState(11)
    for share, rows_banned in ((0.001, 2), (0.01, 2), (0.2, 2), (0.01, 1)):
        banned = mask_rng.rand(k) < share
        excl = torch.from_numpy(np.stack(
            [banned, banned & (rows_banned == 2)]).astype(np.uint8)).to(device)
        live = k - int(banned.sum()) if rows_banned == 2 else k
        tag = "excl %g%%%s" % (100 * share,
                               "" if rows_banned == 2 else " presence")
        row("scm_sweep_argmax",
            lambda: sw.scm_sweep_argmax_blocks(matrix, *fits_cv, k,
                                               sw.BLOCK_K, excl),
            lambda: sw.scm_sweep_argmax_blocks_plain(matrix, *fits_cv, k,
                                                     sw.BLOCK_K, excl),
            4 * w * k + 2 * k + 100 * (8 * w + 12) + 8 * nb * 100,
            2 * 100 * w * live, 5, "W=%d K=%d F=100 block=%d %s"
            % (w, k, sw.BLOCK_K, tag), key="scm_sweep_argmax:" + tag)
        row("scm_sweep_sbmax",
            lambda: sw.scm_sweep_sbmax(matrix, *fits_ex, k, 8192, excl),
            lambda: sw.scm_sweep_sbmax_plain(matrix, *fits_ex, k, 8192, excl),
            4 * w * k + 2 * k + 120 * (8 * w + 12) + 4 * nsb * 120,
            2 * 120 * w * live, 5, "W=%d K=%d F=120 sb=8192 %s" % (w, k, tag),
            key="scm_sweep_sbmax:" + tag)
    # The argmax CART engine's largest frontier: per-node priors (a forest
    # of fold and master trees), no exclusion mask. Two classes, as on the
    # main path, are scored by look-up; three classes by the direct scores
    # that every frontier of three or more classes takes.
    n = frontier
    nb = -(-k // cs.BLOCK_K)
    for c, how in ((2, ""), (3, "direct:")):
        masks, n_node, priors, totals = frontier_inputs(rng, n, c, bm.n_rows,
                                                        True, device)
        scale = (priors / totals).contiguous()
        if bool(cs.table_plan(n, c, w)) != (c == 2):
            raise AssertionError("cart_sweep: %d classes are not scored %s"
                                 % (c, how or "by look-up"))
        splits = distinct_splits(n_node, k)
        for criterion in CART_CRITERIA:
            args = (matrix, masks, n_node, scale, criterion, k, cs.BLOCK_K)
            per_split = 2 if criterion == "gini" else 4 * c
            row("cart_sweep", lambda: cs.cart_sweep_blocks(*args),
                lambda: cs.cart_sweep_blocks_plain(*args),
                4 * w * k + n * c * (4 * w + 8) + 8 * nb * n, n * c * w * k,
                5, "W=%d K=%d N=%d C=%d %s block=%d; %.0f distinct splits"
                % (w, k, n, c, criterion, cs.BLOCK_K, splits),
                special=splits * per_split, special_popc=n * k * per_split,
                compare=lambda got, want: compare_cart_blocks(
                    got, want, criterion)[0],
                key="cart_sweep:" + how + criterion)
    return rows


def profile_learn(what, run_once, wall, want):
    """One more run of the path ``what`` under torch.profiler:
    ``run_once()`` returns its fingerprint, which must be ``want``, the
    unprofiled run's. Prints the device time by kernel name and the
    device's busy share of ``wall``, the unprofiled run's wall seconds;
    "not measured" if the profiler holds no device data."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = run_once()
        torch.cuda.synchronize()
    if got != want:
        raise AssertionError("the profiled run of %s learned another model "
                             "than the unprofiled one" % what)
    try:  # only the reading of the profile may fail without failing the run
        rows = [(_device_us(e), e.key, e.count) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
    except Exception:
        traceback.print_exc()
        rows = []
    if not rows:
        log("    device time by kernel: not measured (no device events)")
        return
    total_ms = sum(r[0] for r in rows) / 1e3
    log("    device time over %s: %.2f ms = %.1f%% busy of the %.3f s "
        "unprofiled wall; by kernel:"
        % (what, total_ms, 100.0 * total_ms / (wall * 1e3), wall))
    for us, key, count in sorted(rows, reverse=True)[:8]:
        log("      %9.3f ms  %5d x  %s" % (us / 1e3, count, key[:90]))


# -- phases -------------------------------------------------------------------

def ptxas_summary(text):
    """(function, registers, spills) per kernel function from the output of
    ``nvcc -Xptxas -v``; a template instance is named with its integer
    and boolean arguments, as in ``cart_sweep_kernel<2, 1, 0>``."""
    out = []
    function = spills = "?"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"\d+([A-Za-z_]+_kernel)(I(?:L[ib]\d+E)+E)?",
                             m.group(1))
            function = m.group(1) if name is None else name.group(1) + (
                "<%s>" % ", ".join(re.findall(r"L[ib](\d+)E", name.group(2)))
                if name.group(2) else "")
        elif "spill" in line:
            spills = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((function, m.group(1), spills))
    return out


def nvidia_smi(fields):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + fields, "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run(seed):
    import torch

    from grm_tpu_torch.ops import _build

    device = torch.device("cuda")
    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    max_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    popc_per_s = n_sm * POPC_PER_CLOCK_PER_SM * max_mhz * 1e6
    log("[1] device: %s | %s | %d SMs, max SM clock %.0f MHz -> %.3e popc/s"
        % (name, smi, n_sm, max_mhz, popc_per_s))

    # 2. build
    t0 = time.time()
    built = _build.build_all()
    log("[2] built %s in %.2f s" % (built or "nothing (cached)",
                                     time.time() - t0))
    for src, text in _build.BUILD_LOG.items():
        for function, regs, spills in ptxas_summary(text):
            log("    %s: %s: %s registers, %s" % (src, function, regs, spills))

    # 3. kernels against their plain versions
    t0 = time.time()
    worst, ulps = check_kernels(device)
    torch.cuda.synchronize()
    log("[3] kernels equal their plain versions (max abs err %s; cart_sweep "
        "scores, largest distance in ulps %s) in %.1f s"
        % (worst, ulps, time.time() - t0))

    # 4. device engine == host engine at reduced size
    t0 = time.time()
    small = build_artifact(MEDIAN_GENOMES, SMALL_KMERS, seed, device)
    t_art = time.time() - t0
    t0 = time.time()
    fp_host = fingerprint(learn(small, "host", device))
    t_host = time.time() - t0
    t0 = time.time()
    fp_dev = fingerprint(learn(small, "device", device))
    t_dev = time.time() - t0
    if fp_dev != fp_host:
        raise AssertionError("device engine != host engine at %dx%d:\n%s\n%s"
                             % (MEDIAN_GENOMES, SMALL_KMERS, fp_dev, fp_host))
    log("[4] %dx%d: device fingerprint == host (hp %s, %d rules, test risk "
        "%.4f); artifact %.1f s, host %.1f s, device %.1f s"
        % (MEDIAN_GENOMES, SMALL_KMERS, fp_dev["hp"], len(fp_dev["rules"]),
           fp_dev["test"]["risk"][0], t_art, t_host, t_dev))
    t0 = time.time()
    tree_host = tree_fingerprint(
        learn_tree(small, "host", device, list(CART_CRITERIA), SMALL_DEPTH),
        selection=False)
    t_host = time.time() - t0
    t0 = time.time()
    tree_dev = tree_fingerprint(
        learn_tree(small, "device-argmax", device, list(CART_CRITERIA),
                   SMALL_DEPTH), selection=False)
    t_dev = time.time() - t0
    if tree_dev != tree_host:
        raise AssertionError("learn_CART: device-argmax != host at %dx%d:\n"
                             "%s\n%s" % (MEDIAN_GENOMES, SMALL_KMERS, tree_dev,
                                         tree_host))
    log("    learn_CART(depth %d): device-argmax tree and metrics == host "
        "(%d rules, test risk %.4f); host %.1f s, device-argmax %.1f s"
        % (SMALL_DEPTH, len(tree_dev["rules"]),
           tree_dev["test"]["risk"][0], t_host, t_dev))
    del small

    # 5. the main paths at full scale
    t0 = time.time()
    mem = build_artifact(MEDIAN_GENOMES, MEDIAN_KMERS, seed, device)
    torch.cuda.synchronize()
    log("[5] artifact %dx%d + %d-fold split built in %.1f s (set-up)"
        % (MEDIAN_GENOMES, MEDIAN_KMERS, N_FOLDS, time.time() - t0))
    from grm_tpu_torch.dataset import GrmDataset
    from grm_tpu_torch.reports import write_cart_outputs, write_scm_outputs

    def scm_path(engine):
        out = learn(mem, engine, device)
        torch.cuda.synchronize()
        return out, fingerprint(out)

    def tree_path(engine, criterion, max_depth):
        out = learn_tree(mem, engine, device, criterion, max_depth)
        torch.cuda.synchronize()
        return out, tree_fingerprint(out)

    def write_reports(writer, out, config, **more):
        """What the CLI does after learning: the report files, into a
        temporary directory."""
        t1 = time.time()
        (best_hp, best_hp_score, train_metrics, test_metrics, model,
         rule_importances, equivalent_rules, classifications) = out
        with tempfile.TemporaryDirectory() as out_dir:
            writer(
                output_dir=out_dir, dataset=GrmDataset(mem, device=device),
                split_name="sp", config=config, best_hp=best_hp,
                best_hp_score=best_hp_score, train_metrics=train_metrics,
                test_metrics=test_metrics, model=model,
                rule_importances=rule_importances,
                equivalent_rules=equivalent_rules,
                classifications=classifications, running_time_seconds=0.0,
                **more)
            return "%s in %.2f s" % (sorted(os.listdir(out_dir)),
                                     time.time() - t1)

    runners = {
        "device": lambda: scm_path("device"),
        "device-argmax": lambda: scm_path("device-argmax"),
        "tree-device-argmax": lambda: tree_path(
            "device-argmax", list(CART_CRITERIA), 10),
        "tree-host": lambda: tree_path("host", ["gini"], 3),
    }
    paths = {}  # path -> launches, counted from 0 over that path alone
    fingerprints = {}
    walls = {}
    frontiers = []
    for path in PATH_KERNELS:
        _build.reset_launches()
        t0 = time.time()
        out, fp = runners[path]()
        wall = walls[path] = time.time() - t0
        written = None
        if path == "device":  # learn scm's default path writes its reports
            written = write_reports(
                write_scm_outputs, out, {"engine": path, "hp_choice": "cv"})
        elif path == "tree-device-argmax":
            written = write_reports(
                write_cart_outputs, out,
                {"engine": "device-argmax", "hp_choice": "cv",
                 "criterion": list(CART_CRITERIA), "max_depth": [10]},
                classification_type="binary")
        paths[path] = dict(_build.launches)
        sizes = list(_build.cart_frontiers)  # (nodes, criterion) per launch
        fingerprints[path] = fp
        if not fp["rules"] or not np.isfinite(fp["score"]):
            raise AssertionError("path %r learned no model" % path)
        if not all(np.isfinite(v) for v in fp["importances"]):
            raise AssertionError("path %r: non-finite importances" % path)
        if path.startswith("tree-"):
            log("    learn_CART(%s): %.2f s; hp %s, cv score %.5f, %d rules, "
                "depth-first %s, train risk %.4f, test risk %.4f; launches %s"
                % (path, wall, fp["hp"], fp["score"], len(fp["rules"]),
                   [r[0] for r in fp["rules"]][:6], fp["train"]["risk"][0],
                   fp["test"]["risk"][0], paths[path]))
        else:
            log("    learn_SCM(engine=%r): %.2f s; hp %s, cv score %.5f, rules "
                "%s, train risk %.4f, test risk %.4f; launches %s"
                % (path, wall, fp["hp"], fp["score"],
                   [r[1][0] + ":" + r[0] for r in fp["rules"]],
                   fp["train"]["risk"][0], fp["test"]["risk"][0],
                   paths[path]))
        if sizes:
            frontiers = sizes
            log("    frontier size per cart_sweep launch (%d launches): %s"
                % (len(sizes), [n for n, _ in sizes]))
        if written:
            log("    reports: %s" % written)
        missing = [k for k in PATH_KERNELS[path] if paths[path][k] == 0]
        if missing:
            raise AssertionError("path %r launched no %s" % (path, missing))
    if not frontiers:
        raise AssertionError("the argmax CART engine launched no frontier")
    for engine in ("device", "device-argmax"):
        profile_learn("learn_SCM(engine=%r)" % engine,
                      lambda: scm_path(engine)[1], walls[engine],
                      fingerprints[engine])
    profile_learn("learn_CART(engine='device-argmax')",
                  lambda: runners["tree-device-argmax"]()[1],
                  walls["tree-device-argmax"],
                  fingerprints["tree-device-argmax"])

    # 6. kernel times at the main paths' shapes
    log("[6] the card's measured rates, then kernel times at the main "
        "paths' shapes:")
    bm = GrmDataset(mem, device=device).bit_matrix()
    b1_per_s, sfu_per_s = probe_card(popc_per_s)
    machine_code()
    rows = time_kernels(bm, popc_per_s, b1_per_s, sfu_per_s, device, paths,
                        max(n for n, _ in frontiers))
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        by_path = {e: paths[e][kname] for e in paths}
        entry = {"name": kname, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path}
        if kname == "cart_sweep":
            # Gini by look-up (the main path's classes and the CLI's default
            # criterion) under the common keys; the error is the largest of
            # the four rows'.
            r = rows["cart_sweep:gini"]
            more = {"cross_entropy": rows["cart_sweep:cross-entropy"],
                    "direct_gini": rows["cart_sweep:direct:gini"],
                    "direct_cross_entropy":
                        rows["cart_sweep:direct:cross-entropy"]}
            entry.update(r, max_abs_err=max(
                [r["max_abs_err"]] + [x["max_abs_err"]
                                      for x in more.values()]), **more)
        else:
            # The SCM sweeps: no mask under the common keys, each blacklist
            # under its own; the error is the largest of the rows'.
            more = {key.split(":", 1)[1]: r for key, r in rows.items()
                    if key.startswith(kname + ":")}
            entry.update(rows[kname], **more)
            entry["max_abs_err"] = max([rows[kname]["max_abs_err"]] + [
                r["max_abs_err"] for r in more.values()])
        kernels.append(entry)
    return name, smi, kernels


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the synthetic artifacts")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        name, smi, kernels = run(args.seed)
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
