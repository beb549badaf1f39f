#!/usr/bin/env python3
"""Smoke run of grm_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, checks the exact device
engine against the host engine at reduced size, then drives ``learn scm``
at the published median scale through both device engines.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero and prints no result):

1. Device: the card's name, power limit and maximum SM clock.
2. Build: ``nvcc`` for ``sm_90a``, one process per source, from
   ``grm_tpu_torch/csrc``; the build seconds and each kernel's registers.
3. Kernels against their plain versions, exact equality: popcount_colsum
   at W = 11, K = 1,000,003, C = 1, 2, 10, 12; the pair-batched entry with
   ragged offsets; both scm_sweep epilogues at F = 100 and 128, K ragged and
   K below one block, the published p grid and dyadic p, with and without
   an exclusion mask; and at the largest published genome count (W = 157).
4. Correctness at reduced size: a 342 x 200,000 in-memory artifact with a
   5-fold split; ``learn_SCM(engine="device")`` must give the host
   engine's fingerprint (hyperparameters, score, rules, tie sets,
   importances, metrics, classifications).
5. The main path at full scale: 342 genomes x 9,600,000 k-mers (the
   published median, BASELINE.md), 5-fold split, the 2 model types x 10 p
   grid, max 10 rules, built in memory from --seed with the benchmark's
   recipe (a planted 3-marker conjunction plus decoys). Two paths, each
   driven with the launch counts set to 0 just before it and read just
   after: ``learn_SCM(engine="device")`` plus ``write_scm_outputs`` (what
   ``learn scm`` runs by default), then ``learn_SCM(engine=
   "device-argmax")``. Each path must launch the kernels it is built on
   (PATH_KERNELS). One more exact-engine run under torch.profiler must give
   the same fingerprint, and gives the device time by kernel and the
   device's busy share of the run.
6. Each kernel at the main path's shapes: its device time per call from
   torch.profiler (CUDA events only if the profiler sees no device time),
   its plain version timed once, and the least time the card could take
   (bound).

The last lines of standard output are the kernels' JSON line, the card's
``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``. In the kernels' line, ``launches`` is
the sum of the two paths' counts and ``launches_by_path`` gives each path's
own. Kernel libraries are built into
``grm_tpu_torch/_kernels/``.
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
}
# The kernels each main path is built on: the exact engine's pass 1 and
# pass 2; the argmax engine's CV sweep, its winner-block recount, and its
# full-train fit (parallel/mesh.py).
PATH_KERNELS = {
    "device": ("scm_sweep_sbmax", "popcount_colsum_pairs"),
    "device-argmax": ("scm_sweep_argmax", "popcount_colsum_pairs",
                      "popcount_colsum"),
}
# The CUDA function each wrapper launches, as torch.profiler names it.
KERNEL_FUNCTIONS = {
    "popcount_colsum": "colsum_kernel",
    "popcount_colsum_pairs": "colsum_pairs_kernel",
    "scm_sweep_argmax": "scm_sweep_kernel<0>",
    "scm_sweep_sbmax": "scm_sweep_kernel<1>",
}


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
    """Phase 3: every kernel equals its plain version exactly."""
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
    return worst


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
    return re.search(r"(^|\W)%s(\W|$)" % re.escape(function), key) is not None


def device_ms(fn, reps, function):
    """Device time per call of ``fn``: the time torch.profiler records for
    the CUDA function ``function`` over ``reps`` calls, divided by
    ``reps``, so that the host's gaps between launches do not count.
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
    us = sum(_device_us(e) for e in prof.key_averages()
             if _is_function(e.key, function))
    if us > 0:
        return us / 1e3 / reps, "profiler"
    return time_cuda(fn, reps), "cuda events"


def time_kernels(bm, popc_per_s, device, paths):
    """Phase 6: each kernel at the main path's shapes against its plain
    version on the same inputs, with its bound; one JSON line each, with
    its launches on each main path."""
    import torch

    from grm_tpu_torch.ops import popcount as pc
    from grm_tpu_torch.ops import scm_sweep as sw

    rng = np.random.RandomState(7)
    matrix = bm.data
    w, k = matrix.shape
    rows = {}

    def bound(nbytes, popc):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = popc / popc_per_s * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    def row(name, kernel, plain, nbytes, popc, reps, shape):
        got, want = kernel(), plain()
        err = max_abs_err(got, want)
        if err != 0.0:
            raise AssertionError("%s differs from its plain version at the "
                                 "main path's shapes (%r)" % (name, err))
        ms, timed_by = device_ms(kernel, reps, KERNEL_FUNCTIONS[name])
        event_ms = time_cuda(kernel, reps)
        plain_ms = time_cuda(plain, 1)
        bound_ms, bound_by = bound(nbytes, popc)
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": None}
        log(json.dumps({"kernel": name, "shape": shape, **rows[name],
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
    fits = fit_inputs(rng, 100, bm.n_rows, P_GRID, device)
    nb = -(-k // sw.BLOCK_K)
    row("scm_sweep_argmax",
        lambda: sw.scm_sweep_argmax_blocks(matrix, *fits, k, sw.BLOCK_K),
        lambda: sw.scm_sweep_argmax_blocks_plain(matrix, *fits, k,
                                                 sw.BLOCK_K),
        4 * w * k + 100 * (8 * w + 12) + 8 * nb * 100, 2 * 100 * w * k, 5,
        "W=%d K=%d F=100 block=%d" % (w, k, sw.BLOCK_K))
    # The exact CV: 100 CV fits + 20 full-train fits, superblocks of 8192.
    fits = fit_inputs(rng, 120, bm.n_rows, P_GRID, device)
    nsb = -(-k // 8192)
    row("scm_sweep_sbmax",
        lambda: sw.scm_sweep_sbmax(matrix, *fits, k, 8192),
        lambda: sw.scm_sweep_sbmax_plain(matrix, *fits, k, 8192),
        4 * w * k + 120 * (8 * w + 12) + 4 * nsb * 120, 2 * 120 * w * k, 5,
        "W=%d K=%d F=120 sb=8192" % (w, k))
    return rows


def profile_learn(mem, device, wall, want):
    """One more learn_SCM(engine="device") run under torch.profiler: it must
    give the fingerprint ``want`` of the unprofiled run. Prints the device
    time by kernel name and the device's busy share of ``wall``, the
    unprofiled run's wall seconds; "not measured" if the profiler holds no
    device data."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = learn(mem, "device", device)
        torch.cuda.synchronize()
    if fingerprint(out) != want:
        raise AssertionError("the profiled exact-engine run learned another "
                             "model than the unprofiled one")
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
    log("    device time over learn_SCM(engine='device'): %.2f ms = %.1f%% "
        "busy of the %.3f s unprofiled wall; by kernel:"
        % (total_ms, 100.0 * total_ms / (wall * 1e3), wall))
    for us, key, count in sorted(rows, reverse=True)[:8]:
        log("      %9.3f ms  %5d x  %s" % (us / 1e3, count, key[:90]))


# -- phases -------------------------------------------------------------------

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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("    %s: %s" % (src, line.strip()))

    # 3. kernels against their plain versions
    t0 = time.time()
    worst = check_kernels(device)
    torch.cuda.synchronize()
    log("[3] kernels equal their plain versions (max abs err %s) in %.1f s"
        % (worst, time.time() - t0))

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
    del small

    # 5. the main path at full scale
    t0 = time.time()
    mem = build_artifact(MEDIAN_GENOMES, MEDIAN_KMERS, seed, device)
    torch.cuda.synchronize()
    log("[5] artifact %dx%d + %d-fold split built in %.1f s (set-up)"
        % (MEDIAN_GENOMES, MEDIAN_KMERS, N_FOLDS, time.time() - t0))
    from grm_tpu_torch.dataset import GrmDataset
    from grm_tpu_torch.reports import write_scm_outputs

    paths = {}  # engine -> launches, counted from 0 over that path alone
    fingerprints = {}
    walls = {}
    for engine in PATH_KERNELS:
        _build.reset_launches()
        t0 = time.time()
        out = learn(mem, engine, device)
        torch.cuda.synchronize()
        wall = walls[engine] = time.time() - t0
        written = None
        if engine == "device":  # learn scm's default path writes its reports
            t1 = time.time()
            with tempfile.TemporaryDirectory() as out_dir:
                (best_hp, best_hp_score, train_metrics, test_metrics, model,
                 rule_importances, equivalent_rules, classifications) = out
                write_scm_outputs(
                    output_dir=out_dir, dataset=GrmDataset(mem, device=device),
                    split_name="sp",
                    config={"engine": engine, "hp_choice": "cv"},
                    best_hp=best_hp, best_hp_score=best_hp_score,
                    train_metrics=train_metrics, test_metrics=test_metrics,
                    model=model, rule_importances=rule_importances,
                    equivalent_rules=equivalent_rules,
                    classifications=classifications, running_time_seconds=0.0)
                written = "%s in %.2f s" % (sorted(os.listdir(out_dir)),
                                            time.time() - t1)
        paths[engine] = dict(_build.launches)
        fp = fingerprints[engine] = fingerprint(out)
        if not fp["rules"] or not np.isfinite(fp["score"]):
            raise AssertionError("%s engine learned no model" % engine)
        if not all(np.isfinite(v) for v in fp["importances"]):
            raise AssertionError("%s engine: non-finite importances" % engine)
        log("    learn_SCM(engine=%r): %.2f s; hp %s, cv score %.5f, rules %s,"
            " train risk %.4f, test risk %.4f; launches %s"
            % (engine, wall, fp["hp"], fp["score"],
               [r[1][0] + ":" + r[0] for r in fp["rules"]],
               fp["train"]["risk"][0], fp["test"]["risk"][0], paths[engine]))
        if written:
            log("    write_scm_outputs: %s" % written)
        missing = [k for k in PATH_KERNELS[engine] if paths[engine][k] == 0]
        if missing:
            raise AssertionError("engine %r launched no %s" % (engine, missing))
    profile_learn(mem, device, walls["device"], fingerprints["device"])

    # 6. kernel times at the main path's shapes
    log("[6] kernel times at the main path's shapes:")
    bm = GrmDataset(mem, device=device).bit_matrix()
    rows = time_kernels(bm, popc_per_s, device, paths)
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        r = rows[kname]
        by_path = {e: paths[e][kname] for e in paths}
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
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
