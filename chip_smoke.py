#!/usr/bin/env python3
"""Smoke run of grm_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, checks the device engines
against the host engines at reduced size, then drives ``learn scm`` at the
published median scale through two engines, ``learn tree`` through
three, the device ingest (contigs -> packed matrix on the card ->
``train_scm``) at 342 genomes of 4.4 Mbp, and dataset creation from the
same genomes as FASTA files (``from_contigs`` -> split -> ``learn_SCM``),
each loading path's matrix split on the card (``deinterleave_u64``) and
timed apart; the four resident learn paths again on a mesh of four
column shards of the one card, and the two-process matrix build over
gloo; then ``collect amr`` and the results site through the port's
CLI.

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
   The exact CART engine's kernels, exact equality of every integer and
   table: cart_exact_tuples and both modes of cart_exact_select (gather and
   equiv) at N = 1, 18 and 65 nodes, C = 2 and 3 classes, W = 11 and 157,
   K = 1,000,003 and 3001 (ragged) with the limit inside them, with and
   without an exclusion mask, Gini and cross-entropy, every node with its
   own train mask (nodes of different trees), thresholds from pass 1 with
   the engine's margin, and an all-hit node (one example of each of two
   classes, threshold +inf: nearly every column on one of four keys); at
   W = 157 (the A fragments staged in shared memory) 65 nodes of two and
   of three classes. The tuple tables' pass bitmaps on their own
   (pass_bitmap): C = 2, 3 and 8, a lattice of exactly 65,536 keys,
   thresholds of -inf and +inf, an empty class.
   The device ingest's kernels, exact equality of every output:
   kmer_canon, build_columns (a budget the union fits, one it overflows),
   merge_columns (the first 32 rows and the rest merged as two batches,
   straight to the final matrix) and compact_columns
   at k = 1, 9, 15, 16, 17, 30, 31, 32, 33 and 64 and G = 1, 31, 32, 33
   and 64 genome rows of 4173 codes (a multiple of no tile) with runs of
   4s and a contig shorter than k, kmer_canon also at rows of 4144 codes
   (16-byte aligned, ending mid-run in a second tile); build_columns also
   at k = 31 and 33 on 64 genomes of 65,613 codes (over 1,000 of its
   tiles), each with a run of 1,000 As, so that the all-A k-mer's first
   matrix word covers several whole tiles; merge_columns also on batches
   of 32, 32 and 6 genomes and of 64 (two word rows) and 6, with unequal
   buckets, at k = 9, 31, 32, 33 and 64: as built, with no valid row, and
   with every row valid (each bucket exactly full); then both builders
   on the card against the same builders through the plain versions on
   the CPU, with and without the singleton filter, at k = 16, 31 and 33,
   at the all-T k-mer of k = 16 and 32, and with a batch bucket that is
   exactly full.
   The streamed matrix's chunk source: its double-buffered uploads from
   pinned memory (8 chunks, two buffers, the current stream kept busy)
   against a plain upload of each chunk, bit for bit, popcount_colsum on
   each chunk, the upload of hit superblocks, and
   StreamingBitMatrix.presence_counts against its run on the CPU.
   The artifact's matrix split (deinterleave_u64), bit for bit: the chunked
   load through the pinned staging ring against the host split and the
   plain version on the card, one launch a chunk, at an odd W64 (342
   genomes), 96 and 352 genomes (32 x odd), a ragged last chunk,
   one-column chunks, widths that are no multiple of 4, 5022 genomes, no
   k-mer and the default chunk width (its peak device memory under the
   matrix plus three chunks); BitMatrix.from_u64 on the card against the
   CPU's; the wrapper at an odd column offset; a load behind a busy
   stream.
4. Correctness at reduced size: a 342 x 200,000 in-memory artifact with a
   5-fold split; ``learn_SCM(engine="device")`` must give the host
   engine's fingerprint (hyperparameters, score, rules, tie sets,
   importances, metrics, classifications), ``learn_CART(engine="device")``
   the host engine's whole fingerprint (hyperparameters with the pruning
   alpha, CV score, tree, rules, tie sets, importances, metrics,
   classifications), and ``learn_CART(engine="device-argmax")`` the host
   engine's tree and train and test metrics (the argmax engine keeps no tie
   sets). Then a three-class 600 x 50,000 artifact, whose large nodes take
   the exact engine's gather regime (which must run):
   ``learn_CART(engine="device")`` must give the host engine's whole
   fingerprint there too. The same exact engines streamed (the budget
   set by GRM_HBM_BUDGET_BYTES below the matrix, so that it stays in host
   memory): SCM and CART at 342 x 200,000 in chunks of 2^16 columns and
   the three-class artifact in chunks of 2^14, through its gather regime,
   must give the host engines' whole fingerprints, each pass over 4
   chunks from pinned memory. Then the device ingest from FASTA files, 40
   genomes of 200 kbp, k = 31: ``InMemoryDataset.from_contigs_device``
   through the single builder and the batched one (batches of 32, without
   and with the singleton filter) must give the host oracle's union and
   matrix (each genome's ``sorted_kmers_np`` through the plain versions on
   the CPU, merged with numpy), and ``train_scm`` on it the rules, split
   and metrics of ``train_scm`` on a BitMatrix built on the host from the
   same matrix. Then dataset creation from the same 40 genomes, as FASTA
   files and as read directories (reads of 150 bases at 3x, half of each
   genome's in a gzipped file): ``from_contigs`` and ``from_reads``
   (abundance_min 2) into a MemoryArtifact on the card must equal the same
   call on the CPU, array for array and attr for attr (``uuid`` and
   ``created`` aside), at k = 15, 31 and 33, with and without the
   singleton filter; and ``count_fasta(keep_counts=True)`` on the card the
   CPU's k-mers and counts.
   Then meshes that name cuda:0 several times (the one card standing in
   for several): ``learn_SCM`` with both device engines on a (1, 4) mesh
   at 342 x 200,000 and on a (1, 8) mesh at 342 x 200,003 (K ragged over
   the shards), ``learn_SCM(device-argmax)`` on a (2, 2) mesh (the scan
   engine), ``learn_CART`` with both device engines on (1, 4) at two
   classes and on the three-class artifact (whose gather regime must run
   sharded), and a 1% k-mer blacklist through the SCM grid's and the CART
   scorer's combines on (1, 4): each must give its unsharded run's whole
   fingerprint. Then the multi-process build: two processes share the
   card and exchange over gloo through a file store in a temporary
   directory, each counting its round-robin half of the 40 genomes at k =
   31, without and with the singleton filter; both ranks' union and matrix
   must equal ``build_presence_matrix`` over the same genomes byte for
   byte, and a genome list that differs between the ranks must fail fast
   on both. Then meshes that span processes (``--mesh-worker``, gloo, each
   process naming cuda:0), at ``grm_tpu``'s multi-process yardsticks (60
   genomes x 517 k-mers): two processes x 4 devices run
   ``scm_cv_grid_sharded``, which must equal ``scm_cv_batch_device`` on the
   unsharded matrix; four processes x 2 devices run three
   ``scm_device_step``s on a (2, 4) mesh whose both axes cross processes,
   which must equal one process's (2, 4) mesh; a rank whose fits differ
   must fail every rank with the mismatch. Then the CLI on one card:
   ``learn scm --engine device
   --n-devices 2`` exits 1 with "exceeds the 1 available local device(s)"
   before it loads anything, and ``--n-devices 1`` over a 342 x 20,000
   artifact in memory (by its ``memory://`` path) places nothing on a mesh
   and writes the model and metrics of the command without the flag.
5. The main paths at full scale: 342 genomes x 9,600,000 k-mers (the
   published median, BASELINE.md), 5-fold split, built in memory from
   --seed with the benchmark's recipe (a planted 3-marker conjunction plus
   decoys). Seven learn paths, each driven with the launch counts set to 0 just
   before it and read just after: ``learn_SCM(engine="device")`` over the
   2 model types x 10 p grid, max 10 rules, plus ``write_scm_outputs``
   (what ``learn scm`` runs by default); ``learn_SCM(engine=
   "device-argmax")``; ``learn_CART(engine="device")`` (what ``learn
   tree`` runs by default on the card) with both criteria, depth 10, plus
   ``write_cart_outputs``; ``learn_CART(engine="device-argmax")``, the
   same; ``learn_CART(engine="host")`` with Gini, depth 3; then
   ``device-streamed`` and ``tree-device-streamed``: ``learn_SCM`` and
   ``learn_CART`` with engine "device" again, the budget at 512 MiB so
   that the 422 MB matrix streams from pinned host memory in the default
   chunks of 2^21 columns (5, the last ragged); each must give its
   resident path's fingerprint; then ``device-sharded``,
   ``device-argmax-sharded``, ``tree-device-sharded`` and
   ``tree-device-argmax-sharded``: the four paths before them on a (1, 4)
   mesh of cuda:0, each loading its own sharded matrix (each shard's
   columns split straight onto its device, two ``deinterleave_u64``
   launches a shard), each giving its unsharded path's fingerprint and
   printing its launches beside the unsharded ones. Then the same four
   paths on a (1, 4) mesh that spans two processes (``device-procs``,
   ``device-argmax-procs``, ``tree-device-procs``,
   ``tree-device-argmax-procs``): the artifact written once into a
   temporary directory, two ``--mesh-worker`` processes each naming cuda:0
   twice, each mapping the artifact's files, loading only its own shards
   once (``load-procs``: the ``load`` stage, its peak device bytes under
   its shards plus three chunks) and learning the four paths; every
   rank's fingerprint must equal the unsharded path's, each path must
   launch its kernels, and the ranks' launch sums must equal the
   ``*-sharded`` paths' counts; each rank's process start, load, walls
   and collectives (count and host seconds) are printed. The resident and
   sharded paths load the artifact
   on their own first (the ``load`` stage, timed with the port's
   StageTimer: ``ds.bit_matrix``, the u64 bytes to the device matrix
   through the pinned staging ring and deinterleave_u64, one load of 7
   chunks), then learn on the loaded dataset; the stages and the load's
   peak device memory are printed, and the peak must stay under the
   matrix plus three chunks. Each path
   must launch the kernels it is built on (PATH_KERNELS) and learn a model
   with at least one rule and finite importances. Then the results-site
   step, which launches no kernel: ``amr_database`` set in a temporary
   settings file, ``collect amr`` through the port's CLI on a synthetic
   PATRIC table of 100,000 rows from --seed (its 50/50 list, then one
   dataset with every filter, exported), ``results site`` over the
   reports of ``device`` and ``tree-device``, served by ``serve_site`` on
   port 0; index.html, a details.html and summary.json fetched with
   urllib, summary.json held to the runs' results.json. One more run of each
   device path under torch.profiler must give the same fingerprint, and
   give the device time by kernel and the device's busy share of the
   run; for ``device``, ``tree-device`` and the streamed paths also the
   host-to-device copies by kind (pinned or pageable: the chunk uploads
   must be pinned), their bytes, time and rate, and the share of their
   time during which a kernel ran. The profiled ``device-argmax`` run is
   traced by the port's ``profiling.torch_trace``, whose Chrome trace file
   must be there.
   Then ``ingest-device``: the batched build on the card of 342 genomes
   of 4.4 Mbp from --seed (k = 31, batches of 32, the singleton filter)
   and ``train_scm``, which must learn a planted marker. Then the ninth
   path, ``create-contigs``: ``ingest-device``'s genomes written as FASTA
   files of one contig with their labels as a metadata TSV (set-up), then
   ``from_contigs`` into a MemoryArtifact on the card (each genome counted
   by one ``kmer_canon`` launch and a sort, the union merged on the host;
   k = 31, the singleton filter), then the artifact loaded once (the
   ``load`` stage), ``split_with_proportion`` (5 folds) and
   ``learn_SCM(engine="device")`` on the loaded dataset. It must give ``ingest-device``'s union
   and matrix (genome rows mapped by id: ``from_contigs`` orders genomes
   by label), 342 ``kmer_canon`` launches, and learn the three planted
   markers; each stage's wall is printed with the card's name and power
   limit (FASTA encode, counting on the card with its transfers, host
   merge, artifact write, split, learn), with the whole create's Mbp/s
   and the host's peak RSS. Then ``build-distributed``: two processes
   (``--build-worker``) on the card over ``create-contigs``' FASTA files
   (k = 31, the singleton filter), each counting its round-robin half;
   both ranks' union and matrix must equal ``create-contigs``'; each
   process's counting, exchange and merge walls, launches and peak RSS
   are printed.
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
   The exact CART kernels at the largest frontier ``learn_CART(engine=
   "device")`` gave each (the tuple tables; the equivalence compaction,
   and the gather compaction at the tables' frontier), on a synthetic
   frontier of that size with the engine's thresholds, and at an all-hit
   node (the hot-key case), each equal to its plain version, with bounds as
   above (the distinct splits' divisions and logs, the b1 counting of N x
   (C + 1) mask rows, the matrix read and the outputs); the tuple tables'
   pass-bitmap fill also on its own, on a line of its own. The four ingest
   kernels at phase 5's shapes (one 32-genome batch; every batch's union;
   the merged matrix), each a call of its wrapper by CUDA events with the
   hand kernels' own device time beside it, against the bytes bound
   (build_columns also with its ``ptxas`` registers and spills), and
   ``torch.sort`` at one batch on a line of its own. deinterleave_u64 over
   the whole 342 x 9.6M matrix in one launch against its bytes bound, its
   plain version and ``torch.stack`` of the strided halves
   (``library_ms``); then the load itself, BitMatrix.from_u64 through the
   pinned staging against the parent's host split and pageable upload
   (old, new, new, old), with the host's share of each. Every timing
   line carries the card's ``nvidia-smi`` name and power limit.

The last lines of standard output are the kernels' JSON line, the card's
``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``. In the kernels' line, ``launches`` is
the sum of the paths' counts and ``launches_by_path`` gives each path's
own (``build-distributed``'s and the ``*-procs`` paths' are their
processes' sums; ``load-procs`` holds the process-spanning mesh's loads).
Kernel libraries are built into ``grm_tpu_torch/_kernels/``.
"""

import argparse
import contextlib
import json
import os
import re
import shutil
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
# Phase 4's three-class artifact: its root and first nodes have count
# lattices past the tuple tables' 65,536, so the exact engine gathers.
TRI_GENOMES, TRI_KMERS = 600, 50_000
SMALL_DEPTH = 3  # phase 4: the depth of the planted 3-marker conjunction
N_FOLDS = 5
MAX_RULES = 10
# The ingest path (phase 5): the published median genome count, each genome
# a copy of one M. tuberculosis-sized backbone (4.4 Mbp) with 20,000 SNPs
# from a shared pool, sized so that the union after the singleton filter
# lands near the published median of 9.6M k-mers.
INGEST_GENOMES, INGEST_LENGTH = 342, 4_400_000
INGEST_SNPS, INGEST_POOL = 20_000, 115_000
INGEST_UNION = (8_500_000, 11_000_000)  # where the union must land
INGEST_K, INGEST_BATCH = 31, 32
INGEST_BUDGET = 1 << 24  # k_budget and batch_budget, as bench.py:181 sets them
SMALL_INGEST = (40, 200_000)  # phase 4: genomes x bases, from FASTA files
# Phase 4's dataset creation cases (tests/test_torch_cuda.py takes them
# too): from_contigs and from_reads on SMALL_INGEST's genomes, reads of
# CREATE_READ_LENGTH bases at CREATE_COVERAGE x cut from them.
CREATE_CASE_KS = (15, 31, 33)
CREATE_READ_LENGTH, CREATE_COVERAGE, CREATE_ABUNDANCE_MIN = 150, 3, 2
# Phase 3's ingest kernel cases (tests/test_torch_cuda.py takes them too).
INGEST_CASE_KS = (1, 9, 15, 16, 17, 30, 31, 32, 33, 64)
INGEST_CASE_GENOMES = (1, 31, 32, 33, 64)
INGEST_CASE_LENGTH = 2 * 2048 + 77  # a multiple of no tile or bucket
# kmer_canon also at a row length that is 16-byte aligned (its staging's
# vector loads) and ends mid-run in the second tile of the sort key's
# layout (tiles of 4096 windows, runs of 32: csrc/kmer.cu).
INGEST_CANON_LENGTH = 4096 + 48
# build_columns over many of its tiles (4096 rows at k <= 31, 2048 at
# k <= 64: csrc/device_build.cu), with one k-mer's word over whole tiles.
HOT_CASE_KS, HOT_CASE_GENOMES = (31, 33), 64
HOT_CASE_LENGTH, HOT_RUN = 16 * 4096 + 77, 1000
# merge_columns on batches of genome rows [0, 32), [32, 64), [64, 70), and
# [0, 64) (two word rows), [64, 70), of INGEST_CASE_LENGTH codes, each
# bucket sized as the batched builder sizes it without a batch budget (the
# last one smaller); k = 32 takes one key plane with a validity plane, 33
# and 64 two planes.
MERGE_CASE_KS = (9, 31, 32, 33, 64)
MERGE_CASE_SPLITS = ((0, 32, 64, 70), (0, 64, 70))
# Streaming (a matrix past 60% of the device memory budget stays in host
# memory and goes up chunk by chunk). Phase 3's chunk-source case: 11 word
# rows (342 genomes), 8 chunks of 4096 columns, the last ragged: more chunks
# than the two upload buffers. Phase 4 streams 342 x 200,000 in chunks of
# 2^16 (4 chunks, the last ragged); phase 5 streams 342 x 9.6M at the
# default 2^21 (5 chunks, the last 1,211,392 columns) under a budget whose
# 60% is below the 422 MB packed matrix.
STREAM_CASE = (11, 7 * 4096 + 123, 4096)
SMALL_STREAM = (1 << 20, 1 << 16)  # GRM_HBM_BUDGET_BYTES, chunk columns
STREAM_BUDGET = 512 << 20
# Meshes of a repeated cuda:0 (the one-card machine's stand-in for several
# cards): phase 5's sharded paths take MESH_CARDS column shards; phase 4's
# (1, 8) mesh runs on SHARDED_KMERS columns, ragged over the shards.
MESH_CARDS = 4
SHARDED_KMERS = 200_003
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
    # XLA programs on the TPU (no pallas_call): _distinct_chunk, with
    # _tuple_scatter_chunk (:124) and _winner_chunk (:293); _gather2_chunk,
    # with _gather_pass (:321) and _equiv_chunk (:469).
    "cart_exact_tuples": ("grm_tpu_torch/csrc/cart_exact.cu",
                          "grm_tpu/parallel/cart_exact.py:165"),
    "cart_exact_select": ("grm_tpu_torch/csrc/cart_exact.cu",
                          "grm_tpu/parallel/cart_exact.py:437"),
    # The device ingest's XLA programs (no pallas_call): _extract_canon;
    # _build after its sort; _merge_ranks with _scatter_batch_columns
    # (:207); _compact_singletons.
    "kmer_canon": ("grm_tpu_torch/csrc/kmer.cu", "grm_tpu/ops/kmer.py:137"),
    "build_columns": ("grm_tpu_torch/csrc/device_build.cu",
                      "grm_tpu/parallel/device_build.py:92"),
    "merge_columns": ("grm_tpu_torch/csrc/device_build.cu",
                      "grm_tpu/parallel/device_build.py:158"),
    "compact_columns": ("grm_tpu_torch/csrc/device_build.cu",
                        "grm_tpu/parallel/device_build.py:222"),
    # An XLA program on the TPU (no pallas_call): the artifact's matrix
    # split after its upload, in BitMatrix.from_u64 (:297).
    "deinterleave_u64": ("grm_tpu_torch/csrc/deinterleave.cu",
                         "grm_tpu/ops/popcount.py:69"),
}
# The kernels each main path is built on. learn scm: the exact engine's
# pass 1 and pass 2; the argmax engine's CV sweep, its winner-block recount,
# and its full-train fit (parallel/mesh.py). learn tree: the exact engine's
# pass 1 (the frontier sweep), its tuple tables and its compaction of the
# chosen master's equivalence sets; the argmax engine's frontier sweep; the
# host engine's per-node class counts. The streamed paths: the same exact
# engines' kernels on each chunk uploaded from host memory (pass 2 of SCM on
# the compacted hit superblocks). Device ingest: the windows, the
# batch columns, the union merge, the singleton filter (its column counts
# inside its kernel), then train_scm's greedy steps (popcount_colsum).
# Dataset creation: each genome's windows (counted on the card, merged on
# the host), then learn_SCM's exact engine. Each path that loads a resident
# artifact splits its matrix on the card (deinterleave_u64, one launch a
# staged chunk).
PATH_KERNELS = {
    "device": ("deinterleave_u64", "scm_sweep_sbmax", "popcount_colsum_pairs"),
    "device-argmax": ("deinterleave_u64", "scm_sweep_argmax",
                      "popcount_colsum_pairs", "popcount_colsum"),
    "tree-device": ("deinterleave_u64", "cart_sweep", "cart_exact_tuples",
                    "cart_exact_select"),
    "tree-device-argmax": ("deinterleave_u64", "cart_sweep"),
    "tree-host": ("deinterleave_u64", "popcount_colsum"),
    "device-streamed": ("scm_sweep_sbmax", "popcount_colsum_pairs"),
    "tree-device-streamed": ("cart_sweep", "cart_exact_tuples",
                             "cart_exact_select"),
    "ingest-device": ("kmer_canon", "build_columns", "merge_columns",
                      "compact_columns", "popcount_colsum"),
    "create-contigs": ("kmer_canon", "deinterleave_u64", "scm_sweep_sbmax",
                       "popcount_colsum_pairs"),
    "build-distributed": ("kmer_canon",),
}
# The sharded paths run their unsharded path's kernels, once a shard.
SHARDED_PATHS = ("device", "device-argmax", "tree-device",
                 "tree-device-argmax")
PATH_KERNELS.update({p + "-sharded": PATH_KERNELS[p] for p in SHARDED_PATHS})
# The same four paths on a (1, MESH_CARDS) mesh that spans PROCS processes
# (--mesh-worker), each process loading its shards once ("load-procs", the
# processes' deinterleave_u64 launches), then learning the four paths.
PROCS = 2
PATH_KERNELS.update({p + "-procs": tuple(k for k in PATH_KERNELS[p]
                                         if k != "deinterleave_u64")
                     for p in SHARDED_PATHS})
PATH_KERNELS["load-procs"] = ("deinterleave_u64",)
# grm_tpu's multi-process yardsticks (tests/test_distributed_build.py):
# genomes x k-mers, the CV grid's p values and folds, the rule budget.
YARDSTICK = (60, 517)
YARDSTICK_PS, YARDSTICK_FOLDS, YARDSTICK_RULES = (0.5, 2.0), 2, 4
# The CUDA function each wrapper launches, as torch.profiler names it.
KERNEL_FUNCTIONS = {
    "popcount_colsum": "colsum_kernel",
    "popcount_colsum_pairs": "colsum_pairs_kernel",
    "scm_sweep_argmax": "scm_sweep_kernel<0,",
    "scm_sweep_sbmax": "scm_sweep_kernel<1,",
    "cart_sweep": ("cart_sweep_kernel", "cart_sweep_table_kernel"),
    "cart_exact_tuples": ("cart_exact_tuples_kernel",
                          "cart_exact_bitmap_kernel"),
    "cart_exact_select": ("cart_exact_select_kernel",
                          "cart_exact_write_kernel"),
    "kmer_canon": "kmer_canon_kernel",
    "build_columns": "build_columns_tile_kernel",
    "merge_columns": "merge_columns_tile_kernel",
    "compact_columns": "compact_columns_tile_kernel",
    "deinterleave_u64": "deinterleave_u64_kernel",
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


def synthetic_arrays(n_genomes, n_kmers, seed, n_classes=2):
    """The benchmark artifact's recipe (bench.py:254-300), in memory: ~75%
    dense noise, a planted conjunction of three markers (marker i absent on
    third i of the negatives, lightly flip-noised) and 20 noisier decoys.
    With more than two classes, the genomes fall into equal classes and the
    first decoys become one flip-noised marker per class."""
    from grm_tpu_torch.utils import pack_binary_bytes_to_ints

    rng = np.random.RandomState(seed)
    # sorted by label, like the reference
    labels = (np.arange(n_genomes) * n_classes // n_genomes).astype(np.uint8)
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
        col = (labels > 0).astype(np.uint8)
        flips = rng.choice(n_genomes, max(2, n_genomes * (30 + 2 * (i % 6))
                                          // 100), replace=False)
        col[flips] = 1 - col[flips]
        matrix[:, c] = pack_binary_bytes_to_ints(col[:, None], 64)[:, 0]
    if n_classes > 2:
        for cl, c in enumerate(marker_cols[3:3 + n_classes]):
            col = (labels == cl).astype(np.uint8)
            flips = rng.choice(n_genomes, n_genomes // 20, replace=False)
            col[flips] = 1 - col[flips]
            matrix[:, c] = pack_binary_bytes_to_ints(col[:, None], 64)[:, 0]
    arrays = {
        "genome_identifiers": np.array([("g%05d" % i).encode()
                                        for i in range(n_genomes)]),
        "phenotype": labels,
        "phenotype_tags": np.array([b"%d" % c for c in range(n_classes)]),
        "kmer_sequences": _kmer_sequence_block(0, n_kmers, 31),
        "kmer_by_matrix_column": np.arange(n_kmers, dtype=np.uint32),
        "kmer_matrix": matrix,
    }
    attrs = {"uuid": "smoke-%dx%d-seed%d" % (n_genomes, n_kmers, seed),
             "genomic_data": "synthetic://median",
             "phenotype_description": "synthetic resistance",
             "phenotype_metadata_source": "synthetic://labels"}
    return arrays, attrs


def build_artifact(n_genomes, n_kmers, seed, device, n_classes=2):
    from grm_tpu_torch.dataset import from_numpy_artifact, split_with_proportion

    arrays, attrs = synthetic_arrays(n_genomes, n_kmers, seed, n_classes)
    mem = from_numpy_artifact(arrays, attrs)
    split_with_proportion(mem, "sp", train_prop=0.67, random_seed=42,
                          n_folds=N_FOLDS, device=device)
    return mem


# -- AMR metadata -------------------------------------------------------------

AMR_ROWS = 100_000  # phase 5's results-site step: rows of the AMR table
# PATRIC_genomes_AMR.txt's columns in its order: the six that grm reads and
# some it does not.
AMR_HEADER = ("genome_id", "genome_name", "taxon_id", "antibiotic",
              "resistant_phenotype", "measurement", "measurement_sign",
              "measurement_value", "measurement_unit",
              "laboratory_typing_method", "source")
AMR_SPECIES = ("Escherichia coli K-12", "escherichia COLI str. 536",
               "[Klebsiella] pneumoniae subsp.", "Klebsiella pneumoniae",
               "Staphylococcus aureus MRSA", "Mycobacterium tuberculosis H37Rv",
               "Salmonella enterica serovar", "Acinetobacter baumannii",
               "Pseudomonas aeruginosa PAO1", "Enterococcus faecium",
               "Neisseria gonorrhoeae", "Streptococcus  pneumoniae")
AMR_DRUGS = ("ampicillin", "ciprofloxacin", "gentamicin", "isoniazid",
             "methicillin", "meropenem", "rifampin", "tetracycline",
             "vancomycin", "trimethoprim/sulfamethoxazole")


def write_amr_table(path, n_rows, seed):
    """A synthetic PATRIC AMR table of ``n_rows`` data rows from ``seed``:
    the file's columns in its order, species and drugs drawn skewed (so that
    some groups pass the 50/50 list filter and some do not), genomes tested
    against several drugs; exact duplicate rows, empty cells, ``NA``,
    ``nan`` and ``N/A`` strings, disk-diffusion (``mm``) rows, Intermediate
    and other phenotypes, genomes whose rows contradict each other, quoted
    names (one holding a tab), short rows and blank lines."""
    rng = np.random.default_rng(seed)
    zipf = lambda n: (1.0 / np.arange(1, n + 1) ** 1.2) / np.sum(
        1.0 / np.arange(1, n + 1) ** 1.2)
    sp = rng.choice(len(AMR_SPECIES), n_rows, p=zipf(len(AMR_SPECIES)))
    dr = rng.choice(len(AMR_DRUGS), n_rows, p=zipf(len(AMR_DRUGS)))
    gid = rng.integers(0, max(n_rows // 4, 1), n_rows)
    pheno = rng.choice(["Resistant", "Susceptible", "Intermediate",
                        "Non-susceptible", ""], n_rows,
                       p=[0.46, 0.44, 0.06, 0.02, 0.02])
    meas = rng.choice(["8", "0.5", "16", ">=32", "<=0.25", "NA", "nan", "",
                       "2"], n_rows)
    unit = rng.choice(["mg/L", "mm", "", "N/A"], n_rows,
                      p=[0.9, 0.05, 0.03, 0.02])
    kind = rng.random(n_rows)
    lines = ["\t".join(AMR_HEADER)]
    rows = []
    for i in range(n_rows):
        if rows and kind[i] < 0.05:  # an exact duplicate of an earlier row
            row = list(rows[rng.integers(len(rows))])
        elif rows and kind[i] < 0.07:  # the same test, the other phenotype
            row = list(rows[rng.integers(len(rows))])
            row[4] = "Susceptible" if row[4] == "Resistant" else "Resistant"
        else:
            name = AMR_SPECIES[sp[i]]
            if kind[i] > 0.995:
                name = '"%s\tisolate %d"' % (name, i)
            elif kind[i] > 0.99:
                name = '"%s, isolate %d"' % (name, i)
            row = ["%d.%d" % (1000 + sp[i], gid[i]), name,
                   str(1000 + sp[i]), AMR_DRUGS[dr[i]], pheno[i], meas[i],
                   "", meas[i], unit[i], "Broth dilution", "lab %d" % (i % 7)]
        rows.append(row)
        if kind[i] < 0.001:
            lines.append("")
        lines.append("\t".join(row[:6] if 0.4 < kind[i] < 0.402 else row))
    with open(path, "w", newline="") as f:
        f.write("\n".join(lines) + "\n")
    return path


# -- ingest data --------------------------------------------------------------

def ingest_genomes(n_genomes, length, n_snps, pool, seed, k=INGEST_K):
    """Genomes for the ingest path: each a copy of one random backbone of
    ``length`` bases (from ``seed``) carrying ``n_snps`` SNPs drawn from a
    shared pool of ``pool`` sites, plus a planted 3-marker conjunction as
    synthetic_arrays plants it (genomes sorted by label; marker i absent on
    third i of the negatives, lightly flip-noised). A marker is a SNP at a
    site no pool site comes within k of, so that its k windows are the same
    in every genome that carries it.

    Returns (int8 code arrays, labels, {canonical k-mer string of a
    marker's window: that marker's index})."""
    rng = np.random.RandomState(seed)
    backbone = rng.randint(0, 4, length).astype(np.int8)
    sites = rng.choice(np.arange(k, length - k), pool, replace=False)
    alt = ((backbone[sites] + rng.randint(1, 4, pool)) % 4).astype(np.int8)
    near = np.zeros(length + 1, np.int32)  # pool sites within k of a base
    np.add.at(near, np.maximum(sites - k, 0), 1)
    np.add.at(near, np.minimum(sites + k + 1, length), -1)
    near = np.cumsum(near)[:length] > 0
    markers = []
    for s in rng.permutation(np.flatnonzero(~near[k:length - k]) + k):
        if all(abs(s - m) > k for m in markers):
            markers.append(int(s))
            if len(markers) == 3:
                break
    else:
        raise ValueError("the SNP pool leaves no room for 3 markers")
    markers = np.array(markers)
    malt = ((backbone[markers] + rng.randint(1, 4, 3)) % 4).astype(np.int8)
    labels = (np.arange(n_genomes) * 2 // n_genomes).astype(np.uint8)
    carries = np.ones((3, n_genomes), bool)
    thirds = np.array_split(rng.permutation(np.where(labels == 0)[0]), 3)
    for i in range(3):
        carries[i, thirds[i]] = False
        flips = rng.choice(n_genomes, max(1, n_genomes * (1 + i) // 200),
                           replace=False)
        carries[i, flips] = ~carries[i, flips]
    codes_list = []
    for g in range(n_genomes):
        c = backbone.copy()
        chosen = rng.choice(pool, n_snps, replace=False)
        c[sites[chosen]] = alt[chosen]
        c[markers[carries[:, g]]] = malt[carries[:, g]]
        codes_list.append(c)
    comp = str.maketrans("ACGT", "TGCA")
    marker_kmers = {}
    for i, (s, a) in enumerate(zip(markers, malt)):
        seq = backbone[s - k + 1:s + k].copy()
        seq[k - 1] = a
        text = "".join("ACGT"[b] for b in seq)
        for t in range(k):
            w = text[t:t + k]
            marker_kmers[min(w, w.translate(comp)[::-1])] = i
    return codes_list, labels, marker_kmers


def ingest_codes(rng, n_genomes, length, k):
    """(n_genomes, length) int8 codes for phase 3's kernel cases: a shared
    random half (columns with many genomes), a repeat inside each row
    (duplicate windows), runs of 4s (invalid bases and contig separators),
    and, in row 0, a contig shorter than k followed by padding."""
    codes = rng.randint(0, 4, (n_genomes, length)).astype(np.int8)
    codes[:, :length // 2] = codes[0, :length // 2]
    codes[:, length // 2:length // 2 + 300] = codes[:, :300]
    for row in codes:
        for _ in range(rng.randint(1, 6)):
            at = rng.randint(0, length)
            row[at:at + rng.randint(1, 40)] = 4
    short = max(k - 1, 1)
    codes[0] = 4
    codes[0, :short] = rng.randint(0, 4, short)
    return codes


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


def learn(mem, engine, device, mesh=None, blacklist=None):
    """learn_SCM on ``mem``, an in-memory artifact or a GrmDataset (whose
    loaded matrix then serves), over ``mesh`` where one is given, with the
    k-mer blacklist file ``blacklist``."""
    from grm_tpu_torch.dataset import as_dataset
    from grm_tpu_torch.learning.experiments import learn_SCM

    return learn_SCM(
        dataset_file=mem, split_name="sp",
        model_type=["conjunction", "disjunction"], p=P_GRID,
        max_rules=MAX_RULES, max_equiv_rules=10000,
        parameter_selection="cv", random_seed=42, bound_delta=0.05,
        bound_max_genome_size=as_dataset(mem, device).kmer_count,
        engine=engine, mesh=mesh, kmer_blacklist_file=blacklist,
        device=device)


def learn_tree(mem, engine, device, criterion, max_depth, mesh=None,
               blacklist=None):
    """learn_CART on ``mem``, as :func:`learn` takes it."""
    from grm_tpu_torch.dataset import as_dataset
    from grm_tpu_torch.learning.experiments import learn_CART

    ds = as_dataset(mem, device)
    n_classes = len(ds.phenotype.tags)
    return learn_CART(
        dataset_file=mem, split_name="sp", criterion=criterion,
        max_depth=[max_depth], min_samples_split=[2],
        class_importance=[{c: 1.0 for c in range(n_classes)}],
        bound_delta=0.05, bound_max_genome_size=ds.kmer_count,
        kmer_blacklist_file=blacklist, parameter_selection="cv",
        engine=engine, mesh=mesh, device=device)


def tree_fingerprint(out, selection=True):
    """Everything learn_CART decides. Without ``selection``, only what the
    host and the argmax engine must agree on: the tree, its rules and
    importances, the metrics and the classifications. Exact ties between
    rules go to the most frequent k-mer on the host and to the lowest column
    in the argmax engine, so tie sets, fold trees, and with them the CV
    score and the pruning alpha, may differ by design (the exact engine
    agrees with the host on all of it)."""
    best_hp, score, train_m, test_m, model, imps, equiv, cls = out
    norm = lambda m: None if m is None else {
        k: np.asarray(v, np.float64).tolist() for k, v in m.items()}
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


def check_exact_tree(mem, host_out, device, what):
    """Phase 4: ``learn_CART(engine="device")`` with both criteria must give
    the host engine's whole fingerprint (``host_out`` is the host run's
    output). Returns the exact kernels (and select modes) it launched."""
    from grm_tpu_torch.ops import _build

    want = tree_fingerprint(host_out)
    _build.reset_launches()
    t0 = time.time()
    got = tree_fingerprint(learn_tree(mem, "device", device,
                                      list(CART_CRITERIA), SMALL_DEPTH))
    wall = time.time() - t0
    modes = {kname for kname, _, _ in _build.exact_frontiers}
    if got != want:
        raise AssertionError("learn_CART: device != host at %s:\n%s\n%s"
                             % (what, got, want))
    log("    learn_CART(engine='device', depth %d) at %s: whole fingerprint "
        "== host (hp %s, cv score %.5f, %d rules, tie set sizes %s); %.1f s; "
        "exact launches %s"
        % (SMALL_DEPTH, what, got["hp"], got["score"], len(got["rules"]),
           [len(e) for e in got["equiv"]], wall, sorted(modes)))
    return modes


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


def exact_inputs(rng, n, c, n_genomes, small, device):
    """A frontier of n nodes over c classes for the exact CART kernels,
    every node with its own train mask (nodes of different trees): disjoint
    class masks of random examples. With ``small`` every node's count
    lattice fits the tuple tables, and (from two nodes on) the last node
    holds one example of each of two classes, so that nearly every column
    falls on one of four keys: the all-hit node, once its threshold is
    +inf. Returns (masks, train masks, n_node, priors, totals)."""
    import torch

    from grm_tpu_torch.ops.cart_exact import S_MAX

    w = -(-n_genomes // 32)
    bits = np.uint32(1) << (31 - np.arange(n_genomes) % 32).astype(np.uint32)
    per_class = int(S_MAX ** (1.0 / c)) - 1 if small else n_genomes
    masks = np.zeros((n, c, w), np.uint32)
    train = np.zeros((n, w), np.uint32)
    for i in range(n):
        for ci in range(c):
            m = rng.randint(0, min(per_class, n_genomes // c) + 1)
            rows = rng.choice(np.arange(ci, n_genomes, c), m, replace=False)
            np.bitwise_or.at(masks[i, ci], rows // 32, bits[rows])
        rows = np.where(rng.rand(n_genomes) < 0.7)[0]
        np.bitwise_or.at(train[i], rows // 32, bits[rows])
    if small and n > 1:
        masks[-1] = 0
        for ci in range(2):
            masks[-1, ci, 0] = bits[ci]
    n_node = np.unpackbits(masks.view(np.uint8), axis=2).sum(2)
    priors = (rng.rand(n, c) + 0.1).astype(np.float32)
    totals = rng.randint(n_genomes // 2, n_genomes, size=(n, c))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (to(masks.view(np.int32)), to(train.view(np.int32)),
            to(n_node.astype(np.int32)), to(priors),
            to(totals.astype(np.float32)))


def exact_thresholds(matrix, masks, n_node, priors, totals, criterion, limit,
                     excl):
    """The exact engine's per-node thresholds: pass 1's float32 minima (the
    frontier sweep) plus the engine's margin."""
    from grm_tpu_torch.ops import cart_sweep as cs
    from grm_tpu_torch.parallel.cart_exact import _thresh_from_gmin

    _, gmin = cs.cart_frontier_scores(matrix, masks, n_node, priors, totals,
                                      criterion, limit, excl=excl)
    return _thresh_from_gmin(gmin, float(masks.shape[1])).contiguous()


# Pass-bitmap cases of phase 3 and tests/test_torch_cuda.py: (n_node rows,
# share of each lattice passing). C = 2, 3 and 8; a lattice of exactly
# S_MAX; thresholds of -inf (no key passes) and +inf (every key with two
# non-empty children); an empty class; a node of one example.
BITMAP_CASES = [
    ([[255, 255], [3, 7], [0, 9], [1, 0]], [0.01, 0.3, np.inf, np.inf]),
    ([[40, 30, 20], [7, 0, 5], [1, 1, 1]], [0.02, -np.inf, np.inf]),
    ([[2, 1, 3, 0, 1, 2, 1, 1], [1] * 8], [0.1, np.inf]),
]


def bitmap_inputs(rng, rows, shares, criterion, device):
    """(n_node, scale, thresh) of a pass-bitmap case: a finite share sets the
    node's threshold at that quantile of its lattice's scores."""
    import torch

    from grm_tpu_torch.ops import cart_exact as ce
    from grm_tpu_torch.ops import cart_sweep as cs

    n_node = torch.from_numpy(np.asarray(rows, np.int32))
    n, c = n_node.shape
    scale = torch.from_numpy((rng.rand(n, c) + 0.1).astype(np.float32))
    thresh = torch.tensor(shares, dtype=torch.float32)
    for i, q in enumerate(shares):
        if np.isfinite(q):
            size = int(ce.lattice_sizes(n_node[i:i + 1])[0])
            left = torch.from_numpy(np.stack(ce.decode_keys(
                np.arange(size), n_node[i].numpy())))[None]
            score, ok = cs._split_scores(left, n_node[i:i + 1],
                                         scale[i:i + 1], criterion)
            thresh[i] = float(torch.quantile(score[ok].double(), q))
    return n_node.to(device), scale.to(device), thresh.to(device)


def winning_keys(rows, n):
    """Per node, every second present key of the tuple tables' rows, and an
    occurrence maximum: -1 (any) for odd nodes, the largest present
    occurrence for even ones."""
    import torch

    node, key, occmax = (r.cpu().numpy() for r in rows[:3])
    keys = [key[node == i][::2] for i in range(n)]
    occ = [-1 if i % 2 else int(occmax[node == i].max(initial=-1))
           for i in range(n)]
    return keys, torch.tensor(occ, dtype=torch.int32)


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

    from grm_tpu_torch.ops import cart_exact as ce

    def as_long(out):
        return tuple(t.long() for t in out if t is not None)

    def exact_case(mat, genomes, n, c, criterion, excl_on):
        """Both exact kernels against their plain versions: the tuple
        tables and the equivalence compaction on a frontier of small nodes
        (the last one all-hit), the gather compaction on it and on a
        frontier of large nodes."""
        kk = mat.shape[1]
        limit = kk - 5
        ex = None
        if excl_on:
            ex = torch.from_numpy((rng.rand(kk) < 0.2).astype(np.uint8)
                                  ).to(device)
        what = "W=%d K=%d N=%d C=%d %s excl=%s" % (mat.shape[0], kk, n, c,
                                                   criterion, excl_on)
        for small_nodes in (True, False):
            masks, train, n_node, priors, totals = exact_inputs(
                rng, n, c, genomes, small_nodes, device)
            scale = (priors / totals).contiguous()
            thresh = exact_thresholds(mat, masks, n_node, priors, totals,
                                      criterion, limit, ex)
            if small_nodes:
                if n > 1:
                    thresh[-1] = float("inf")
                args = (mat, masks, train, n_node, scale, thresh, criterion,
                        limit, ex)
                want = ce.cart_exact_tuples_plain(*args)
                record("cart_exact_tuples", as_long(ce.cart_exact_tuples(
                    *args)), as_long(want), what)
                if not bool((want[0] != 0).any()):
                    raise AssertionError("cart_exact_tuples: no tuple "
                                         "passed at %s" % what)
                keys, occmax = winning_keys(ce.table_rows(*want), n)
                args = (mat, masks, train, n_node, scale, "gini", limit,
                        "equiv")
                kw = dict(occmax=occmax.to(device), excl=ex,
                          bitmap=torch.from_numpy(ce.key_bitmap(keys)
                                                  ).to(device))
                record("cart_exact_select",
                       as_long(ce.cart_exact_select(*args, **kw)),
                       as_long(ce.cart_exact_select_plain(*args, **kw)),
                       "equiv " + what)
            args = (mat, masks, train, n_node, scale, criterion, limit,
                    "gather")
            record("cart_exact_select",
                   as_long(ce.cart_exact_select(*args, thresh=thresh,
                                                excl=ex)),
                   as_long(ce.cart_exact_select_plain(*args, thresh=thresh,
                                                      excl=ex)),
                   "gather " + what)

    for kk in (k, 3001):
        mat = matrix if kk == k else matrix[:, :kk].contiguous()
        for n, c in ((1, 2), (18, 2), (65, 2), (18, 3)):
            for criterion in CART_CRITERIA:
                for excl_on in (False, True):
                    exact_case(mat, n_genomes, n, c, criterion, excl_on)
    for criterion in CART_CRITERIA:  # W = 157: nodes over grid rows
        exact_case(m, wide, 65, 2, criterion, True)
        exact_case(m, wide, 65, 3, criterion, False)
        exact_case(m, wide, 18, 3, criterion, False)
    # The pass bitmaps on their own: C = 2, 3 and 8, a lattice of exactly
    # S_MAX, thresholds of -inf and +inf, an empty class.
    for rows, shares in BITMAP_CASES:
        for criterion in CART_CRITERIA:
            n_node, scale, thresh = bitmap_inputs(rng, rows, shares,
                                                  criterion, device)
            want = ce.pass_bitmap_plain(n_node, scale, thresh, criterion)
            record("cart_exact_tuples",
                   ce.pass_bitmap(n_node, scale, thresh, criterion), want,
                   "pass bitmap %s %s" % (rows, criterion))
            if not bool((want[0] != 0).any()):
                raise AssertionError("pass bitmap: no key passed at %s"
                                     % rows)
    return worst, ulps


def exact_err(got, want):
    """0.0 where every tensor of ``got`` equals ``want``'s (None where
    both are None), else the largest absolute difference (inf for another
    shape or type)."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for a, b in zip(got, want):
        if a is None or b is None:
            if (a is None) != (b is None):
                return float("inf")
            continue
        a, b = a.cpu(), b.cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            return float("inf")
        if not torch.equal(a, b):
            worst = max(worst, float((a.double() - b.double()).abs().max())
                        or float("inf"))
    return worst


def full_bucket_genomes(rng, k, n_genomes=32, n_kmers=1024):
    """Genomes whose canonical k-mers number exactly ``n_kmers`` together
    (each genome is ``n_kmers`` / 32 of them, one contig each, plus one
    shared k-mer), so that a batch budget of ``n_kmers`` fills its bucket
    exactly."""
    from grm_tpu_torch.ops.kmer import encode_contigs

    comp = str.maketrans("ACGT", "TGCA")
    canon = lambda s: min(s, s.translate(comp)[::-1])
    kmers = {}
    while len(kmers) < n_kmers:
        s = "".join(rng.choice(list("ACGT"), k))
        kmers.setdefault(canon(s), s)
    seqs = list(kmers.values())
    per = n_kmers // n_genomes
    return [encode_contigs(seqs[g * per:(g + 1) * per] + [seqs[-1]])
            for g in range(n_genomes)]


def ingest_case(device, rng, k, n_genomes, record):
    """One of phase 3's ingest kernel cases (k, G): kmer_canon (at
    INGEST_CASE_LENGTH and INGEST_CANON_LENGTH), build_columns (with a
    budget the union fits and one it overflows), compact_columns,
    merge_columns (rows [0, 32) and [32, G) merged, as the batched builder
    merges batches) on the card against their plain versions on the same
    inputs. ``record(name, got, want, what)`` compares."""
    import torch

    from grm_tpu_torch.ops import device_build as db
    from grm_tpu_torch.ops import kmer as km
    from grm_tpu_torch.parallel import device_build as pdb

    g, n = n_genomes, INGEST_CASE_LENGTH
    nw = km.n_words_for_k(k)
    what = "k=%d G=%d L=%d" % (k, g, n)
    codes = torch.from_numpy(ingest_codes(rng, g, n, k)).to(device)
    single = k <= km.MAX_SINGLE_KEY_K

    def canon(codes, what):
        record("kmer_canon", km.kmer_canon(codes, k),
               km.kmer_canon_plain(codes, k), what)
        if single:
            record("kmer_canon", km.kmer_canon(codes, k, key=True),
                   km.kmer_canon_plain(codes, k, key=True), what + " key")

    canon(codes, what)
    keys, valid = km.window_keys(codes, k)
    keys, perm, valid = km.sort_keys(keys, valid)
    for budget in (g * n, 700):
        record("build_columns",
               db.build_columns(keys, perm, valid, nw, n, budget),
               db.build_columns_plain(keys, perm, valid, nw, n, budget),
               "%s k_budget=%d" % (what, budget))
    matrix, union, n_kmers = db.build_columns(keys, perm, valid, nw, n,
                                              g * n)
    record("compact_columns", db.compact_columns(matrix, union, n_kmers),
           db.compact_columns_plain(matrix, union, n_kmers), what)
    bounds = [0, 32, g] if g > 32 else [0, g]
    parts = [pdb._build(codes[lo:hi].contiguous(), k, g * n, False)
             + (lo // 32,) for lo, hi in zip(bounds, bounds[1:])]
    merge_case(parts, k, -(-g // 32), (g * n, 700), what, record)
    canon(torch.from_numpy(ingest_codes(rng, g, INGEST_CANON_LENGTH,
                                        k)).to(device),
          "k=%d G=%d L=%d" % (k, g, INGEST_CANON_LENGTH))


def merge_case(parts, k, w_total, budgets, what, record):
    """merge_columns on the card against its plain version (merge_ranks
    and a scatter per batch) at each of ``budgets``: ``parts`` are the
    batches, (matrix (wb, bucket), union (bucket, nw), valid rows (1,)
    or an int, w_off) each, merged as the batched builder merges them."""
    import torch

    from grm_tpu_torch.ops import device_build as db
    from grm_tpu_torch.ops import kmer as km

    words = torch.cat([p[1] for p in parts])
    valids = torch.cat([torch.arange(p[1].shape[0], device=words.device)
                        < p[2] for p in parts])
    keys, perm, valid = km.sort_keys(
        km.pair_keys(words.T, valids),
        None if k <= km.MAX_SINGLE_KEY_K else valids)
    batches = [(p[0], p[3]) for p in parts]
    nw = km.n_words_for_k(k)
    for budget in budgets:
        record("merge_columns",
               db.merge_columns(keys, perm, valid, batches, nw, budget,
                                w_total),
               db.merge_columns_plain(keys, perm, valid, batches, nw, budget,
                                      w_total),
               "%s merge k_budget=%d" % (what, budget))


def merge_cases(device, rng, k, record):
    """Phase 3's merges of MERGE_CASE_SPLITS at k: each batch built with a
    bucket of its own, the next power of two from 1024 at or above its
    window count (the last bucket smaller), then merged as built (with a
    budget the union fits and one it overflows), with no valid row (every
    batch's count 0), and with every row valid (each batch cut to its
    count, so that every bucket is exactly full)."""
    import torch

    from grm_tpu_torch.parallel import device_build as pdb

    n = INGEST_CASE_LENGTH
    for split in MERGE_CASE_SPLITS:
        g = split[-1]
        codes = torch.from_numpy(ingest_codes(rng, g, n, k)).to(device)
        parts = []
        for lo, hi in zip(split, split[1:]):
            bucket = 1 << max(10, ((hi - lo) * n - 1).bit_length())
            parts.append(pdb._build(codes[lo:hi].contiguous(), k, bucket,
                                    False) + (lo // 32,))
        buckets = [p[0].shape[1] for p in parts]
        what = "k=%d G=%d L=%d buckets %s" % (k, g, n, buckets)
        w_total = -(-g // 32)
        merge_case(parts, k, w_total, (sum(buckets), 700), what, record)
        merge_case([(m, u, 0, w) for m, u, _, w in parts], k, w_total,
                   (sum(buckets),), what + ", no valid row", record)
        counts = [int(p[2]) for p in parts]
        full = [(m[:, :c].contiguous(), u[:c].contiguous(), c, w)
                for (m, u, _, w), c in zip(parts, counts)]
        merge_case(full, k, w_total, (sum(counts), 700),
                   what + ", every row valid", record)


def hot_kmer_case(device, rng, k, record):
    """Phase 3's many-tile build_columns case: HOT_CASE_GENOMES rows of
    HOT_CASE_LENGTH codes (ingest_codes), each with a run of HOT_RUN As at
    random, so that the all-A k-mer, the first column, has 32 x (HOT_RUN -
    k + 1) rows in its first matrix word: several whole tiles, whose
    chunks all take the atomic path. Against the plain version with a
    budget the union fits and one it overflows."""
    import torch

    from grm_tpu_torch.ops import device_build as db
    from grm_tpu_torch.ops import kmer as km

    g, n = HOT_CASE_GENOMES, HOT_CASE_LENGTH
    codes = ingest_codes(rng, g, n, k)
    for row in codes:
        at = rng.randint(0, n - HOT_RUN)
        row[at:at + HOT_RUN] = 0
    keys, valid = km.window_keys(torch.from_numpy(codes).to(device), k)
    keys, perm, valid = km.sort_keys(keys, valid)
    nw = km.n_words_for_k(k)
    for budget in (g * n, 700):
        record("build_columns",
               db.build_columns(keys, perm, valid, nw, n, budget),
               db.build_columns_plain(keys, perm, valid, nw, n, budget),
               "k=%d G=%d L=%d, a run of %d As, k_budget=%d"
               % (k, g, n, HOT_RUN, budget))


def ingest_builder_cases(device, rng, record):
    """Phase 3's builder cases: build_matrix_device and
    build_matrix_device_batched on the card against the same builders run
    through the plain versions on the CPU, with and without the singleton
    filter, at k = 16, 31 and 33 (70 genomes: three batches, a ragged
    tail), at the all-T k-mer of k = 16 and 32, and with a batch whose
    bucket is exactly full."""
    from grm_tpu_torch.ops import kmer as km
    from grm_tpu_torch.parallel import device_build as pdb

    def builders(codes_list, k, what, **batched):
        for fs in (False, True):
            for build, kw in ((pdb.build_matrix_device, {}),
                              (pdb.build_matrix_device_batched, batched)):
                got = build(codes_list, k, filter_singleton=fs,
                            device=device, **kw)
                want = build(codes_list, k, filter_singleton=fs,
                             device="cpu", **kw)
                record("builders", (got.matrix, got.union_words),
                       (want.matrix, want.union_words),
                       "%s %s filter=%s" % (build.__name__, what, fs))
                if got.n_kmers != want.n_kmers:
                    raise AssertionError("%s %s: %d k-mers, plain %d"
                                         % (build.__name__, what,
                                            got.n_kmers, want.n_kmers))

    for k in (16, 31, 33):
        codes_list, _, _ = ingest_genomes(70, 3000, 10, 40, k, k=k)
        builders(codes_list, k, "k=%d, 70 genomes" % k, batch_budget=16000)
    for k in (16, 32):
        poly_t = "T" * (k + 3)
        contig_sets = [
            [poly_t + "N" + "".join(rng.choice(list("ACGT"), 60))],
            ["".join(rng.choice(list("ACGT"), 60)) + "NN" + poly_t],
            ["N" * (k + 2), "".join(rng.choice(list("ACGT"), 60))],
        ]
        builders([km.encode_contigs(c) for c in contig_sets], k,
                 "all-T k=%d" % k)
    full = full_bucket_genomes(rng, 31)
    dm = pdb.build_matrix_device_batched(full, 31, batch_budget=1024,
                                         device=device)
    if dm.n_kmers != 1024:
        raise AssertionError("the full-bucket batch holds %d k-mers, not "
                             "1024" % dm.n_kmers)
    builders(full, 31, "bucket exactly full", batch_budget=1024)


def check_ingest_kernels(device):
    """Phase 3, ingest: kmer_canon, build_columns, merge_columns and
    compact_columns equal their plain versions exactly on the card at every
    (k, G) of INGEST_CASE_KS x INGEST_CASE_GENOMES (ingest_case),
    build_columns over many tiles (hot_kmer_case), merge_columns on
    unequal batches (merge_cases), then the builders
    (ingest_builder_cases).
    Returns the largest error per kernel (all 0.0)."""
    rng = np.random.RandomState(5)
    worst = {}

    def record(name, got, want, what):
        err = exact_err(got, want)
        worst[name] = max(worst.get(name, 0.0), err)
        if err != 0.0:
            raise AssertionError("%s differs from its plain version at %s "
                                 "(max abs err %r)" % (name, what, err))

    for k in INGEST_CASE_KS:
        for g in INGEST_CASE_GENOMES:
            ingest_case(device, rng, k, g, record)
    for k in HOT_CASE_KS:
        hot_kmer_case(device, rng, k, record)
    for k in MERGE_CASE_KS:
        merge_cases(device, rng, k, record)
    ingest_builder_cases(device, rng, record)
    return worst

# -- streaming ----------------------------------------------------------------

def stream_cases(device, rng, record):
    """Phase 3, streaming (tests/test_torch_cuda.py runs it too): the chunk
    source's double-buffered uploads, with the current stream kept busy so
    that the copies run ahead of it, against a plain upload of each chunk,
    bit for bit, and popcount_colsum on each against its plain version on
    the plain upload; the upload of hit superblocks (the ragged last one
    among them); StreamingBitMatrix.presence_counts on the card against its
    run on the CPU."""
    import torch

    from grm_tpu_torch.ops import popcount as pc
    from grm_tpu_torch.ops.stream import ChunkSource

    w, k, ch = STREAM_CASE
    words = rng.randint(0, 2**32, size=(w, k), dtype=np.uint64).astype(
        np.uint32)

    def fill(dst, lo, hi):
        dst[...] = words[:, lo:hi]

    src = ChunkSource(w, k, fill, ch, device)
    if not src.host.is_pinned():
        raise AssertionError("the chunk layout is not in pinned memory")
    masks = _words(rng, (3, w), device)
    copies, counts = [], []
    for _, _, chunk in src.chunks():
        torch.cuda._sleep(1 << 21)  # the kernels' stream lags the copies
        copies.append(chunk.clone())
        counts.append(pc.popcount_colsum(chunk, masks))
    if len(copies) != src.n_chunks or src.n_chunks <= 2:
        raise AssertionError("the chunk source gave %d of %d chunks"
                             % (len(copies), src.n_chunks))
    padded = np.zeros((w, src.n_chunks * ch), np.uint32)
    padded[:, :k] = words
    for ci, (got, cnt) in enumerate(zip(copies, counts)):
        plain = torch.from_numpy(np.ascontiguousarray(
            padded[:, ci * ch:(ci + 1) * ch]).view(np.int32)).to(device)
        what = "chunk %d of %d" % (ci, src.n_chunks)
        record("chunk upload", got, plain, what)
        record("popcount_colsum", cnt, pc.popcount_colsum_plain(plain, masks),
               what)
    sb, sbs = 1024, [0, 5, 6, 4 * src.n_chunks - 1]
    want = np.zeros((w, 8 * sb), np.uint32)
    for i, s in enumerate(sbs):
        want[:, i * sb:(i + 1) * sb] = padded[:, s * sb:(s + 1) * sb]
    record("superblock upload", src.superblocks(sbs, sb, 8 * sb),
           torch.from_numpy(want.view(np.int32)).to(device),
           "superblocks %s" % sbs)
    rows = [rng.choice(342, 100, replace=False), np.arange(342)]
    record("popcount_colsum", torch.from_numpy(
        pc.StreamingBitMatrix(words, 342, ch, device).presence_counts(rows)),
        torch.from_numpy(pc.StreamingBitMatrix(words, 342, ch, "cpu")
                         .presence_counts(rows)),
        "StreamingBitMatrix.presence_counts")


def check_stream(device):
    """Phase 3, streaming: :func:`stream_cases`. Returns the largest error
    per check (all 0.0)."""
    worst = {}

    def record(name, got, want, what):
        err = exact_err(got, want)
        worst[name] = max(worst.get(name, 0.0), err)
        if err != 0.0:
            raise AssertionError("%s differs from its plain version at %s "
                                 "(max abs err %r)" % (name, what, err))

    stream_cases(device, np.random.RandomState(12), record)
    return worst


# Phase 3's deinterleave_u64 cases (tests/test_torch_cuda.py runs them too):
# (genomes, k-mers, chunk columns: LOAD_CHUNK_BYTES made that small, the
# load's widths being multiples of 4). 342 genomes give W64 = 6 uint64 rows
# and 11 word rows (an odd W64's last low half dropped); 96 and 352 are
# multiples of 32 but not of 64; chunks that leave the last one ragged, K
# that is no multiple of 4 (the kernel's word-by-word path), the default
# chunk width (None), no k-mer. Up to ONE_COLUMN_K k-mers, the wrapper also
# splits the matrix in one-column chunks.
DEINTERLEAVE_CASES = [(342, 1_000_003, 1 << 18), (342, 4099, 4),
                      (96, 100_001, 7776), (352, 65_536, 65_536),
                      (64, 1000, 332), (5022, 30_001, 4096), (1, 17, 4),
                      (342, 3_000_001, None), (342, 0, None)]
ONE_COLUMN_K = 5000


def load_peak(load, n_words, k):
    """``load()``, a load of a (n_words, k) matrix on the card, with the
    peak device memory it allocated: returns (its result, the peak bytes,
    the bound: the matrix plus three staging chunks of the load's width).
    Fails past the bound."""
    import torch

    from grm_tpu_torch.ops.popcount import load_chunk_cols

    w64 = -(-n_words // 2)
    bound = 4 * n_words * k + 3 * 8 * w64 * min(load_chunk_cols(w64), k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = load()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if peak > bound:
        raise AssertionError("the load of a %dx%d matrix peaked at %d bytes "
                             "on the card, past the matrix plus three "
                             "chunks (%d)" % (n_words, k, peak, bound))
    return out, peak, bound


def deinterleave_cases(device, rng, record):
    """Phase 3, the artifact's matrix split: for each of DEINTERLEAVE_CASES
    the chunked split on the card (split_u64, the pinned staging ring) one
    launch a chunk, against the host split (u64_matrix_to_u32) and against
    the plain version on the card; BitMatrix.from_u64 on the card against
    the CPU's; the wrapper alone at a column offset that is no multiple of
    4, and in one-column chunks; the split with the current stream kept
    busy, so that the host must
    wait before it refills a staging buffer; and, at the default chunk
    width, the load's peak device memory under the matrix plus three
    chunks."""
    import torch

    from grm_tpu_torch.ops import _build
    from grm_tpu_torch.ops import popcount as pc

    def matrix(n_rows, k):
        w64 = -(-n_rows // 64)
        return np.frombuffer(rng.bytes(8 * w64 * k), np.uint64).reshape(
            w64, k).copy()

    @contextlib.contextmanager
    def chunks(w64, cols):
        """split_u64's staged chunks ``cols`` columns wide for ``w64``
        uint64 rows (None: the default width)."""
        saved = pc.LOAD_CHUNK_BYTES
        if cols is not None:
            pc.LOAD_CHUNK_BYTES = 8 * w64 * cols
            assert pc.load_chunk_cols(w64) == cols
        try:
            yield
        finally:
            pc.LOAD_CHUNK_BYTES = saved

    for n_rows, k, chunk in DEINTERLEAVE_CASES:
        m64 = matrix(n_rows, k)
        n_words = -(-n_rows // 32)
        w64 = m64.shape[0]
        what = "%d genomes x %d, chunks of %s" % (n_rows, k, chunk)
        want = torch.from_numpy(
            pc.u64_matrix_to_u32(m64)[:n_words].view(np.int32))
        n0 = _build.launches["deinterleave_u64"]
        if chunk is None:
            got, peak, bound = load_peak(
                lambda: pc.split_u64(m64, n_words, device), n_words, k)
            log("    deinterleave_u64: the load of %s peaked at %d bytes on "
                "the card, under the matrix plus three chunks (%d)"
                % (what, peak, bound))
        else:
            with chunks(w64, chunk):
                got = pc.split_u64(m64, n_words, device)
        with chunks(w64, chunk):
            n_chunks = -(-k // pc.load_chunk_cols(w64)) if k else 0
        if _build.launches["deinterleave_u64"] - n0 != n_chunks:
            raise AssertionError("deinterleave_u64: %d launches for %d chunks "
                                 "at %s" % (_build.launches["deinterleave_u64"]
                                            - n0, n_chunks, what))
        record("deinterleave_u64", got, want, what + " (host split)")
        raw = torch.from_numpy(m64.view(np.int32).reshape(w64, 2 * k)).to(
            device)
        record("deinterleave_u64", got, pc.deinterleave_u64_plain(
            raw, n_words), what + " (plain version on the card)")
        with chunks(w64, chunk):
            record("deinterleave_u64", pc.BitMatrix.from_u64(
                m64, n_rows, device).data, pc.BitMatrix.from_u64(
                m64, n_rows, "cpu").data, what + " (BitMatrix.from_u64)")
        if k >= 8:  # the wrapper alone, at an odd column offset
            out = torch.full((n_words, k + 5), -7, dtype=torch.int32,
                             device=device)
            plain = out.clone()
            plain[:, 3:3 + k] = pc.deinterleave_u64_plain(raw, n_words)
            record("deinterleave_u64", pc.deinterleave_u64(raw, out, 3),
                   plain, what + " (the wrapper at offset 3)")
        if 0 < k <= ONE_COLUMN_K:  # the wrapper in one-column chunks
            out = torch.full((n_words, k), -7, dtype=torch.int32,
                             device=device)
            for lo in range(k):
                pc.deinterleave_u64(raw[:, 2 * lo:2 * lo + 2].contiguous(),
                                    out, lo)
            record("deinterleave_u64", out, want.to(device),
                   what + " (the wrapper in one-column chunks)")
        del raw
    # The current stream busy: the kernels queue behind it while the host
    # fills the staging ring, so every refill must wait for its copy.
    m64 = matrix(342, 90_001)
    torch.cuda._sleep(int(2e8))
    with chunks(6, 10_000):
        got = pc.split_u64(m64, 11, device)
    record("deinterleave_u64", got, torch.from_numpy(
        pc.u64_matrix_to_u32(m64)[:11].view(np.int32)),
        "342 x 90,001 in 10 chunks behind a busy stream")


def check_deinterleave(device):
    """Phase 3, the artifact's matrix split: :func:`deinterleave_cases`.
    Returns the largest error (0.0)."""
    worst = [0.0]

    def record(name, got, want, what):
        err = exact_err(got, want)
        worst[0] = max(worst[0], err)
        if err != 0.0:
            raise AssertionError("%s differs at %s (max abs err %r)"
                                 % (name, what, err))

    deinterleave_cases(device, np.random.RandomState(14), record)
    return worst[0]


@contextlib.contextmanager
def streaming(budget, chunk_cols=None):
    """``GRM_HBM_BUDGET_BYTES`` (and ``GRM_STREAM_CHUNK_COLS``, unset for
    the default) for the block: a dataset that builds its matrix inside
    keeps it in host memory and streams it."""
    names = ("GRM_HBM_BUDGET_BYTES", "GRM_STREAM_CHUNK_COLS")
    saved = {n: os.environ.get(n) for n in names}
    os.environ[names[0]] = str(budget)
    if chunk_cols is None:
        os.environ.pop(names[1], None)
    else:
        os.environ[names[1]] = str(chunk_cols)
    try:
        yield
    finally:
        for n, v in saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v


class ChunkWatch:
    """Records, while active, every pass over a chunk source: the sources
    (each is a streamed matrix) and the chunks of each pass."""

    def __enter__(self):
        from grm_tpu_torch.ops.stream import ChunkSource

        self.cls, self.orig = ChunkSource, ChunkSource.chunks
        self.sources, self.passes = [], []
        watch = self

        def chunks(src):
            if all(s is not src for s in watch.sources):
                watch.sources.append(src)
            watch.passes.append(0)
            for item in watch.orig(src):
                watch.passes[-1] += 1
                yield item

        ChunkSource.chunks = chunks
        return self

    def __exit__(self, *exc):
        self.cls.chunks = self.orig

    def summary(self):
        """A line: passes, chunks a pass, bytes uploaded; fails if nothing
        streamed or a layout is not pinned."""
        if not self.passes or not self.sources:
            raise AssertionError("no chunked sweep ran")
        if not all(s.host.is_pinned() for s in self.sources):
            raise AssertionError("a chunk layout is not in pinned memory")
        return ("%d chunked passes (chunks a pass: %s), %d matrix bytes "
                "uploaded" % (len(self.passes), sorted(set(self.passes)),
                              self.uploaded()))

    def uploaded(self):
        return sum(s.bytes_uploaded for s in self.sources)


def _measure(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def transfer_summary(prof, what, uploaded):
    """The host-to-device copies of a profiled run, by kind (pinned or
    pageable): count, bytes, device ms, GB/s; and the share of the copies'
    time during which a kernel ran (copy/compute overlap). ``uploaded`` is
    the bytes the chunk sources copied in that run: the pinned copies must
    carry at least as many. Returns the summary, or None where the profile
    holds no copies."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    copies = [e for e in events if "HtoD" in e.get("name", "")]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "kernel"]
    if not copies:
        log("    %s: host-to-device copies not measured (no events)" % what)
        return None
    kinds = {}
    for e in copies:
        kind = kinds.setdefault(e["name"], {"count": 0, "bytes": 0,
                                            "ms": 0.0})
        kind["count"] += 1
        kind["bytes"] += int(e.get("args", {}).get("bytes", 0))
        kind["ms"] += e["dur"] / 1e3
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in copies]
    copy_us = _measure(spans)
    both_us = copy_us + _measure(kernels) - _measure(spans + kernels)
    pinned = sum(v["bytes"] for k, v in kinds.items() if "Pinned" in k)
    pinned_n = sum(v["count"] for k, v in kinds.items() if "Pinned" in k)
    out = {"uploaded_bytes": uploaded, "pinned_bytes": pinned,
           "htod_ms": copy_us / 1e3,
           "overlap_share": both_us / copy_us if copy_us else 0.0,
           "by_kind": kinds}
    for k, v in sorted(kinds.items()):
        log("      %s: %d copies, %d bytes, %.3f ms, %.2f GB/s"
            % (k, v["count"], v["bytes"], v["ms"],
               v["bytes"] / v["ms"] / 1e6 if v["ms"] else 0.0))
    log("    %s: %d bytes uploaded by the chunk sources; host-to-device "
        "%.3f ms of copies, %.1f%% of it beside a kernel"
        % (what, uploaded, out["htod_ms"], 100.0 * out["overlap_share"]))
    if uploaded and not pinned_n:
        raise AssertionError("%s: no pinned host-to-device copy" % what)
    if uploaded and pinned and pinned < uploaded:  # where the trace has bytes
        raise AssertionError("%s: the chunk uploads (%d bytes) were not all "
                             "pinned copies (%d bytes pinned)"
                             % (what, uploaded, pinned))
    return out


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
                 frontier, exact_sizes):
    """Phase 6: each kernel at the main paths' shapes against its plain
    version on the same inputs, with its bounds; one JSON line each, with
    its launches on each main path. ``frontier`` is the number of nodes
    cart_sweep is timed at, ``exact_sizes`` the (kernel, nodes, classes)
    of the exact engine's launches on its path, ``b1_per_s`` and
    ``sfu_per_s`` the measured rates of the 1-bit tensor-core product and
    the special-function unit, ``popc_per_s`` the scalar POPC pipe's rate
    by the 16-a-clock rule."""
    import torch

    from grm_tpu_torch.ops import cart_sweep as cs
    from grm_tpu_torch.ops import popcount as pc
    from grm_tpu_torch.ops import scm_sweep as sw

    rng = np.random.RandomState(7)
    matrix = bm.data
    w, k = matrix.shape
    rows = {}
    card = nvidia_smi("name,power.limit")

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
                        "launches": {e: paths[e][name] for e in paths},
                        "card": card}))

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
    time_exact_kernels(row, rng, matrix, device, exact_sizes, card)
    return rows


def time_exact_kernels(row, rng, matrix, device, exact_sizes, card):
    """Phase 6's rows of the exact CART kernels (Gini, the CLI's default
    criterion), through ``row`` of :func:`time_kernels`: the tuple tables at
    the largest frontier the exact engine gave them, and the equivalence
    compaction at the largest it gave that (the winning keys: every present
    key of the tables), on synthetic frontiers of those sizes with the
    engine's thresholds; the gather compaction at the tables' frontier; and
    both at an all-hit node (one example of each of two classes, every
    valid split passing: nearly every column on one of four keys, the
    hot-key case). The tuple tables' pass-bitmap fill is also timed on its
    own at the largest frontier, on a line of its own beside ``card``."""
    import torch

    from grm_tpu_torch.ops import cart_exact as ce

    w, k = matrix.shape
    genomes = 32 * w
    criterion, c = "gini", 2
    largest = {}
    for kname, n, _ in exact_sizes:
        kname = kname.split(":")[0]
        largest[kname] = max(largest.get(kname, 0), n)
    nb = -(-k // ce.BLOCK_K)

    def as_long(out):
        return tuple(t.long() for t in out if t is not None)

    def exact(name):
        def compare(got, want):
            err = max_abs_err(as_long(got), as_long(want))
            if err != 0.0:
                raise AssertionError("%s differs from its plain version at "
                                     "the main path's shapes (%r)"
                                     % (name, err))
            return err
        return compare

    def frontier(n, all_hit):
        if all_hit:  # one node: one example of each class, +inf threshold
            masks, train, n_node, priors, totals = exact_inputs(
                rng, 2, c, genomes, True, device)
            masks, train, n_node, priors, totals = (
                t[-1:].contiguous() for t in (masks, train, n_node, priors,
                                              totals))
            thresh = torch.full((1,), float("inf"), device=device)
        else:
            masks, train, n_node, priors, totals = exact_inputs(
                rng, n, c, genomes, True, device)
            masks[-1] = masks[0]  # no all-hit node here
            n_node[-1] = n_node[0]
            thresh = exact_thresholds(matrix, masks, n_node, priors, totals,
                                      criterion, k, None)
        return (masks, train, n_node, (priors / totals).contiguous(),
                thresh)

    def rate_args(n, n_node):
        """(bytes every exact sweep moves, AND + POPC words, divisions of
        the distinct splits)."""
        return (4 * w * k + n * (c + 1) * 4 * w + 8 * n * c,
                n * (c + 1) * w * k, 2 * distinct_splits(n_node, k))

    for tag, n in (("", largest.get("cart_exact_tuples", 1)),
                   ("all-hit", 1)):
        masks, train, n_node, scale, thresh = frontier(n, bool(tag))
        args = (matrix, masks, train, n_node, scale, thresh, criterion, k)
        nbytes, words, special = rate_args(n, n_node)
        tables = int(ce.lattice_sizes(n_node).sum())
        present = int((ce.cart_exact_tuples_plain(*args)[0] != 0).sum())
        row("cart_exact_tuples", lambda: ce.cart_exact_tuples(*args),
            lambda: ce.cart_exact_tuples_plain(*args),
            nbytes + 12 * tables, words, 5,
            "W=%d K=%d N=%d C=%d %s%s; %d table entries, %d present"
            % (w, k, n, c, criterion, " " + tag if tag else "", tables,
               present), special=special, special_popc=2 * n * k,
            compare=exact("cart_exact_tuples"),
            key="cart_exact_tuples" + (":" + tag if tag else ""))
        if not tag:
            # The pass-bitmap fill alone (a part of every tuples call).
            fill = lambda: ce.pass_bitmap(n_node, scale, thresh, criterion)
            fill_ms, timed_by = device_ms(fill, 5,
                                          "cart_exact_bitmap_kernel")
            log(json.dumps({"fill": "cart_exact_tuples pass bitmap",
                            "shape": "N=%d C=%d %s; %d keys"
                            % (n, c, criterion, tables), "ms": fill_ms,
                            "timed_by": timed_by,
                            "event_ms": time_cuda(fill, 5), "card": card}))
            # The gather compaction at the same frontier.
            gargs = (matrix, masks, train, n_node, scale, criterion, k,
                     "gather")
            hits = int(ce.cart_exact_select_plain(*gargs,
                                                  thresh=thresh)[0][-1])
            row("cart_exact_select",
                lambda: ce.cart_exact_select(*gargs, thresh=thresh),
                lambda: ce.cart_exact_select_plain(*gargs, thresh=thresh),
                nbytes + 16 * nb * n + 4 * (c + 2) * hits, words, 5,
                "gather W=%d K=%d N=%d C=%d %s; %d hits"
                % (w, k, n, c, criterion, hits), special=special,
                special_popc=2 * n * k, compare=exact("cart_exact_select"),
                key="cart_exact_select:gather")
    for tag, n in (("", largest.get("cart_exact_select", 1)),
                   ("all-hit", 1)):
        masks, train, n_node, scale, thresh = frontier(n, bool(tag))
        node, key = ce.table_rows(*ce.cart_exact_tuples_plain(
            matrix, masks, train, n_node, scale, thresh, criterion, k))[:2]
        node, key = node.cpu().numpy(), key.cpu().numpy()
        bitmap = torch.from_numpy(ce.key_bitmap(
            [key[node == i] for i in range(n)])).to(device)
        occmax = torch.full((n,), -1, dtype=torch.int32, device=device)
        eargs = (matrix, masks, train, n_node, scale, "gini", k, "equiv")
        kw = dict(occmax=occmax, bitmap=bitmap)
        hits = int(ce.cart_exact_select_plain(*eargs, **kw)[0][-1])
        nbytes, words, _ = rate_args(n, n_node)
        row("cart_exact_select",
            lambda: ce.cart_exact_select(*eargs, **kw),
            lambda: ce.cart_exact_select_plain(*eargs, **kw),
            nbytes + 16 * nb * n + 4 * ce.BITMAP_WORDS * n + 4 * hits, words,
            5, "equiv W=%d K=%d N=%d C=%d%s; %d hits"
            % (w, k, n, c, " " + tag if tag else "", hits),
            compare=exact("cart_exact_select"),
            key="cart_exact_select" + (":equiv " + tag if tag else ""))


def _text_lines(text, width):
    """uint8 text -> bytes of lines of ``width`` characters, each ending in
    a newline (the last one shorter)."""
    full = len(text) // width
    out = np.empty((full, width + 1), np.uint8)
    out[:, :width] = text[:full * width].reshape(full, width)
    out[:, width] = ord("\n")
    tail = text[full * width:].tobytes()
    return out.tobytes() + (tail + b"\n" if tail else b"")


def write_fasta(directory, codes_list, cut=True):
    """One FASTA file per genome, two contigs each (cut at a third; one
    without ``cut``), 80 bases a line. Returns (genome id, path) pairs."""
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    specs = []
    for g, codes in enumerate(codes_list):
        at = len(codes) // 3
        contigs = (codes[:at], codes[at:]) if cut else (codes,)
        path = os.path.join(directory, "g%05d.fna" % g)
        with open(path, "wb") as f:
            for i, contig in enumerate(contigs):
                f.write(b">g%05d_c%d\n" % (g, i))
                f.write(_text_lines(lut[contig], 80))
        specs.append(("g%05d" % g, path))
    return specs


def host_union(specs, k, min_genomes):
    """The host oracle of phase 4: each genome's ``sorted_kmers_np``
    through the plain versions on the CPU, merged with numpy. Returns the
    (U, nw) uint32 union of the k-mers in at least ``min_genomes`` genomes
    and its (genomes, U) presence (k <= 32)."""
    from grm_tpu_torch.ops.kmer import encode_contigs, sorted_kmers_np
    from grm_tpu_torch.utils import fasta_to_sequences

    def as_u64(words):
        words = words.astype(np.uint64)
        return words[:, 0] << np.uint64(32) | (
            words[:, 1] if words.shape[1] > 1 else np.uint64(0))

    per = [as_u64(sorted_kmers_np(encode_contigs(fasta_to_sequences(path)),
                                  k, device="cpu")) for _, path in specs]
    union, counts = np.unique(np.concatenate(per), return_counts=True)
    union = union[counts >= min_genomes]
    presence = np.stack([np.isin(union, kmers) for kmers in per])
    words = np.stack([union >> np.uint64(32),
                      union & np.uint64(0xFFFFFFFF)], 1).astype(np.uint32)
    return words[:, :-(-k // 16)], presence


class HostMatrixDataset:
    """``train_scm``'s dataset surface over a BitMatrix uploaded from a host
    copy of a DeviceDataset's matrix, with its columns unpacked on the
    host: what phase 4 holds the device dataset to."""

    def __init__(self, ds, device):
        from grm_tpu_torch.ops.popcount import BitMatrix
        from grm_tpu_torch.utils import unpack_binary_bytes_from_ints

        packed = ds.dm.matrix[:, :ds.kmer_count].cpu().numpy().view(np.uint32)
        self.genome_count, self.kmer_count = ds.genome_count, ds.kmer_count
        self.labels, self.km = ds.labels, ds.km
        self._bm = BitMatrix(packed, ds.genome_count, device=device)
        self._dense = unpack_binary_bytes_from_ints(packed)[:ds.genome_count]

    def bit_matrix(self, sharding=None):
        return self._bm

    def get_matrix_columns(self, columns):
        columns = np.asarray(columns, dtype=np.int64)
        inv = columns >= self.kmer_count
        out = self._dense[:, np.where(inv, columns - self.kmer_count,
                                      columns)].copy()
        out[:, inv] = 1 - out[:, inv]
        return out


def pipeline_fingerprint(res):
    """Everything train_scm decides: rules, split and metrics."""
    norm = lambda m: {key: [float(x) for x in np.ravel(v)]
                      for key, v in m.items()}
    return {"rules": [str(r) for r in res.rules],
            "train_idx": res.train_idx.tolist(),
            "test_idx": res.test_idx.tolist(),
            "train": norm(res.train_metrics), "test": norm(res.test_metrics)}


def check_ingest_small(device, seed, n_genomes=SMALL_INGEST[0],
                       length=SMALL_INGEST[1]):
    """Phase 4, ingest: ``from_contigs_device`` from FASTA files (k = 31),
    through the single builder and the batched one (genome_batch 32), its
    union and matrix against the host oracle, without and (batched) with
    the singleton filter; ``train_scm`` on each equal to ``train_scm`` on a
    BitMatrix built on the host from the same matrix. Returns a summary
    line."""
    from grm_tpu_torch.pipeline import InMemoryDataset, train_scm
    from grm_tpu_torch.utils import pack_binary_bytes_to_ints

    scale = length / INGEST_LENGTH
    codes_list, labels, _ = ingest_genomes(
        n_genomes, length, max(1, round(INGEST_SNPS * scale)),
        max(2, round(INGEST_POOL * scale)), seed)
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        specs = write_fasta(tmp, codes_list)
        by_id = {gid: int(y) for (gid, _), y in zip(specs, labels)}
        oracle = {fs: host_union(specs, INGEST_K, 2 if fs else 1)
                  for fs in (False, True)}
        for batch, fs in ((None, False), (32, False), (32, True)):
            what = "genome_batch=%s filter_singleton=%s" % (batch, fs)
            ds = InMemoryDataset.from_contigs_device(
                specs, by_id, INGEST_K, filter_singleton=fs,
                genome_batch=batch, device=device)
            union, presence = oracle[fs]
            if ds.kmer_count != len(union) or not np.array_equal(
                    ds.dm.union_kmers_host(), union):
                raise AssertionError("from_contigs_device(%s): union of %d "
                                     "k-mers != the host oracle's %d"
                                     % (what, ds.kmer_count, len(union)))
            want = pack_binary_bytes_to_ints(presence.astype(np.uint8), 32)
            got = ds.dm.matrix[:, :len(union)].cpu().numpy().view(np.uint32)
            if not np.array_equal(got, want):
                raise AssertionError("from_contigs_device(%s): matrix != the "
                                     "host oracle's" % what)
            fp = pipeline_fingerprint(train_scm(ds, max_rules=MAX_RULES))
            fp_host = pipeline_fingerprint(train_scm(
                HostMatrixDataset(ds, device), max_rules=MAX_RULES))
            if fp != fp_host:
                raise AssertionError("train_scm(%s): device dataset != host "
                                     "matrix:\n%s\n%s" % (what, fp, fp_host))
            out.append("%s: %d k-mers, rules %s, test risk %.4f"
                       % (what, ds.kmer_count, fp["rules"],
                          fp["test"]["risk"][0]))
    return out


# -- dataset creation ---------------------------------------------------------

def write_reads(directory, codes_list, seed, length=CREATE_READ_LENGTH,
                coverage=CREATE_COVERAGE):
    """One directory of FASTQ reads per genome: reads of ``length`` bases
    cut at random from the genome (``coverage`` x its length), half in a
    plain file and half in a gzipped one. Returns (genome id, directory)
    pairs."""
    import gzip

    rng = np.random.RandomState(seed)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    specs = []
    for g, codes in enumerate(codes_list):
        n = max(2, coverage * len(codes) // length)
        starts = rng.randint(0, len(codes) - length + 1, n)
        seqs = lut[codes[starts[:, None] + np.arange(length)]]
        rec = np.empty((n, 10 + 2 * length + 4), np.uint8)
        rec[:, :10] = np.frombuffer(b"".join(b"@r%07d\n" % i
                                             for i in range(n)),
                                    np.uint8).reshape(n, 10)
        rec[:, 10:10 + length] = seqs
        rec[:, 10 + length:13 + length] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, 13 + length:13 + 2 * length] = ord("I")
        rec[:, -1] = ord("\n")
        rdir = os.path.join(directory, "r%05d" % g)
        os.makedirs(rdir)
        with open(os.path.join(rdir, "a.fastq"), "wb") as f:
            f.write(rec[:n // 2].tobytes())
        with gzip.open(os.path.join(rdir, "b.fastq.gz"), "wb",
                       compresslevel=1) as f:
            f.write(rec[n // 2:].tobytes())
        specs.append(("g%05d" % g, rdir))
    return specs


def write_lists(directory, specs, labels, name):
    """The genome list (``genome_id<TAB>path``) and the metadata TSV
    (``genome_id<TAB>label``) of ``specs``. Returns their paths."""
    paths = (os.path.join(directory, name + ".tsv"),
             os.path.join(directory, name + "_meta.tsv"))
    with open(paths[0], "w") as f:
        f.writelines("%s\t%s\n" % spec for spec in specs)
    with open(paths[1], "w") as f:
        f.writelines("%s\t%d\n" % (gid, y)
                     for (gid, _), y in zip(specs, labels))
    return paths


def artifact_arrays(mem):
    """{name: array} of a MemoryArtifact's datasets and {name: value} of
    its attrs and its datasets' attrs, ``uuid`` and ``created`` aside."""
    arrays = {n: ds.data for n, ds in mem.items() if hasattr(ds, "data")}
    attrs = {k: v for k, v in mem.attrs.items()
             if k not in ("uuid", "created")}
    for n, ds in mem.items():
        attrs.update({"%s.%s" % (n, k): v for k, v in ds.attrs.items()})
    return arrays, attrs


def assert_same_artifact(got, want, what):
    (ga, gt), (wa, wt) = artifact_arrays(got), artifact_arrays(want)
    if gt != wt:
        raise AssertionError("%s: attrs differ:\n%s\n%s" % (what, gt, wt))
    if sorted(ga) != sorted(wa):
        raise AssertionError("%s: datasets %s != %s" % (what, sorted(ga),
                                                         sorted(wa)))
    for name in wa:
        if ga[name].dtype != wa[name].dtype or not np.array_equal(
                ga[name], wa[name]):
            raise AssertionError("%s: %s differs (%s %s against %s %s)"
                                 % (what, name, ga[name].dtype,
                                    ga[name].shape, wa[name].dtype,
                                    wa[name].shape))


def create_inputs(directory, seed, n_genomes=SMALL_INGEST[0],
                  length=SMALL_INGEST[1]):
    """Phase 4's creation inputs: ``check_ingest_small``'s genomes as FASTA
    files and as read directories, each with its genome list and the
    metadata TSV. Returns {"contigs": (list, metadata), "reads": (list,
    metadata), "fasta": [(genome id, path)]}."""
    scale = length / INGEST_LENGTH
    codes_list, labels, _ = ingest_genomes(
        n_genomes, length, max(1, round(INGEST_SNPS * scale)),
        max(2, round(INGEST_POOL * scale)), seed)
    fasta = write_fasta(directory, codes_list)
    reads = write_reads(directory, codes_list, seed)
    return {"contigs": write_lists(directory, fasta, labels, "contigs"),
            "reads": write_lists(directory, reads, labels, "reads"),
            "fasta": fasta}


def create_case(device, inputs, mode, k, filter_singleton):
    """One dataset creation case: ``from_contigs`` (``mode`` "contigs") or
    ``from_reads`` (abundance_min CREATE_ABUNDANCE_MIN) into a
    MemoryArtifact on ``device`` must equal the same call on the CPU,
    array for array and attr for attr (``uuid`` and ``created`` aside).
    Returns the k-mer count."""
    from grm_tpu_torch.dataset import MemoryArtifact, from_contigs, from_reads

    listing, meta = inputs[mode]
    kw = dict(filter_singleton=filter_singleton,
              phenotype_description="planted markers",
              phenotype_metadata_path=meta)
    if mode == "reads":
        fn, kw["abundance_min"] = from_reads, CREATE_ABUNDANCE_MIN
    else:
        fn = from_contigs
    got = fn(listing, MemoryArtifact(), k, device=device, **kw)
    want = fn(listing, MemoryArtifact(), k, device="cpu", **kw)
    assert_same_artifact(got, want, "from_%s(k=%d, filter_singleton=%s)"
                         % (mode, k, filter_singleton))
    return got["kmer_sequences"].shape[0]


def count_case(device, inputs, k):
    """``count_fasta(keep_counts=True)`` on ``device`` against the CPU on
    the first three genomes: k-mers and counts equal. Returns the largest
    count seen."""
    from grm_tpu_torch.kmer.counter import count_fasta

    top = 0
    for gid, path in inputs["fasta"][:3]:
        got = count_fasta(path, k, keep_counts=True, device=device)
        want = count_fasta(path, k, keep_counts=True, device="cpu")
        if not (np.array_equal(got.kmers, want.kmers)
                and np.array_equal(got.counts, want.counts)):
            raise AssertionError("count_fasta(%s, k=%d): %s != cpu"
                                 % (gid, k, device))
        top = max(top, int(got.counts.max(initial=0)))
    return top


def check_create_small(device, seed):
    """Phase 4, dataset creation: every case of CREATE_CASE_KS x the
    singleton filter x (contigs, reads) on the card equal to the CPU, and
    count_fasta at each k. Returns a summary line."""
    sizes = []
    with tempfile.TemporaryDirectory() as tmp:
        inputs = create_inputs(tmp, seed)
        for k in CREATE_CASE_KS:
            top = count_case(device, inputs, k)
            for mode in ("contigs", "reads"):
                for fs in (False, True):
                    sizes.append("%s k=%d%s: %d" % (
                        mode, k, " filtered" if fs else "",
                        create_case(device, inputs, mode, k, fs)))
            sizes.append("count_fasta k=%d: largest count %d" % (k, top))
    return "; ".join(sizes)


def device_matrix_rows(m32, rows):
    """(len(rows), K) bool presence of the genome rows ``rows`` of a packed
    (W, K) int32 tensor (genome g at word g // 32, bit 31 - g % 32)."""
    import torch

    rows = torch.as_tensor(rows, dtype=torch.int64)
    words = m32.index_select(0, (rows // 32).to(m32.device))
    shifts = (31 - rows % 32).to(m32.device)[:, None]
    return ((words.to(torch.int64) >> shifts) & 1).bool()


def count_profile(specs, device, card):
    """Where the card's per-genome counting goes: ``count_fasta`` of
    ``specs`` under torch.profiler, its wall against the device's busy
    time, the copies and kernels by name (outside any path's launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from grm_tpu_torch.kmer.counter import count_fasta

    count_fasta(specs[0][1], INGEST_K, device=device)  # warm
    torch.cuda.synchronize()
    timings = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for gid, path in specs:
            count_fasta(path, INGEST_K, genome_id=gid, device=device,
                        timings=timings)
        wall = time.time() - t0
    rows = sorted(((_device_us(e), e.key, e.count)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and _device_us(e) > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    log("    counting profile (%s), %d genomes: wall %.3f s (profiled; "
        "encode %.3f s, count %.3f s), device time %.2f ms (%.1f%% of the "
        "count wall); by kernel:" % (card, len(specs), wall,
                                     timings["encode"], timings["count"],
                                     busy, 100.0 * busy / 1e3
                                     / timings["count"]))
    for us, key, count in rows[:8]:
        log("      %9.3f ms  %5d x  %s" % (us / 1e3, count, key[:90]))


def run_create(device, seed, paths, ingest, card, then=None):
    """Phase 5, the ``create-contigs`` path: ``ingest-device``'s genomes
    as FASTA files of one contig (as ingest-device counts them) with their
    labels as a metadata TSV (set-up), then
    ``from_contigs`` into a MemoryArtifact on the card (k = 31, the
    singleton filter), ``split_with_proportion`` (5 folds) and
    ``learn_SCM(engine="device")``. Its launches go into ``paths``. Fails
    unless kmer_canon ran once a genome, the union and the matrix (genome
    rows mapped by id) equal ``ingest-device``'s and the three planted
    markers are learnt. ``then(specs)``, where given, runs on the FASTA
    files before they are deleted."""
    import resource

    import torch

    from grm_tpu_torch.dataset import (GrmDataset, MemoryArtifact,
                                       from_contigs, split_with_proportion)
    from grm_tpu_torch.ops import _build
    from grm_tpu_torch.ops.kmer import decode_kmers_bytes
    from grm_tpu_torch.ops.popcount import load_chunk_cols, u64_matrix_to_u32
    from grm_tpu_torch.profiling import StageTimer

    codes_list, labels, marker_kmers, union, matrix = ingest
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        specs = write_fasta(tmp, codes_list, cut=False)  # as ingest-device
        listing, meta = write_lists(tmp, specs, labels, "contigs")
        bytes_on_disk = sum(os.path.getsize(p) for _, p in specs)
        log("    create-contigs inputs: %d FASTA files, %d bytes, written in "
            "%.1f s (set-up)" % (len(specs), bytes_on_disk, time.time() - t0))
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        torch.cuda.synchronize()
        _build.reset_launches()
        timings = {}
        t0 = time.time()
        mem = from_contigs(listing, MemoryArtifact(), INGEST_K,
                           filter_singleton=True,
                           phenotype_description="planted markers",
                           phenotype_metadata_path=meta, device=device,
                           timings=timings)
        t_create = time.time() - t0
        # The artifact loaded once (the ``load`` stage), then split and
        # learnt on the loaded dataset.
        timer = StageTimer()
        ds = GrmDataset(mem, device=device)
        n_words, n_kmers = -(-len(codes_list) // 32), ds.kmer_count
        with timer.stage("load"):
            _, peak, bound = load_peak(ds.bit_matrix, n_words, n_kmers)
        with timer.stage("split"):
            split_with_proportion(ds, "sp", train_prop=0.67, random_seed=42,
                                  n_folds=N_FOLDS, device=device)
            torch.cuda.synchronize()
        with timer.stage("learn"):
            fp = fingerprint(learn(ds, "device", device))
            torch.cuda.synchronize()
        paths["create-contigs"] = dict(_build.launches)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        count_profile(specs[:8], device, card)
        if then is not None:
            then(specs)
    n_genomes = len(codes_list)
    mbp = sum(len(c) for c in codes_list) / 1e6
    t = timer.stages
    log("    create-contigs (%s): from_contigs %.3f s (%.1f Mbp/s): FASTA "
        "encode %.3f s, counting on the card %.3f s (transfers included), "
        "host merge %.3f s, artifact write %.3f s; load %.3f s (peak %d "
        "bytes on the card, matrix + 3 chunks: %d); split %.3f s; learn_SCM"
        "(device) %.3f s; %d k-mers after the singleton filter; host peak "
        "RSS %.2f GB (%.2f GB before the path); launches %s"
        % (card, t_create, mbp / t_create, timings.get("encode", 0.0),
           timings.get("count", 0.0), timings.get("merge", 0.0),
           timings.get("write", 0.0), t["load"], peak, bound, t["split"],
           t["learn"], n_kmers, rss / 1e6, rss0 / 1e6,
           paths["create-contigs"]))
    log("    stages of create-contigs (%s): %s" % (card, ", ".join(
        "%s %.3f s" % kv for kv in t.items())))
    load_chunks = -(-n_kmers // load_chunk_cols(-(-n_words // 2)))
    if paths["create-contigs"]["deinterleave_u64"] != load_chunks:
        raise AssertionError("create-contigs: %d deinterleave_u64 launches, "
                             "not one load's %d" % (paths["create-contigs"]
                                                    ["deinterleave_u64"],
                                                    load_chunks))
    log("    create-contigs: hp %s, cv score %.5f, rules %s, train risk "
        "%.4f, test risk %.4f" % (fp["hp"], fp["score"], fp["rules"],
                                  fp["train"]["risk"][0],
                                  fp["test"]["risk"][0]))
    if paths["create-contigs"]["kmer_canon"] != n_genomes:
        raise AssertionError("create-contigs: %d kmer_canon launches for %d "
                             "genomes" % (paths["create-contigs"]
                                          ["kmer_canon"], n_genomes))
    missing = [k for k in PATH_KERNELS["create-contigs"]
               if paths["create-contigs"][k] == 0]
    if missing:
        raise AssertionError("path 'create-contigs' launched no %s" % missing)
    if n_kmers != len(union) or not np.array_equal(
            mem["kmer_sequences"].data, decode_kmers_bytes(union, INGEST_K)):
        raise AssertionError("create-contigs: union of %d k-mers != "
                             "ingest-device's %d" % (n_kmers, len(union)))
    order = [int(_s(g)[1:]) for g in mem["genome_identifiers"].data]
    m32 = torch.from_numpy(u64_matrix_to_u32(mem["kmer_matrix"].data).view(
        np.int32)).to(device)
    for lo in range(0, n_genomes, 32):
        rows = range(lo, min(lo + 32, n_genomes))
        if not torch.equal(device_matrix_rows(m32, list(rows)),
                           device_matrix_rows(matrix, [order[r]
                                                       for r in rows])):
            raise AssertionError("create-contigs: matrix rows %d-%d != "
                                 "ingest-device's rows of the same genomes"
                                 % (rows[0], rows[-1]))
    del m32
    hit = {marker_kmers[seq] for seq, _ in fp["rules"] if seq in marker_kmers}
    if hit != {0, 1, 2}:
        raise AssertionError("create-contigs learned markers %s of the three"
                             ": %s" % (sorted(hit), fp["rules"]))
    return fp


@contextlib.contextmanager
def settings_file(path):
    """``GRM_SETTINGS_PATH`` set to ``path`` for the block."""
    saved = os.environ.get("GRM_SETTINGS_PATH")
    os.environ["GRM_SETTINGS_PATH"] = path
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("GRM_SETTINGS_PATH", None)
        else:
            os.environ["GRM_SETTINGS_PATH"] = saved


def run_cli(argv):
    """The port's CLI on ``argv``, in process: its standard output."""
    import io

    from grm_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(list(argv))
    return buf.getvalue()


def results_site_step(seed, report_dirs, card):
    """Phase 5's results-site step, after the learn paths (it launches no
    kernel): ``amr_database`` set in a temporary settings file; ``collect
    amr`` through the port's CLI on a synthetic PATRIC table of AMR_ROWS
    rows from ``seed`` (its 50/50 list, then one dataset with every filter,
    exported), its walls printed; ``results site`` over ``report_dirs``
    (path -> the directory its report writer filled), served by
    ``serve_site`` on port 0; ``index.html``, one ``details.html`` and
    ``summary.json`` fetched with urllib, ``summary.json`` held to the runs'
    ``results.json``; the server shut down. Any failure raises."""
    import threading
    import urllib.request

    from grm_tpu_torch.results_site import serve_site

    with tempfile.TemporaryDirectory() as tmp, \
            settings_file(os.path.join(tmp, "settings.json")):
        t0 = time.time()
        amr = write_amr_table(os.path.join(tmp, "PATRIC_genomes_AMR.txt"),
                              AMR_ROWS, seed)
        t_write = time.time() - t0
        run_cli(["settings", "set", "amr_database", amr])
        t0 = time.time()
        listing = run_cli(["collect", "amr", "--list-datasets"])
        t_list = time.time() - t0
        pairs = [line.split("\t") for line in listing.splitlines()]
        if not pairs or any(len(p) != 2 for p in pairs):
            raise AssertionError("collect amr --list-datasets printed %r"
                                 % listing[:200])
        species, drug = pairs[0]
        t0 = time.time()
        out = run_cli(["collect", "amr", "--species", species, "--antibiotic",
                       drug, "--drop-intermediate", "--filter-contradictions",
                       "--numeric-phenotypes", "--output-dir",
                       os.path.join(tmp, "amr")])
        t_collect = time.time() - t0
        folder = out.splitlines()[-1][len("Exported TSVs to "):]
        exported = sorted(os.listdir(folder))
        with open(os.path.join(folder, [f for f in exported if f.endswith(
                "_phenotype_metadata.tsv")][0])) as f:
            labels = {line.split("\t")[1] for line in f.read().splitlines()}
        if not out.startswith("Total: ") or len(exported) != 4 \
                or not labels <= {"0", "1"}:
            raise AssertionError("collect amr printed %r and exported %s "
                                 "with labels %s" % (out, exported, labels))
        log("    results-site (%s): collect amr on a %d-row PATRIC table "
            "(written in %.2f s, set-up): --list-datasets %.3f s (%d "
            "datasets), one dataset with every filter %.3f s: %s"
            % (card, AMR_ROWS, t_write, t_list, len(pairs), t_collect,
               out.splitlines()[0]))
        site = os.path.join(tmp, "site")
        argv = ["results", "site", "--output-dir", site]
        runs = {}
        for path, results_dir in report_dirs.items():
            argv += ["--run", species, "%s %s" % (drug, path), results_dir]
            name = "%s___%s" % (("%s %s" % (drug, path)).lower().replace(
                " ", "_"), species.lower().replace(" ", "_"))
            with open(os.path.join(results_dir, "results.json")) as f:
                runs[name] = json.load(f)
        t0 = time.time()
        run_cli(argv)
        t_site = time.time() - t0
        server = serve_site(site, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = "http://127.0.0.1:%d" % server.server_address[1]
            fetch = lambda rel: urllib.request.urlopen(base + rel,
                                                       timeout=30).read()
            index = fetch("/index.html").decode()
            summary = json.loads(fetch("/summary.json"))
            details = fetch("/datasets/%s/details.html"
                            % summary[0]["ds_full_name"]).decode()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        if sorted(r["ds_full_name"] for r in summary) != sorted(runs):
            raise AssertionError("summary.json holds %s, not %s"
                                 % ([r["ds_full_name"] for r in summary],
                                    sorted(runs)))
        for row in summary:
            res = runs[row["ds_full_name"]]
            n = sum(len(v) for v in res["classifications"].values())
            want = {k: round(float(res["metrics"]["test"][k][0]), 4)
                    for k in ("risk", "sensitivity", "specificity")}
            want.update(n_rules=float(res["model"]["n_rules"]),
                        ds_n_examples=float(n))
            got = {k: row.get(k) for k in want}
            if got != want:
                raise AssertionError("summary.json's %s row %s != its "
                                     "results.json's %s"
                                     % (row["ds_full_name"], got, want))
            if row["ds_full_name"] not in index:
                raise AssertionError("index.html does not link %s"
                                     % row["ds_full_name"])
        if "<h2>Model" not in details:
            raise AssertionError("details.html holds no model section")
        log("    results-site: `results site` over %s in %.3f s; served on "
            "port %d: index.html, %s/details.html and summary.json fetched, "
            "summary.json == the runs' results.json; server shut down"
            % (sorted(report_dirs), t_site, server.server_address[1],
               summary[0]["ds_full_name"]))


def ingest_path(codes_list, labels, device):
    """Phase 5's ``ingest-device`` path: the batched build from codes
    (bench.py:181), then ``train_scm``. Returns (the DeviceDataset, the
    result, build seconds, fit seconds), each wall ending in a
    synchronize."""
    import torch

    from grm_tpu_torch.parallel.device_build import build_matrix_device_batched
    from grm_tpu_torch.pipeline import DeviceDataset, train_scm

    ids = ["g%05d" % g for g in range(len(codes_list))]
    t0 = time.time()
    dm = build_matrix_device_batched(
        codes_list, INGEST_K, genome_ids=ids, k_budget=INGEST_BUDGET,
        genome_batch=INGEST_BATCH, batch_budget=INGEST_BUDGET,
        filter_singleton=True, device=device)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    ds = DeviceDataset(dm, dict(zip(ids, labels.tolist())))
    t0 = time.time()
    res = train_scm(ds, model_type="conjunction", p=1.0, max_rules=MAX_RULES)
    torch.cuda.synchronize()
    return ds, res, t_build, time.time() - t0


def run_ingest(device, seed, paths):
    """Phase 5, the ``ingest-device`` path at the published median: its
    launches go into ``paths``. Fails unless every kernel of the path ran
    and a rule is a planted marker's k-mer. Returns (the codes, the labels,
    the markers' k-mers, the union on the host, the (W, U) matrix on the
    card): ``create-contigs`` runs on them, and phase 6 times the kernels
    on the codes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from grm_tpu_torch.ops import _build

    t0 = time.time()
    codes_list, labels, marker_kmers = ingest_genomes(
        INGEST_GENOMES, INGEST_LENGTH, INGEST_SNPS, INGEST_POOL, seed)
    log("    ingest data: %d genomes x %d bp (%d SNPs each from a pool of %d,"
        " 3 planted markers) made in %.1f s (set-up)"
        % (INGEST_GENOMES, INGEST_LENGTH, INGEST_SNPS, INGEST_POOL,
           time.time() - t0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    ds, res, t_build, t_fit = ingest_path(codes_list, labels, device)
    paths["ingest-device"] = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    mbp = INGEST_GENOMES * INGEST_LENGTH / 1e6
    rules = [str(r) for r in res.rules]
    log("    ingest-device: build %.3f s (%.1f Mbp/s, %.1f genomes/s), "
        "union %d k-mers after the singleton filter (k_budget %d), fit "
        "%.3f s; rules %s, train risk %.4f, test risk %.4f; peak device "
        "memory %.2f GB; launches %s"
        % (t_build, mbp / t_build, INGEST_GENOMES / t_build, ds.kmer_count,
           INGEST_BUDGET, t_fit, rules, res.train_metrics["risk"][0],
           res.test_metrics["risk"][0], peak / 1e9, paths["ingest-device"]))
    if not INGEST_UNION[0] <= ds.kmer_count <= INGEST_UNION[1]:
        raise AssertionError("ingest-device: union of %d k-mers outside %s"
                             % (ds.kmer_count, INGEST_UNION))
    hits = [r.kmer_sequence for r in res.rules
            if r.type == "presence" and r.kmer_sequence in marker_kmers]
    if not hits:
        raise AssertionError("ingest-device learned no planted marker: %s"
                             % rules)
    missing = [k for k in PATH_KERNELS["ingest-device"]
               if paths["ingest-device"][k] == 0]
    if missing:
        raise AssertionError("path 'ingest-device' launched no %s" % missing)
    want = (ds.kmer_count, rules)
    union = ds.dm.union_kmers_host()
    matrix = ds.dm.matrix[:, :ds.kmer_count].clone()
    del ds, res
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ds, res, _, _ = ingest_path(codes_list, labels, device)
    if (ds.kmer_count, [str(r) for r in res.rules]) != want:
        raise AssertionError("the profiled ingest-device run learned "
                             "another model")
    del ds, res
    rows = [(_device_us(e), e.key, e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
    ingest = (codes_list, labels, marker_kmers, union, matrix)
    if not rows:
        log("    device time by kernel: not measured (no device events)")
        return ingest
    total = sum(r[0] for r in rows) / 1e3
    sort_ms = sum(r[0] for r in rows if "sort" in r[1].lower()) / 1e3
    log("    device time over ingest-device: %.2f ms = %.1f%% busy of the "
        "%.3f s unprofiled wall; the sorts %.2f ms; by kernel:"
        % (total, 100.0 * total / ((t_build + t_fit) * 1e3),
           t_build + t_fit, sort_ms))
    # The ten longest lines, then every line of the path's hand kernels.
    hand = [KERNEL_FUNCTIONS[k] for k in PATH_KERNELS["ingest-device"]]
    for i, (us, key, count) in enumerate(sorted(rows, reverse=True)):
        if i < 10 or any(_is_function(key, f) for f in hand):
            log("      %9.3f ms  %5d x  %s" % (us / 1e3, count, key[:90]))
    return ingest


def time_load(m64, n_rows, device, paths, card):
    """Phase 6, the artifact's matrix split at the main paths' shape:
    deinterleave_u64 over the whole (W64, K) matrix in one launch, its raw
    words already on the card, against the bytes bound (the raw words read
    once, the word rows written once), its plain version, and the same
    function in PyTorch (``library_ms``: ``torch.stack`` of the two strided
    half views of the uint64 rows whose halves are both kept into the
    output, plus, where n_words is odd, the copy of the last high half, so
    that it moves the kernel's bytes). Then the load itself,
    BitMatrix.from_u64 through the pinned staging ring, against the
    parent's route (the host split ``u64_matrix_to_u32``, then a pageable
    upload), in turns old, new, new on one host thread, the same again in
    reverse, each with the artifact's bytes a second; the host's share of
    each route (the old route's split, the new route's copies into pinned
    staging alone, on FILL_THREADS threads and on one) and the pinned
    upload's rate of one chunk."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from grm_tpu_torch.ops import popcount as pc

    w64, k = m64.shape
    n_words = -(-n_rows // 32)
    raw = torch.from_numpy(m64.view(np.int32).reshape(w64, 2 * k)).to(device)
    out = torch.empty((n_words, k), dtype=torch.int32, device=device)
    kernel = lambda: pc.deinterleave_u64(raw, out, 0)
    plain = lambda: pc.deinterleave_u64_plain(raw, n_words)
    err = exact_err(kernel(), plain())
    full = torch.empty((n_words, k), dtype=torch.int32, device=device)
    halves = raw.view(w64, k, 2)
    both = n_words // 2  # uint64 rows whose two halves are kept
    stack = lambda: torch.stack((halves[:both, :, 1], halves[:both, :, 0]),
                                dim=1, out=full[:2 * both].view(both, 2, k))
    rest = lambda: full[n_words - 1].copy_(halves[w64 - 1, :, 1])
    stack()
    if n_words % 2:
        rest()
    err = max(err, exact_err(full, out))
    if err != 0.0:
        raise AssertionError("deinterleave_u64 differs from its plain "
                             "version (or torch.stack) at %dx%d (%r)"
                             % (w64, k, err))
    ms, timed_by = device_ms(kernel, 20, KERNEL_FUNCTIONS["deinterleave_u64"])
    event_ms = time_cuda(kernel, 20)
    plain_ms = time_cuda(plain, 1)
    library_parts = {"stack": time_cuda(stack, 20),
                     "last high half": time_cuda(rest, 20) if n_words % 2
                     else 0.0}
    library_ms = sum(library_parts.values())
    del raw, out, full, halves
    nbytes = m64.nbytes + 4 * n_words * k

    def new(threads):
        saved, pc.FILL_THREADS = pc.FILL_THREADS, threads
        try:
            t0 = time.time()
            pc.BitMatrix.from_u64(m64, n_rows, device)
            torch.cuda.synchronize()
            return time.time() - t0
        finally:
            pc.FILL_THREADS = saved

    def old():
        t0 = time.time()
        m32 = pc.u64_matrix_to_u32(m64)[:n_words]
        t_split = time.time() - t0
        pc.BitMatrix(m32, n_rows, device=device)
        torch.cuda.synchronize()
        return time.time() - t0, t_split

    # The parent's route, the load's (FILL_THREADS host threads) and the
    # load's on one host thread, in turns.
    threads = pc.FILL_THREADS
    old_1, new_1, one_1 = old(), new(threads), new(1)
    one_2, new_2, old_2 = new(1), new(threads), old()
    # The new route's host work alone: every chunk into pinned staging.
    ch = pc.load_chunk_cols(w64)
    stage = torch.empty(2 * w64 * ch, dtype=torch.int32, pin_memory=True)
    host_fill_s = {}
    for n in (threads, 1):
        pool = ThreadPoolExecutor(n) if n > 1 else None
        t0 = time.time()
        for lo in range(0, k, ch):
            c = min(ch, k - lo)
            pc._fill(stage[:2 * w64 * c].numpy().view(np.uint64).reshape(
                w64, c), m64[:, lo:lo + c], pool, n)
        host_fill_s["%d threads" % n] = time.time() - t0
        if pool is not None:
            pool.shutdown()
    chunk_dev = torch.empty_like(stage, device=device)
    pinned_ms = time_cuda(lambda: chunk_dev.copy_(stage, non_blocking=True),
                          10)
    del stage, chunk_dev
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": library_ms,
           "library_call": "torch.stack((hi, lo), dim=1, out=...) of the "
                           "strided half views, then the last high half's "
                           "copy_ where n_words is odd",
           "library_parts_ms": library_parts,
           "load_s": {"old": [old_1[0], old_2[0]], "new": [new_1, new_2],
                      "new, 1 thread": [one_1, one_2]},
           "load_gb_per_s": {"old": [m64.nbytes / old_1[0] / 1e9,
                                     m64.nbytes / old_2[0] / 1e9],
                             "new": [m64.nbytes / new_1 / 1e9,
                                     m64.nbytes / new_2 / 1e9]},
           "fill_threads": threads,
           "old_host_split_s": [old_1[1], old_2[1]],
           "new_host_fill_s": host_fill_s,
           "pinned_upload_gb_per_s": 8 * w64 * ch / pinned_ms / 1e6,
           "load_chunks": -(-k // ch)}
    log(json.dumps({"kernel": "deinterleave_u64", "shape": "W64=%d K=%d -> "
                    "%dx%d" % (w64, k, n_words, k), **row,
                    "timed_by": timed_by, "event_ms": event_ms,
                    "launches": {e: paths[e]["deinterleave_u64"]
                                 for e in paths}, "card": card}))
    return {"deinterleave_u64": row}


def time_ingest_kernels(codes_list, device, paths, card):
    """Phase 6, ingest: each of the four kernels at phase 5's shapes (one
    32-genome batch for kmer_canon and build_columns; every batch's union
    for merge_columns; the merged matrix for compact_columns), equal to its
    plain version on the same inputs, and torch.sort at one batch. ``ms``
    is one call of the wrapper by CUDA events (its output fills and scratch
    zeroing included), ``kernel_ms`` the hand kernel's own device time from
    torch.profiler; ``bound_ms`` the bytes that the call's inputs need read
    once and its outputs written once, at the memory rate: merge_columns'
    valid rows (``bound_ms_all_rows`` counts every row read) and
    compact_columns' live columns (``bound_ms_whole``: the whole matrix).
    Returns the rows."""
    import torch

    from grm_tpu_torch.ops import device_build as db
    from grm_tpu_torch.ops import kmer as km
    from grm_tpu_torch.parallel import device_build as pdb

    rows = {}

    def row(name, kernel, plain, nbytes, reps, shape, keep=(), **more):
        err = exact_err(kernel(), plain())
        if err != 0.0:
            raise AssertionError("%s differs from its plain version at the "
                                 "main path's shapes (%r)" % (name, err))
        ms = time_cuda(kernel, reps)
        kernel_ms, timed_by = device_ms(kernel, reps, KERNEL_FUNCTIONS[name])
        rows[name] = {"max_abs_err": err, "ms": ms,
                      "plain_ms": time_cuda(plain, 1),
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bound_by": "bytes", "library_ms": None, **dict(keep)}
        log(json.dumps({"kernel": name, "shape": shape, **rows[name],
                        "kernel_ms": kernel_ms, "timed_by": timed_by,
                        "launches": {e: paths[e][name] for e in paths},
                        **more, "card": card}))

    batch = codes_list[:INGEST_BATCH]
    n_cols = -(-max(len(c) for c in batch) // 4096) * 4096
    codes = torch.full((len(batch), n_cols), 4, dtype=torch.int8)
    for i, c in enumerate(batch):
        codes[i, :len(c)] = torch.from_numpy(c)
    codes = codes.to(device)
    n = codes.numel()
    nw = km.n_words_for_k(INGEST_K)
    shape = "G=%d L=%d k=%d" % (len(batch), n_cols, INGEST_K)
    row("kmer_canon",
        lambda: km.kmer_canon(codes, INGEST_K, key=True),
        lambda: km.kmer_canon_plain(codes, INGEST_K, key=True),
        n * (1 + 8), 20, shape + " (the sort key)")
    keys, _ = km.window_keys(codes, INGEST_K)
    del codes
    sort_ms = time_cuda(lambda: torch.sort(keys[0], stable=True), 5)
    log(json.dumps({"library": "torch.sort", "shape": "%d int64 keys, "
                    "stable, with indices (one batch)" % n, "ms": sort_ms,
                    "library_ms": sort_ms,
                    "bound_ms": 24 * n / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes", "card": card}))
    keys, perm, _ = km.sort_keys(keys)
    bucket = INGEST_BUDGET
    row("build_columns",
        lambda: db.build_columns(keys, perm, None, nw, n_cols, bucket),
        lambda: db.build_columns_plain(keys, perm, None, nw, n_cols, bucket),
        16 * n + 4 * bucket * (-(-len(batch) // 32) + nw) + 4, 5,
        "%d sorted rows, k_budget %d" % (n, bucket),
        ptxas=kernel_ptxas("device_build", KERNEL_FUNCTIONS["build_columns"]))
    del keys, perm

    batches = []
    for lo in range(0, len(codes_list), INGEST_BATCH):
        batches.append(pdb._build_codes(codes_list[lo:lo + INGEST_BATCH],
                                        INGEST_K, bucket, device) + (lo,))
    words = torch.cat([b[1] for b in batches])
    valids = torch.cat([torch.arange(bucket, device=device) < b[2]
                        for b in batches])
    mkeys, mperm, _ = km.sort_keys(km.pair_keys(words.T, valids))
    del words, valids
    w_total = -(-len(codes_list) // 32)
    merged = [(b[0], b[3] // 32) for b in batches]
    r, out_bytes = mkeys.shape[1], 4 * INGEST_BUDGET * (nw + w_total) + 4
    # The bound counts the valid rows only (key, perm and the batch's
    # words of each); the bound of every row read beside it.
    valid_rows = sum(int(b[2]) for b in batches)
    word_bytes = sum(4 * b[0].shape[0] * int(b[2]) for b in batches)
    row("merge_columns",
        lambda: db.merge_columns(mkeys, mperm, None, merged, nw,
                                 INGEST_BUDGET, w_total),
        lambda: db.merge_columns_plain(mkeys, mperm, None, merged, nw,
                                       INGEST_BUDGET, w_total),
        16 * valid_rows + word_bytes + out_bytes, 5,
        "%d batches x %d union rows, %d valid, k_budget %d"
        % (len(batches), bucket, valid_rows, INGEST_BUDGET),
        keep={"bound_ms_all_rows":
              (20 * r + out_bytes) / HBM_BYTES_PER_S * 1e3},
        ptxas=kernel_ptxas("device_build", "merge_columns_tile_kernel"))
    final, union, n_merged = db.merge_columns(mkeys, mperm, None, merged, nw,
                                              INGEST_BUDGET, w_total)
    del batches, merged, mkeys, mperm
    live, width = int(n_merged.item()), w_total + nw
    row("compact_columns", lambda: db.compact_columns(final, union, n_merged),
        lambda: db.compact_columns_plain(final, union, n_merged),
        4 * width * live + 4 * INGEST_BUDGET * width + 8, 20,
        "W=%d K=%d, %d live columns" % (w_total, INGEST_BUDGET, live),
        keep={"bound_ms_whole":
              (2 * 4 * INGEST_BUDGET * width + 8) / HBM_BYTES_PER_S * 1e3},
        ptxas=kernel_ptxas("device_build", "compact_columns_tile_kernel"))
    return rows


def profile_learn(what, run_once, wall, want, trace_dir=None):
    """One more run of the path ``what`` under torch.profiler:
    ``run_once()`` returns its fingerprint, which must be ``want``, the
    unprofiled run's. Prints the device time by kernel name and the
    device's busy share of ``wall``, the unprofiled run's wall seconds;
    "not measured" if the profiler holds no device data. With
    ``trace_dir`` the run is traced by the port's ``profiling.torch_trace``
    instead, and its trace file must be there. Returns the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from grm_tpu_torch.profiling import torch_trace

    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
          if trace_dir is None else torch_trace(trace_dir)) as prof:
        got = run_once()
        torch.cuda.synchronize()
    if got != want:
        raise AssertionError("the profiled run of %s learned another model "
                             "than the unprofiled one" % what)
    if trace_dir is not None:
        with open(prof.trace_path) as f:
            head = f.read(4096)
        if '"traceEvents"' not in head and '"schemaVersion"' not in head:
            raise AssertionError("torch_trace wrote no Chrome trace: %r"
                                 % head[:200])
        log("    torch_trace of %s: %s, %d bytes" % (
            what, os.path.basename(prof.trace_path),
            os.path.getsize(prof.trace_path)))
    try:  # only the reading of the profile may fail without failing the run
        rows = [(_device_us(e), e.key, e.count) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
    except Exception:
        traceback.print_exc()
        rows = []
    if not rows:
        log("    device time by kernel: not measured (no device events)")
        return prof
    total_ms = sum(r[0] for r in rows) / 1e3
    log("    device time over %s: %.2f ms = %.1f%% busy of the %.3f s "
        "unprofiled wall; by kernel:"
        % (what, total_ms, 100.0 * total_ms / (wall * 1e3), wall))
    for us, key, count in sorted(rows, reverse=True)[:8]:
        log("      %9.3f ms  %5d x  %s" % (us / 1e3, count, key[:90]))
    return prof


# -- meshes and the multi-process build ---------------------------------------

def card_mesh(device, n, rows=1):
    """A (rows, n / rows) mesh that names ``device`` n times (cuda:0 on the
    one-card machine): the shards share the card."""
    import torch

    from grm_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(device.type, 0) if device.type == "cuda" else device
    return make_mesh(n, row_devices=rows, devices=[dev] * n)


def write_blacklist(mem, share, seed, path):
    """A k-mer blacklist file of ``share`` of the artifact's k-mers, chosen
    from ``seed``. Returns the path."""
    seqs = mem["kmer_sequences"].data
    rng = np.random.RandomState(seed)
    pick = rng.choice(len(seqs), max(1, int(len(seqs) * share)),
                      replace=False)
    with open(path, "w") as f:
        f.write("".join(">b%d\n%s\n" % (i, _s(seqs[c]))
                        for i, c in enumerate(np.sort(pick))))
    return path


def _sharded_case(what, run, want, device):
    """``run()`` with the launch counts from 0; fails unless its
    fingerprint is ``want``. Returns a summary line."""
    import torch

    from grm_tpu_torch.ops import _build

    _build.reset_launches()
    t0 = time.time()
    got = run()
    torch.cuda.synchronize() if device.type == "cuda" else None
    wall = time.time() - t0
    if got != want:
        raise AssertionError("%s: sharded != unsharded:\n%s\n%s"
                             % (what, got, want))
    launched = {k: v for k, v in _build.launches.items() if v}
    modes = sorted({kname for kname, _, _ in _build.exact_frontiers})
    return "%s == unsharded (%.1f s; launches %s%s)" % (
        what, wall, launched, "; exact %s" % modes if modes else "")


def check_sharded_small(device, seed, small, tri):
    """Phase 4, meshes of a repeated card: every sharded engine must give
    its unsharded run's fingerprint (exact engines the whole fingerprint,
    argmax engines too: the combines keep the lowest column on ties).
    ``learn_SCM`` with both device engines on a (1, 4) mesh at 342 x
    200,000 and on a (1, 8) mesh at 342 x 200,003 (8 shards of 25,001, the
    last with 8 padding columns); the scan engine on a (2, 2) mesh; a 1%
    k-mer blacklist through the grid and CART combines; ``learn_CART``
    with both engines on (1, 4) at two classes and on the three-class
    artifact, whose gather regime must run sharded. Returns summary
    lines."""
    m4, m8, m22 = (card_mesh(device, 4), card_mesh(device, 8),
                   card_mesh(device, 4, rows=2))
    out = []
    for engine in ("device", "device-argmax"):
        want = fingerprint(learn(small, engine, device))
        out.append(_sharded_case(
            "learn_SCM(%s) on (1, 4)" % engine,
            lambda: fingerprint(learn(small, engine, device, m4)), want,
            device))
        if engine == "device-argmax":
            out.append(_sharded_case(
                "learn_SCM(device-argmax) on (2, 2), the scan engine",
                lambda: fingerprint(learn(small, engine, device, m22)),
                want, device))
    ragged = build_artifact(MEDIAN_GENOMES, SHARDED_KMERS, seed, device)
    for engine in ("device", "device-argmax"):
        want = fingerprint(learn(ragged, engine, device))
        out.append(_sharded_case(
            "learn_SCM(%s) on (1, 8), K = %d" % (engine, SHARDED_KMERS),
            lambda: fingerprint(learn(ragged, engine, device, m8)), want,
            device))
    del ragged
    for engine in ("device", "device-argmax"):
        want = tree_fingerprint(learn_tree(small, engine, device,
                                           list(CART_CRITERIA), SMALL_DEPTH))
        out.append(_sharded_case(
            "learn_CART(%s) on (1, 4)" % engine,
            lambda: tree_fingerprint(learn_tree(
                small, engine, device, list(CART_CRITERIA), SMALL_DEPTH,
                m4)), want, device))
        want = tree_fingerprint(learn_tree(tri, engine, device,
                                           list(CART_CRITERIA), SMALL_DEPTH))
        out.append(_sharded_case(
            "learn_CART(%s) on (1, 4), 3 classes" % engine,
            lambda: tree_fingerprint(learn_tree(
                tri, engine, device, list(CART_CRITERIA), SMALL_DEPTH, m4)),
            want, device))
        if (engine == "device" and device.type == "cuda"
                and "cart_exact_select:gather" not in out[-1]):
            raise AssertionError("the sharded three-class run took no "
                                 "gather regime: %s" % out[-1])
    with tempfile.TemporaryDirectory() as tmp:
        bl = write_blacklist(small, 0.01, seed, os.path.join(tmp, "bl.fa"))
        want = fingerprint(learn(small, "device-argmax", device,
                                 blacklist=bl))
        out.append(_sharded_case(
            "learn_SCM(device-argmax) on (1, 4), a 1% k-mer blacklist",
            lambda: fingerprint(learn(small, "device-argmax", device, m4,
                                      blacklist=bl)), want, device))
        want = tree_fingerprint(learn_tree(
            small, "device-argmax", device, list(CART_CRITERIA), SMALL_DEPTH,
            blacklist=bl))
        out.append(_sharded_case(
            "learn_CART(device-argmax) on (1, 4), a 1% k-mer blacklist",
            lambda: tree_fingerprint(learn_tree(
                small, "device-argmax", device, list(CART_CRITERIA),
                SMALL_DEPTH, m4, blacklist=bl)), want, device))
    return out


class RssSampler:
    """The process's resident set sampled every 20 ms on a thread (from
    /proc/self/statm: ru_maxrss keeps the parent's peak across the exec);
    :meth:`stop` returns the largest sample in GB."""

    def __init__(self):
        import threading

        self.peak = 0
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _sample(self):
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        self.peak = max(self.peak, pages * os.sysconf("SC_PAGE_SIZE"))

    def _run(self):
        while not self._done.wait(0.02):
            self._sample()

    def stop(self):
        self._done.set()
        self._thread.join()
        self._sample()
        return self.peak / 1e9


def build_worker(spec_path):
    """One process of the multi-process build (``--build-worker``): joins
    the gloo group through the file store ``spec["store"]``, runs
    ``build_presence_matrix_distributed`` on the card once a filter
    setting, saves each union and matrix, and prints one JSON line: each
    build's stage walls, the launches, the peak RSS. A failure exits 3
    after ``GRM_FAULT:`` and its message on standard error."""
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from grm_tpu_torch.ops import _build
    from grm_tpu_torch.parallel.build import build_presence_matrix_distributed
    from grm_tpu_torch.parallel.distributed import initialize

    with open(spec_path) as f:
        spec = json.load(f)
    rank = spec["rank"]
    rss = RssSampler()
    initialize(spec["store"], 2, rank, timeout=spec["timeout"])
    out = {"rank": rank}
    try:
        for fs in spec["filters"]:
            timings = {}
            t0 = time.time()
            km = build_presence_matrix_distributed(
                [tuple(x) for x in spec["specs"]], spec["k"],
                filter_singleton=fs, device=spec["device"], timings=timings)
            timings["wall"] = time.time() - t0
            np.save("%s%d_%d_kmers.npy" % (spec["out"], rank, fs), km.kmers)
            np.save("%s%d_%d_matrix.npy" % (spec["out"], rank, fs),
                    km.matrix)
            out["filter=%d" % fs] = timings
    except Exception as e:  # a faulted worker must not wait on its peer
        sys.stderr.write("GRM_FAULT: %s\n" % e)
        sys.stderr.flush()
        os._exit(3)
    out["launches"] = {k: v for k, v in _build.launches.items() if v}
    out["peak_rss_gb"] = rss.stop()
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def run_build_workers(tmp, specs_by_rank, k, filters, device, timeout):
    """Two ``--build-worker`` processes over a file store in ``tmp``, each
    with its own genome list. Returns [(returncode, JSON out or None,
    stderr)] per rank; kills both past ``timeout`` seconds."""
    store = tempfile.mkdtemp(dir=tmp, prefix="store_")
    procs = []
    for rank in range(2):
        spec = os.path.join(store, "spec%d.json" % rank)
        with open(spec, "w") as f:
            json.dump({"rank": rank, "store": "file://" + os.path.join(
                store, "gloo"), "timeout": timeout,
                "specs": specs_by_rank[rank], "k": k, "filters": filters,
                "device": str(device), "out": os.path.join(store, "km_")},
                f)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--build-worker",
             spec], stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    results = []
    deadline = time.time() + timeout + 120
    try:
        for p in procs:
            so, se = p.communicate(timeout=max(1.0, deadline - time.time()))
            lines = [l for l in so.decode().splitlines() if l.startswith("{")]
            results.append((p.returncode, json.loads(lines[-1]) if lines
                            else None, se.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results.append(os.path.join(store, "km_"))
    return results


def _worker_matrix(prefix, rank, fs):
    return (np.load("%s%d_%d_kmers.npy" % (prefix, rank, fs)),
            np.load("%s%d_%d_matrix.npy" % (prefix, rank, fs)))


def check_distributed_small(device, seed, n_genomes=SMALL_INGEST[0],
                            length=SMALL_INGEST[1]):
    """Phase 4, the multi-process build: two processes share the card and
    exchange over gloo through a file store; each counts its round-robin
    half of ``n_genomes`` genomes of ``length`` bases at k = 31, without and
    with the singleton filter. Both ranks' union and matrix must equal
    ``build_presence_matrix`` over the same genomes, byte for byte; a genome
    list that differs between the ranks must fail fast on both. Returns a
    summary line."""
    from grm_tpu_torch.kmer.counter import count_fasta
    from grm_tpu_torch.kmer.matrix import build_presence_matrix

    scale = length / INGEST_LENGTH
    codes_list, _, _ = ingest_genomes(
        n_genomes, length, max(1, round(INGEST_SNPS * scale)),
        max(2, round(INGEST_POOL * scale)), seed)
    with tempfile.TemporaryDirectory() as tmp:
        specs = write_fasta(tmp, codes_list)
        gks = [count_fasta(p, INGEST_K, genome_id=g, device=device)
               for g, p in specs]
        t0 = time.time()
        *ranks, prefix = run_build_workers(tmp, [specs, specs], INGEST_K,
                                           [False, True], device, 300)
        wall = time.time() - t0
        for rank, (rc, out, err) in enumerate(ranks):
            if rc != 0 or out is None:
                raise AssertionError("build worker %d exited %s: %s"
                                     % (rank, rc, err[-2000:]))
        sizes = []
        for fs in (False, True):
            want = build_presence_matrix(gks, filter_singleton=fs)
            for rank in range(2):
                kmers, matrix = _worker_matrix(prefix, rank, fs)
                if not (np.array_equal(kmers, want.kmers)
                        and np.array_equal(matrix, want.matrix)
                        and matrix.dtype == want.matrix.dtype):
                    raise AssertionError("the two-process build (rank %d, "
                                         "filter_singleton=%s) != the local "
                                         "build" % (rank, fs))
            sizes.append(want.kmers.shape[0])
        bad = list(specs)
        bad[1] = ("zz_other", bad[1][1])
        t0 = time.time()
        *faulted, _ = run_build_workers(tmp, [specs, bad], INGEST_K, [False],
                                        device, 60)
        t_fault = time.time() - t0
        for rank, (rc, _, err) in enumerate(faulted):
            if rc != 3 or "input mismatch" not in err:
                raise AssertionError("rank %d of a mismatched build exited "
                                     "%s: %s" % (rank, rc, err[-2000:]))
    return ("%d x %d bp, 2 processes: union and matrix == the local build "
            "(%d k-mers, %d after the singleton filter) on both ranks in "
            "%.1f s (both builds, process start included; launches %s); a "
            "mismatched genome list failed fast on both ranks in %.1f s"
            % (n_genomes, length, sizes[0], sizes[1], wall,
               [r[1]["launches"] for r in ranks], t_fault))


def run_build_distributed(specs, ingest, paths, card):
    """Phase 5, the ``build-distributed`` path: two processes on the card
    over ``create-contigs``' FASTA files (k = 31, the singleton filter),
    each counting its round-robin half. The union and the matrix must equal
    ``create-contigs``' (which equal ``ingest-device``'s: its union and its
    matrix rows, genomes in the same order); each process's counting,
    exchange and merge walls and peak RSS are printed. The workers' launch
    counts go into ``paths``."""
    _, _, _, union, matrix = ingest
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        *ranks, prefix = run_build_workers(tmp, [specs, specs], INGEST_K,
                                           [True], "cuda", 600)
        wall = time.time() - t0
        for rank, (rc, out, err) in enumerate(ranks):
            if rc != 0 or out is None:
                raise AssertionError("build-distributed: worker %d exited "
                                     "%s: %s" % (rank, rc, err[-2000:]))
        for rank in range(2):
            kmers, m64 = _worker_matrix(prefix, rank, True)
            from grm_tpu_torch.ops.popcount import u64_matrix_to_u32

            m32 = u64_matrix_to_u32(m64)[:matrix.shape[0]].view(np.int32)
            if not (np.array_equal(kmers, union)
                    and np.array_equal(m32, matrix.cpu().numpy())):
                raise AssertionError("build-distributed: rank %d's union (%d "
                                     "k-mers) or matrix != create-contigs' "
                                     "(%d)" % (rank, len(kmers), len(union)))
    from grm_tpu_torch.ops import _build

    launches = dict.fromkeys(_build.launches, 0)
    for _, out, _ in ranks:
        for k, v in out["launches"].items():
            launches[k] += v
    paths["build-distributed"] = launches
    for rank, (_, out, _) in enumerate(ranks):
        t = out["filter=1"]
        log("    build-distributed rank %d (%s): build %.3f s = counting on "
            "the card %.3f s, local merge %.3f s, exchange %.3f s, union "
            "merge and scatter %.3f s; peak RSS %.2f GB; launches %s"
            % (rank, card, t["wall"], t["count"], t["local_merge"],
               t["exchange"], t["merge"], out["peak_rss_gb"],
               out["launches"]))
    log("    build-distributed (%s): 2 processes, %d genomes, %d k-mers "
        "after the singleton filter == create-contigs' union and matrix; "
        "wall %.1f s with both processes' start" % (card, len(specs),
                                                    len(union), wall))
    if launches.get("kmer_canon", 0) != len(specs):
        raise AssertionError("build-distributed: %s kmer_canon launches for "
                             "%d genomes" % (launches.get("kmer_canon"),
                                             len(specs)))


def save_artifact(mem, directory):
    """Write an in-memory artifact into ``directory``: each dataset an
    ``.npy`` file, the groups' layout and attrs a pickle, so that other
    processes map it (:func:`load_artifact`) instead of holding a copy."""
    import pickle

    from grm_tpu_torch.dataset.artifact import MemoryDataset

    layout = [("", "group", None, dict(mem.attrs))]

    def walk(group, prefix):
        for name, node in group.items():
            path = prefix + name
            if isinstance(node, MemoryDataset):
                fname = "%d.npy" % len(layout)
                np.save(os.path.join(directory, fname), node.data)
                layout.append((path, "dataset", fname, dict(node.attrs)))
            else:
                layout.append((path, "group", None, dict(node.attrs)))
                walk(node, path + "/")

    walk(mem, "")
    with open(os.path.join(directory, "layout.pkl"), "wb") as f:
        pickle.dump(layout, f)


def load_artifact(directory):
    """The artifact :func:`save_artifact` wrote, its datasets memory-mapped:
    a process reads only the pages it touches (of the k-mer matrix, the
    columns of its own shards)."""
    import pickle

    from grm_tpu_torch.dataset.artifact import MemoryArtifact, MemoryDataset

    with open(os.path.join(directory, "layout.pkl"), "rb") as f:
        layout = pickle.load(f)  # written by save_artifact in this program
    mem = MemoryArtifact()
    for path, kind, fname, attrs in layout:
        if not path:
            mem.attrs.update(attrs)
            continue
        *parents, name = path.split("/")
        group = mem
        for part in parents:
            group = group[part]
        if kind == "group":
            node = group.create_group(name)
        else:
            node = group[name] = MemoryDataset(np.load(
                os.path.join(directory, fname), mmap_mode="r"))
        node.attrs.update(attrs)
    return mem


def yardstick_inputs(seed):
    """grm_tpu's multi-process yardsticks' data: YARDSTICK genomes x
    k-mers at 40% density, random labels, the (model type, p, fold) CV fits
    (``tests/helpers_scm.make_cv_fits``: folds by index modulo, disjunction
    fits with their train masks swapped) and the full masks of the labels.
    Returns (packed (W, K) uint32, fits, pos mask, neg mask)."""
    from grm_tpu_torch.parallel.scm_device import build_packed_mask
    from grm_tpu_torch.utils import pack_binary_bytes_to_ints

    n, k = YARDSTICK
    rng = np.random.RandomState(seed)
    dense = (rng.rand(n, k) > 0.6).astype(np.uint8)
    y = (rng.rand(n) > 0.5).astype(np.uint8)
    packed = pack_binary_bytes_to_ints(dense, 32)
    w = packed.shape[0]
    mask = lambda rows: build_packed_mask(rows, n, w)
    idx = np.arange(n)
    fits = []
    for model_type in ("conjunction", "disjunction"):
        for p in YARDSTICK_PS:
            for fold in range(YARDSTICK_FOLDS):
                te = idx[idx % YARDSTICK_FOLDS == fold]
                tr = idx[idx % YARDSTICK_FOLDS != fold]
                pos, neg = tr[y[tr] == 1], tr[y[tr] == 0]
                if model_type == "disjunction":
                    pos, neg = neg, pos
                fits.append({"pos_mask": mask(pos), "neg_mask": mask(neg),
                             "test_pos_mask": mask(te[y[te] == 1]),
                             "test_neg_mask": mask(te[y[te] == 0]),
                             "p": p, "model_type": model_type})
    return packed, fits, mask(idx[y == 1]), mask(idx[y == 0])


def _yardstick_steps(matrix, pos, neg, k):
    """Three scm_device_steps (fewer where no negative is left): (rule,
    utility, negatives left) each."""
    from grm_tpu_torch.parallel.mesh import scm_device_step

    steps = []
    for _ in range(3):
        best, util, pos, neg, n_neg = scm_device_step(matrix, pos, neg, 1.0,
                                                      k)
        steps.append([int(best), float(util), int(n_neg)])
        if steps[-1][2] == 0:
            break
    return steps


def _job_grid(spec, mesh, device):
    """Phase 4: scm_cv_grid_sharded on the yardstick over the mesh (rank
    1's p values doubled where the spec asks for a mismatch)."""
    from grm_tpu_torch.parallel.scm_grid import scm_cv_grid_sharded

    packed, fits, _, _ = yardstick_inputs(spec["seed"])
    if spec.get("mismatch") and spec["rank"] == 1:
        fits = [dict(f, p=2 * f["p"]) for f in fits]
    rules, n_rules, risks = scm_cv_grid_sharded(packed, fits, YARDSTICK[1],
                                                YARDSTICK_RULES, mesh)
    return {"rules": rules.tolist(), "n_rules": n_rules.tolist(),
            "risks": risks.tolist()}


def _job_step(spec, mesh, device):
    """Phase 4: three scm_device_steps on the yardstick over the mesh."""
    from grm_tpu_torch.parallel.mesh import shard_bit_matrix

    packed, _, pos, neg = yardstick_inputs(spec["seed"])
    matrix, k = shard_bit_matrix(packed, mesh)
    return {"steps": _yardstick_steps(matrix, pos, neg, k)}


def _job_paths(spec, mesh, device):
    """Phase 5: the process's shards of the mapped artifact loaded once
    (the ``load`` stage, its peak device bytes against its shards plus
    three staging chunks) and once more from the touched mapping, then the
    four learn paths over the mesh, each with its fingerprint, wall,
    launches and collectives counted from 0, and run again."""
    import torch

    from grm_tpu_torch.dataset import GrmDataset
    from grm_tpu_torch.ops import _build
    from grm_tpu_torch.parallel import distributed
    from grm_tpu_torch.parallel.mesh import MeshSharding
    from grm_tpu_torch.profiling import StageTimer

    def counted():
        return ({k: v for k, v in _build.launches.items() if v},
                dict(distributed.collectives))

    mem = load_artifact(spec["artifact"])
    ds = GrmDataset(mem, device=device)
    n_words = -(-ds.genome_count // 32)
    lk = -(-ds.kmer_count // mesh.shape["cols"])
    held = sum(mesh.is_local(0, c) for c in range(mesh.shape["cols"]))
    timer = StageTimer()
    _build.reset_launches()
    distributed.reset_collectives()
    with timer.stage("load"):
        _, peak, bound = load_peak(
            lambda: ds.bit_matrix(sharding=MeshSharding(mesh)), n_words,
            held * lk)
    launches, colls = counted()
    # The same load again from the same mapping, whose pages this process
    # has touched now: what the first load paid to read the file.
    t0 = time.time()
    GrmDataset(mem, device=device).bit_matrix(sharding=MeshSharding(mesh))
    torch.cuda.synchronize()
    out = {"load": {"seconds": timer.stages["load"], "peak": peak,
                    "bound": bound, "launches": launches,
                    "collectives": colls, "again": time.time() - t0},
           "paths": {}}

    def run(path):
        t0 = time.time()
        if path.startswith("tree-"):
            fp = tree_fingerprint(learn_tree(ds, path[len("tree-"):], device,
                                             list(CART_CRITERIA), 10, mesh))
        else:
            fp = fingerprint(learn(ds, path, device, mesh))
        torch.cuda.synchronize()
        return fp, time.time() - t0

    for path in SHARDED_PATHS:
        _build.reset_launches()
        distributed.reset_collectives()
        fp, wall = run(path)
        launches, colls = counted()
        # Once more in the warm process: the first run of a path also
        # pays this process's first calls of its kernels and operators.
        again, wall_again = run(path)
        if again != fp:
            raise AssertionError("%s: the second run learned another model"
                                 % path)
        out["paths"][path] = {"wall": wall, "again": wall_again,
                              "fingerprint": fp, "launches": launches,
                              "collectives": colls}
    return out


MESH_JOBS = {"grid": _job_grid, "step": _job_step, "paths": _job_paths}


def mesh_worker(spec_path):
    """One process of a mesh that spans processes (``--mesh-worker``):
    joins the gloo group through the file store ``spec["store"]``, makes a
    mesh of ``spec["rows"]`` rows over every process's
    ``spec["local_devices"]`` names of cuda:0, runs the job
    ``spec["job"]`` on it (:data:`MESH_JOBS`) and prints one JSON line: the
    job's outputs and the seconds from the process's spawn to its joining
    the group. A failure exits 3 after ``GRM_FAULT:`` and its message on
    standard error."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from grm_tpu_torch.parallel.distributed import initialize
    from grm_tpu_torch.parallel.mesh import make_mesh

    with open(spec_path) as f:
        spec = json.load(f)
    initialize(spec["store"], spec["world"], spec["rank"],
               timeout=spec["timeout"])
    out = {"rank": spec["rank"], "joined_s": time.time() - spec["spawned"]}
    device = torch.device(spec["device"])
    try:
        mesh = make_mesh(None, row_devices=spec["rows"],
                         devices=[device] * spec["local_devices"])
        out.update(MESH_JOBS[spec["job"]](spec, mesh, device))
    except Exception as e:  # a faulted worker must not wait on its peers
        sys.stderr.write("GRM_FAULT: %s: %s\n" % (type(e).__name__, e))
        sys.stderr.flush()
        os._exit(3)
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def run_mesh_workers(tmp, world, local_devices, rows, job, device, timeout,
                     **extra):
    """``world`` ``--mesh-worker`` processes over a file store in ``tmp``,
    on a mesh of ``rows`` rows, each naming ``device`` ``local_devices``
    times, running ``job``. Returns ([(returncode, JSON out or None,
    stderr)] per rank, the wall from the first spawn to the last exit);
    kills them all past ``timeout`` + 120 seconds."""
    store = tempfile.mkdtemp(dir=tmp, prefix="mesh_")
    procs = []
    t0 = time.time()
    for rank in range(world):
        spec = os.path.join(store, "spec%d.json" % rank)
        with open(spec, "w") as f:
            json.dump(dict(extra, rank=rank, world=world, store="file://"
                           + os.path.join(store, "gloo"), timeout=timeout,
                           rows=rows, local_devices=local_devices, job=job,
                           device=str(device), spawned=time.time()), f)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-worker",
             spec], stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    results = []
    deadline = time.time() + timeout + 120
    try:
        for p in procs:
            so, se = p.communicate(timeout=max(1.0, deadline - time.time()))
            lines = [l for l in so.decode().splitlines() if l.startswith("{")]
            results.append((p.returncode, json.loads(lines[-1]) if lines
                            else None, se.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results, time.time() - t0


def _ok(results, what):
    for rank, (rc, out, err) in enumerate(results):
        if rc != 0 or out is None:
            raise AssertionError("%s: worker %d exited %s: %s"
                                 % (what, rank, rc, err[-2000:]))
    return [out for _, out, _ in results]


def check_mesh_procs_small(device, seed):
    """Phase 4, meshes that span processes on the card (gloo, every
    process naming cuda:0): grm_tpu's two yardsticks at their size
    (YARDSTICK). Two processes x 4 devices run ``scm_cv_grid_sharded``,
    which must equal the port's ``scm_cv_batch_device`` on the unsharded
    matrix (rules and rule counts exactly, risks to 1e-6); four processes
    x 2 devices run three ``scm_device_step``s on a (2, 4) mesh, whose both
    axes cross processes, which must equal one process's (2, 4) mesh; then
    a rank whose fits differ must fail every rank with the mismatch.
    Returns summary lines."""
    from grm_tpu_torch.ops.popcount import masks_to_tensor
    from grm_tpu_torch.parallel.mesh import shard_bit_matrix
    from grm_tpu_torch.parallel.scm_device import scm_cv_batch_device

    packed, fits, pos, neg = yardstick_inputs(seed)
    rules, n_rules, risks = scm_cv_batch_device(
        masks_to_tensor(packed, device), fits, YARDSTICK[1], YARDSTICK_RULES)
    matrix, k = shard_bit_matrix(packed, card_mesh(device, 8, rows=2))
    want_steps = _yardstick_steps(matrix, pos, neg, k)
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        results, wall = run_mesh_workers(tmp, 2, 4, 1, "grid", device, 120,
                                         seed=seed)
        for rank, got in enumerate(_ok(results, "the yardstick grid")):
            if not (np.array_equal(got["rules"], rules)
                    and np.array_equal(got["n_rules"], n_rules)
                    and np.allclose(got["risks"], risks, rtol=0,
                                    atol=1e-6)):
                raise AssertionError("rank %d's scm_cv_grid_sharded != "
                                     "scm_cv_batch_device:\n%s\n%s"
                                     % (rank, got, rules.tolist()))
        out.append("2 processes x 4 of %s, %dx%d: scm_cv_grid_sharded == "
                   "scm_cv_batch_device on both ranks (%d fits, rules "
                   "%s...) in %.1f s with the processes' start"
                   % ((device,) + YARDSTICK + (len(fits), rules[0].tolist(),
                                               wall)))
        results, wall = run_mesh_workers(tmp, 4, 2, 2, "step", device, 120,
                                         seed=seed)
        for rank, got in enumerate(_ok(results, "the yardstick steps")):
            if got["steps"] != want_steps:
                raise AssertionError("rank %d's scm_device_steps on (2, 4) "
                                     "%s != one process's %s"
                                     % (rank, got["steps"], want_steps))
        out.append("4 processes x 2 of %s on (2, 4), both axes across "
                   "processes: scm_device_step x %d == one process's (2, 4) "
                   "mesh on every rank (%s) in %.1f s"
                   % (device, len(want_steps), want_steps, wall))
        results, wall = run_mesh_workers(tmp, 2, 4, 1, "grid", device, 60,
                                         seed=seed, mismatch=True)
        for rank, (rc, _, err) in enumerate(results):
            if rc != 3 or "input mismatch" not in err:
                raise AssertionError("rank %d of a mismatched grid exited "
                                     "%s: %s" % (rank, rc, err[-2000:]))
        out.append("a rank with other fits: every rank failed with the "
                   "mismatch in %.1f s" % wall)
    return out


def run_mesh_procs(mem, device, fingerprints, walls, paths, smi):
    """Phase 5, the ``*-procs`` paths: the artifact written once into a
    temporary directory (set-up), then PROCS ``--mesh-worker`` processes on
    one (1, MESH_CARDS) mesh of ``device`` (cuda:0 on the card), each
    mapping the artifact, loading
    its own shards once and learning the four paths (:func:`_job_paths`).
    Every rank's fingerprints must equal the unsharded paths' of this
    call; each path must launch its kernels, and the ranks' launch sums
    must equal the ``*-sharded`` paths' counts of this call. The launches,
    summed over the ranks, go into ``paths``."""
    from grm_tpu_torch.ops import _build

    tmp = tempfile.mkdtemp(prefix="grm_procs_")
    try:
        t0 = time.time()
        save_artifact(mem, tmp)
        t_save = time.time() - t0
        results, wall = run_mesh_workers(tmp, PROCS, MESH_CARDS // PROCS, 1,
                                         "paths", device, 600, artifact=tmp)
        ranks = _ok(results, "the *-procs paths")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("    *-procs (%s): artifact written for mapping in %.2f s (set-up); "
        "%d processes x %d of %s in %.1f s from the first spawn to the last "
        "exit" % (smi, t_save, PROCS, MESH_CARDS // PROCS, device, wall))
    for r in ranks:
        load = r["load"]
        log("    rank %d (%s): process start to the group %.2f s; load %.3f "
            "s (again from the touched mapping: %.3f s), peak %d bytes on "
            "the card (its shards + 3 chunks: %d), launches %s, collectives "
            "%d (%.3f s)" % (r["rank"], smi, r["joined_s"], load["seconds"],
                             load["again"], load["peak"], load["bound"],
                             load["launches"], load["collectives"]["count"],
                             load["collectives"]["seconds"]))
    paths["load-procs"] = {k: sum(r["load"]["launches"].get(k, 0)
                                  for r in ranks) for k in _build.launches}
    if paths["load-procs"]["deinterleave_u64"] != \
            paths["device-sharded"]["deinterleave_u64"]:
        raise AssertionError("the processes' loads launched %d "
                             "deinterleave_u64, a sharded load %d"
                             % (paths["load-procs"]["deinterleave_u64"],
                                paths["device-sharded"]["deinterleave_u64"]))
    for path in SHARDED_PATHS:
        want = json.loads(json.dumps(fingerprints[path]))
        for r in ranks:
            if r["paths"][path]["fingerprint"] != want:
                raise AssertionError("%s-procs, rank %d learned another "
                                     "model than %r:\n%s\n%s"
                                     % (path, r["rank"], path,
                                        r["paths"][path]["fingerprint"],
                                        want))
        launches = {k: sum(r["paths"][path]["launches"].get(k, 0)
                           for r in ranks) for k in _build.launches}
        paths[path + "-procs"] = launches
        sharded = paths[path + "-sharded"]
        pairs = {k: "%d / %d" % (launches[k], sharded[k])
                 for k in PATH_KERNELS[path + "-procs"]}
        runs = [r["paths"][path] for r in ranks]
        log("    %s-procs (%s): fingerprint == %r's on every rank; walls a "
            "rank %s s (again: %s) against %.2f s sharded in one process; "
            "launches, ranks' sum / %s-sharded: %s; collectives a rank %s"
            % (path, smi, path, ["%.2f" % x["wall"] for x in runs],
               ["%.2f" % x["again"] for x in runs], walls[path + "-sharded"],
               path, pairs, ["%d (%.3f s)" % (x["collectives"]["count"],
                                              x["collectives"]["seconds"])
                             for x in runs]))
        missing = [k for k in PATH_KERNELS[path + "-procs"]
                   if launches[k] == 0]
        if missing:
            raise AssertionError("%s-procs launched no %s" % (path, missing))
        if any(launches[k] != sharded[k]
               for k in PATH_KERNELS[path + "-procs"]):
            raise AssertionError("%s-procs: the ranks' launches %s != %s-"
                                 "sharded's" % (path, pairs, path))


def check_cli_mesh(device, seed):
    """The CLI's mesh on the one-card machine: ``learn scm --engine device
    --n-devices 2`` exits 1 with grm_tpu's message before it loads
    anything; ``--n-devices 1`` runs unsharded (:func:`cli_unsharded`)."""
    import io

    from grm_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(["learn", "scm", "--dataset", "unused.h5", "--split",
                      "sp", "--engine", "device", "--n-devices", "2"])
        except SystemExit as e:
            code = e.code
        else:
            code = 0
    text = buf.getvalue()
    if code != 1 or "exceeds the 1 available local device(s)" not in text:
        raise AssertionError("learn scm --n-devices 2 on one card: exit %s, "
                             "%r" % (code, text))
    return "%s; %s" % (text.strip(), cli_unsharded(device, seed))


CLI_SIZE = (342, 20_000)  # the artifact of cli_unsharded


def cli_unsharded(device, seed):
    """``learn scm --engine device --n-devices 1`` through ``cli.main`` over
    an in-memory artifact (its ``memory://`` path: the machine has no
    h5py) places no matrix on a mesh and writes the model and metrics of
    the same command without the flag."""
    import io

    from grm_tpu_torch import cli
    from grm_tpu_torch.parallel.mesh import MeshSharding

    mem = build_artifact(*CLI_SIZE, seed, device)
    placed = []
    originals = {name: getattr(MeshSharding, name)
                 for name in ("place", "place_u64")}
    for name, fn in originals.items():
        setattr(MeshSharding, name, lambda self, *a, _fn=fn, _n=name:
                placed.append(_n) or _fn(self, *a))
    results = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for flag in (["--n-devices", "1"], []):
                out = os.path.join(tmp, "n%d" % len(flag))
                with contextlib.redirect_stdout(io.StringIO()):
                    cli.main(["learn", "scm", "--dataset", mem.path,
                              "--split", "sp", "--engine", "device",
                              "--p", "0.5", "1.0", "--max-rules", "5",
                              "--device", str(device), "--output-dir",
                              out] + flag)
                with open(os.path.join(out, "results.json")) as f:
                    got = json.load(f)
                results[len(flag)] = (got["model"], got["metrics"])
    finally:
        for name, fn in originals.items():
            setattr(MeshSharding, name, fn)
    if placed:
        raise AssertionError("learn scm --n-devices 1 placed a matrix on a "
                             "mesh (%s)" % placed)
    if results[2] != results[0]:
        raise AssertionError("learn scm --n-devices 1 != without the flag: "
                             "%r != %r" % (results[2], results[0]))
    return ("learn scm --n-devices 1, %dx%d in memory: unsharded, model "
            "and metrics == without the flag (%d rules)"
            % (CLI_SIZE + (len(results[0][0]["rules"]),)))


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


def kernel_ptxas(source, function):
    """[{function, registers, spills}] of the kernel functions named
    ``function`` (each instance of a template) in the last build of
    ``source``; empty if this process did not build it."""
    from grm_tpu_torch.ops import _build

    return [{"function": f, "registers": int(regs), "spills": spills}
            for f, regs, spills in ptxas_summary(
                _build.BUILD_LOG.get(source, ""))
            if f.split("<")[0] == function]


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
    t0 = time.time()
    worst = check_ingest_kernels(device)
    torch.cuda.synchronize()
    log("    ingest kernels and builders equal their plain versions (max abs "
        "err %s) in %.1f s" % (worst, time.time() - t0))
    t0 = time.time()
    worst = check_stream(device)
    torch.cuda.synchronize()
    log("    chunk source: double-buffered pinned uploads, hit superblocks and "
        "StreamingBitMatrix.presence_counts equal plain uploads and runs "
        "(max abs err %s) in %.1f s" % (worst, time.time() - t0))
    t0 = time.time()
    worst = check_deinterleave(device)
    torch.cuda.synchronize()
    log("    deinterleave_u64: the chunked split on the card equals the host "
        "split and the plain version, one launch a chunk (max abs err %s) in "
        "%.1f s" % (worst, time.time() - t0))

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
    host_out = learn_tree(small, "host", device, list(CART_CRITERIA),
                          SMALL_DEPTH)
    t_host = time.time() - t0
    tree_host = tree_fingerprint(host_out, selection=False)
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
    check_exact_tree(small, host_out, device, "%dx%d" % (MEDIAN_GENOMES,
                                                       SMALL_KMERS))
    # The same learners streamed: the matrix stays in host memory and goes
    # up in chunks of 2^16 columns (4 chunks, the last ragged).
    n_chunks = -(-SMALL_KMERS // SMALL_STREAM[1])
    with streaming(*SMALL_STREAM), ChunkWatch() as watch:
        t0 = time.time()
        fp_st = fingerprint(learn(small, "device", device))
        if fp_st != fp_host:
            raise AssertionError("streamed device engine != host engine at "
                                 "%dx%d:\n%s\n%s" % (MEDIAN_GENOMES,
                                                      SMALL_KMERS, fp_st,
                                                      fp_host))
        if max(watch.passes or [0]) != n_chunks:
            raise AssertionError("learn_SCM streamed %s chunks a pass, not %d"
                                 % (sorted(set(watch.passes)), n_chunks))
        log("    learn_SCM(engine='device') streamed at %dx%d: fingerprint == "
            "host; %.1f s; %s" % (MEDIAN_GENOMES, SMALL_KMERS,
                                  time.time() - t0, watch.summary()))
    with streaming(*SMALL_STREAM), ChunkWatch() as watch:
        check_exact_tree(small, host_out, device, "%dx%d streamed"
                         % (MEDIAN_GENOMES, SMALL_KMERS))
        if max(watch.passes or [0]) != n_chunks:
            raise AssertionError("learn_CART streamed %s chunks a pass, not "
                                 "%d" % (sorted(set(watch.passes)), n_chunks))
        log("    (streamed: %s)" % watch.summary())
    del host_out
    tri = build_artifact(TRI_GENOMES, TRI_KMERS, seed, device, n_classes=3)
    t0 = time.time()
    host_out = learn_tree(tri, "host", device, list(CART_CRITERIA),
                          SMALL_DEPTH)
    t_host = time.time() - t0
    log("    3 classes, %dx%d: host %.1f s" % (TRI_GENOMES, TRI_KMERS,
                                               t_host))
    modes = check_exact_tree(tri, host_out, device, "%dx%d, 3 classes"
                             % (TRI_GENOMES, TRI_KMERS))
    if "cart_exact_select:gather" not in modes:
        raise AssertionError("the three-class artifact took no gather "
                             "regime (%s)" % sorted(modes))
    # Streamed in chunks of 2^14 columns (4 chunks, the last ragged).
    with streaming(SMALL_STREAM[0], 1 << 14), ChunkWatch() as watch:
        modes = check_exact_tree(tri, host_out, device, "%dx%d, 3 classes, "
                                 "streamed" % (TRI_GENOMES, TRI_KMERS))
        if "cart_exact_select:gather" not in modes:
            raise AssertionError("the streamed three-class artifact took no "
                                 "gather regime (%s)" % sorted(modes))
        if max(watch.passes or [0]) != -(-TRI_KMERS // (1 << 14)):
            raise AssertionError("the three-class artifact streamed %s "
                                 "chunks a pass" % sorted(set(watch.passes)))
        log("    (streamed: %s)" % watch.summary())
    del host_out
    t0 = time.time()
    for line in check_sharded_small(device, seed, small, tri):
        log("    mesh of cuda:0: %s" % line)
    log("    meshes checked in %.1f s" % (time.time() - t0))
    del small, tri
    t0 = time.time()
    for line in check_ingest_small(device, seed):
        log("    from_contigs_device, %dx%d from FASTA: union and matrix == "
            "host oracle, train_scm == on a host-built BitMatrix; %s"
            % (SMALL_INGEST + (line,)))
    log("    ingest at reduced size checked in %.1f s" % (time.time() - t0))
    t0 = time.time()
    line = check_create_small(device, seed)
    log("    from_contigs / from_reads into memory, %dx%d: %s == cpu, array "
        "for array and attr for attr; count_fasta == cpu; %s; in %.1f s"
        % (SMALL_INGEST + (device, line, time.time() - t0)))
    log("    multi-process build: %s" % check_distributed_small(device, seed))
    t0 = time.time()
    for line in check_mesh_procs_small(device, seed):
        log("    mesh across processes: %s" % line)
    log("    meshes across processes checked in %.1f s" % (time.time() - t0))
    log("    CLI on one card: %s" % check_cli_mesh(device, seed))

    # 5. the main paths at full scale
    t0 = time.time()
    mem = build_artifact(MEDIAN_GENOMES, MEDIAN_KMERS, seed, device)
    torch.cuda.synchronize()
    log("[5] artifact %dx%d + %d-fold split built in %.1f s (set-up)"
        % (MEDIAN_GENOMES, MEDIAN_KMERS, N_FOLDS, time.time() - t0))
    from grm_tpu_torch.dataset import GrmDataset
    from grm_tpu_torch.ops.popcount import load_chunk_cols
    from grm_tpu_torch.parallel.mesh import MeshSharding
    from grm_tpu_torch.profiling import StageTimer
    from grm_tpu_torch.reports import write_cart_outputs, write_scm_outputs

    def scm_path(engine, src=mem, mesh=None):
        out = learn(src, engine, device, mesh)
        torch.cuda.synchronize()
        return out, fingerprint(out)

    def tree_path(engine, criterion, max_depth, src=mem, mesh=None):
        out = learn_tree(src, engine, device, criterion, max_depth, mesh)
        torch.cuda.synchronize()
        return out, tree_fingerprint(out)

    # The paths that load the artifact time the load on its own: the
    # ``load`` stage (ds.bit_matrix: the u64 bytes to the device matrix,
    # through the pinned staging ring and deinterleave_u64), then ``learn``
    # on the loaded dataset. One load is this many deinterleave_u64 launches.
    n_words = -(-MEDIAN_GENOMES // 32)
    chunk_cols = load_chunk_cols(-(-n_words // 2))
    load_chunks = -(-MEDIAN_KMERS // chunk_cols)
    # A sharded load splits each shard's columns on its own: chunks a shard.
    shard_k = -(-MEDIAN_KMERS // MESH_CARDS)
    sharded_chunks = sum(-(-min(shard_k, MEDIAN_KMERS - lo) // chunk_cols)
                         for lo in range(0, MEDIAN_KMERS, shard_k))
    mesh = card_mesh(device, MESH_CARDS)
    # path -> (StageTimer, load peak bytes, bound, the path's peak bytes) of
    # its first run
    loads = {}

    def loaded(path, learn_on, mesh=None):
        timer = StageTimer()
        ds = GrmDataset(mem, device=device)
        sharding = None if mesh is None else MeshSharding(mesh)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        with timer.stage("load"):
            _, peak, bound = load_peak(
                lambda: ds.bit_matrix(sharding=sharding), n_words,
                MEDIAN_KMERS)
        with timer.stage("learn"):
            out = learn_on(ds)
        path_peak = torch.cuda.max_memory_allocated() - base
        loads.setdefault(path, (timer, peak, bound, path_peak))
        return out

    reports_dir = tempfile.mkdtemp(prefix="grm_reports_")
    report_dirs = {}  # path -> the directory its report writer filled

    def write_reports(path, writer, out, config, **more):
        """What the CLI does after learning: the report files, into a
        directory of their own (phase 5's results-site step reads them)."""
        t1 = time.time()
        (best_hp, best_hp_score, train_metrics, test_metrics, model,
         rule_importances, equivalent_rules, classifications) = out
        out_dir = report_dirs[path] = os.path.join(reports_dir, path)
        os.makedirs(out_dir)
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

    watches = {}  # streamed path -> the ChunkWatch of its latest run

    def streamed(path, run_once):
        """``run_once`` with the matrix past 60% of the budget: it stays in
        host memory and streams in the default chunks."""
        with streaming(STREAM_BUDGET), ChunkWatch() as watch:
            out = run_once()
        watches[path] = watch
        return out

    runners = {
        "device": lambda: loaded(
            "device", lambda ds: scm_path("device", ds)),
        "device-argmax": lambda: loaded(
            "device-argmax", lambda ds: scm_path("device-argmax", ds)),
        "tree-device": lambda: loaded("tree-device", lambda ds: tree_path(
            "device", list(CART_CRITERIA), 10, ds)),
        "tree-device-argmax": lambda: loaded(
            "tree-device-argmax", lambda ds: tree_path(
                "device-argmax", list(CART_CRITERIA), 10, ds)),
        "tree-host": lambda: loaded("tree-host", lambda ds: tree_path(
            "host", ["gini"], 3, ds)),
        "device-streamed": lambda: streamed(
            "device-streamed", lambda: scm_path("device")),
        "tree-device-streamed": lambda: streamed(
            "tree-device-streamed", lambda: tree_path(
                "device", list(CART_CRITERIA), 10)),
        # The resident paths on a (1, MESH_CARDS) mesh of cuda:0, each
        # loading its own sharded matrix.
        "device-sharded": lambda: loaded(
            "device-sharded", lambda ds: scm_path("device", ds, mesh), mesh),
        "device-argmax-sharded": lambda: loaded(
            "device-argmax-sharded",
            lambda ds: scm_path("device-argmax", ds, mesh), mesh),
        "tree-device-sharded": lambda: loaded(
            "tree-device-sharded", lambda ds: tree_path(
                "device", list(CART_CRITERIA), 10, ds, mesh), mesh),
        "tree-device-argmax-sharded": lambda: loaded(
            "tree-device-argmax-sharded", lambda ds: tree_path(
                "device-argmax", list(CART_CRITERIA), 10, ds, mesh), mesh),
    }
    paths = {}  # path -> launches, counted from 0 over that path alone
    fingerprints = {}
    walls = {}
    frontiers = []  # (nodes, criterion) of every cart_sweep launch
    exact_sizes = []  # (kernel, nodes, classes) of tree-device's launches
    for path in runners:  # the learn paths; ingest-device runs after them
        _build.reset_launches()
        t0 = time.time()
        out, fp = runners[path]()
        wall = walls[path] = time.time() - t0
        written = None
        if path == "device":  # learn scm's default path writes its reports
            written = write_reports(
                path, write_scm_outputs, out,
                {"engine": path, "hp_choice": "cv"})
        elif path in ("tree-device", "tree-device-argmax"):
            written = write_reports(
                path, write_cart_outputs, out,
                {"engine": path[len("tree-"):], "hp_choice": "cv",
                 "criterion": list(CART_CRITERIA), "max_depth": [10]},
                classification_type="binary")
        paths[path] = dict(_build.launches)
        sizes = list(_build.cart_frontiers)  # (nodes, criterion) per launch
        if path == "tree-device":
            exact_sizes = list(_build.exact_frontiers)
        fingerprints[path] = fp
        if path.endswith("-streamed"):
            resident = path[:-len("-streamed")]
            if fp != fingerprints[resident]:
                raise AssertionError("path %r learned another model than %r:"
                                     "\n%s\n%s" % (path, resident, fp,
                                                    fingerprints[resident]))
            n_chunks = -(-MEDIAN_KMERS // (1 << 21))
            if max(watches[path].passes or [0]) != n_chunks:
                raise AssertionError("path %r streamed %s chunks a pass, not "
                                     "%d" % (path, sorted(set(
                                         watches[path].passes)), n_chunks))
            log("    %s: fingerprint == %r's; wall %.2f s against %.2f s "
                "resident; %s" % (path, resident, wall, walls[resident],
                                  watches[path].summary()))
        if path.endswith("-sharded"):
            base = path[:-len("-sharded")]
            if fp != fingerprints[base]:
                raise AssertionError("path %r learned another model than %r:"
                                     "\n%s\n%s" % (path, base, fp,
                                                    fingerprints[base]))
            ratio = {k: "%d / %d" % (n, paths[base][k])
                     for k, n in paths[path].items()
                     if k in PATH_KERNELS[base] and k != "deinterleave_u64"}
            log("    %s (%s): fingerprint == %r's on %d shards of cuda:0; "
                "wall %.2f s against %.2f s unsharded; launches sharded / "
                "unsharded %s" % (path, smi, base, MESH_CARDS, wall,
                                  walls[base], ratio))
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
            frontiers.extend(sizes)
            log("    frontier size per cart_sweep launch (%d launches): %s"
                % (len(sizes), [n for n, _ in sizes]))
        if path == "tree-device":
            log("    frontier size per exact launch: %s"
                % [(kname, n) for kname, n, _ in exact_sizes])
        if written:
            log("    reports: %s" % written)
        if path in loads:
            timer, peak, bound, path_peak = loads[path]
            log("    stages of %s (%s): %s; the load peaked at %d bytes on "
                "the card (matrix + 3 chunks: %d), the path at %d; %d "
                "deinterleave_u64 launches" % (path, smi, ", ".join(
                    "%s %.3f s" % kv for kv in timer.stages.items()), peak,
                    bound, path_peak, paths[path]["deinterleave_u64"]))
            chunks = (sharded_chunks if path.endswith("-sharded")
                      else load_chunks)
            if paths[path]["deinterleave_u64"] != chunks:
                raise AssertionError(
                    "path %r: %d deinterleave_u64 launches, not one load's %d"
                    % (path, paths[path]["deinterleave_u64"], chunks))
        missing = [k for k in PATH_KERNELS[path] if paths[path][k] == 0]
        if missing:
            raise AssertionError("path %r launched no %s" % (path, missing))
    # The resident paths once more, on a mesh that spans processes.
    run_mesh_procs(mem, torch.device("cuda", 0), fingerprints, walls, paths,
                   smi)
    if not frontiers:
        raise AssertionError("the CART engines launched no frontier")
    try:  # after the learn paths, on the reports of two of them
        results_site_step(seed, {p: report_dirs[p] for p in (
            "device", "tree-device")}, smi)
    finally:
        shutil.rmtree(reports_dir, ignore_errors=True)
    # What streaming adds on the host, inside each streamed path's wall:
    # the pinned chunk layout, built once a dataset.
    from grm_tpu_torch.ops.popcount import StreamingBitMatrix

    m64 = GrmDataset(mem, device=device).kmer_matrix_u64()
    t0 = time.time()
    probe = torch.empty(m64.nbytes // 4, dtype=torch.int32, pin_memory=True)
    t_pin = time.time() - t0
    del probe
    t0 = time.time()
    layout = StreamingBitMatrix.from_u64(m64, MEDIAN_GENOMES, device=device)
    log("    the streamed matrix's pinned layout: %d bytes in %d chunks, "
        "built in %.3f s (a pinned allocation of the artifact's size alone: "
        "%.3f s)" % (layout.source.host.nbytes, layout.source.n_chunks,
                     time.time() - t0, t_pin))
    del layout, m64
    trace_dir = tempfile.mkdtemp(prefix="grm_trace_")
    for engine in ("device", "device-argmax"):
        prof = profile_learn("learn_SCM(engine=%r)" % engine,
                             lambda: scm_path(engine)[1], walls[engine],
                             fingerprints[engine],
                             trace_dir if engine == "device-argmax" else None)
        if engine == "device":  # the resident upload, beside the streamed
            transfer_summary(prof, "device", 0)
    for path in ("tree-device", "tree-device-argmax"):
        prof = profile_learn("learn_CART(engine=%r)" % path[len("tree-"):],
                             lambda: runners[path]()[1], walls[path],
                             fingerprints[path])
        if path == "tree-device":
            transfer_summary(prof, path, 0)
    for path in ("device-streamed", "tree-device-streamed"):
        prof = profile_learn(path, lambda: runners[path]()[1], walls[path],
                             fingerprints[path])
        transfer_summary(prof, path, watches[path].uploaded())
    shutil.rmtree(trace_dir, ignore_errors=True)

    # The device ingest path, on its own data; then dataset creation from
    # the same genomes as FASTA files, held to its union and matrix.
    ingest = run_ingest(device, seed, paths)
    run_create(device, seed, paths, ingest, smi,
               then=lambda specs: run_build_distributed(specs, ingest, paths,
                                                        smi))
    codes_list = ingest[0]
    del ingest

    # 6. kernel times at the main paths' shapes
    log("[6] the card's measured rates, then kernel times at the main "
        "paths' shapes:")
    ds = GrmDataset(mem, device=device)
    bm = ds.bit_matrix()
    b1_per_s, sfu_per_s = probe_card(popc_per_s)
    machine_code()
    rows = time_kernels(bm, popc_per_s, b1_per_s, sfu_per_s, device, paths,
                        max(n for n, _ in frontiers), exact_sizes)
    del bm
    rows.update(time_load(ds.kmer_matrix_u64(), MEDIAN_GENOMES, device, paths,
                          smi))
    del ds, mem
    rows.update(time_ingest_kernels(codes_list, device, paths,
                                    nvidia_smi("name,power.limit")))
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        by_path = {e: paths[e][kname] for e in paths}
        entry = {"name": kname, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path}
        if kname.startswith("cart_exact"):
            # The main path's frontier under the common keys, the other
            # rows (the all-hit node; the gather mode) beside them.
            more = {key.split(":", 1)[1]: r for key, r in rows.items()
                    if key.startswith(kname + ":")}
            entry.update(rows[kname], **more)
            entry["max_abs_err"] = max([rows[kname]["max_abs_err"]] + [
                r["max_abs_err"] for r in more.values()])
        elif kname == "cart_sweep":
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
    parser.add_argument("--build-worker", metavar="SPEC",
                        help=argparse.SUPPRESS)  # one process of the build
    parser.add_argument("--mesh-worker", metavar="SPEC",
                        help=argparse.SUPPRESS)  # one process of a mesh
    args = parser.parse_args(argv)
    if args.build_worker:
        return build_worker(args.build_worker)
    if args.mesh_worker:
        return mesh_worker(args.mesh_worker)
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
