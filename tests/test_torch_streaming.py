"""Out-of-core learning in the port (``StreamingBitMatrix``, the chunk
source and the streamed exact SCM and CART engines), on the CPU through the
kernels' plain versions, against ``grm_tpu``'s streamed engines, its host
engines and the port's resident engines.

A dataset streams when its packed matrix passes 60% of the device memory
budget, which ``GRM_HBM_BUDGET_BYTES`` sets here as in ``grm_tpu``;
``GRM_STREAM_CHUNK_COLS`` sets the chunk width (256 columns, so every
matrix below spans several chunks, the last one ragged). Every comparison
is exact: the same seeded numpy inputs go through both packages, and every
fingerprint (rules, tie sets, fold risks, hyperparameters, metrics,
importances, classifications) must be equal.
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from grm_tpu.learning.experiments.cart_experiment import (
    learn_CART as jax_learn_CART,
)
from grm_tpu.learning.experiments.scm_experiment import (
    learn_SCM as jax_learn_SCM,
)
from grm_tpu.ops.popcount import StreamingBitMatrix as JaxStreaming
from grm_tpu.parallel.cart_exact import (
    cart_frontier_candidates as jax_candidates,
)

from grm_tpu_torch.cli import main as port_cli
from grm_tpu_torch.dataset import GrmDataset
from grm_tpu_torch.learning import cart as port_cart
from grm_tpu_torch.learning.experiments import learn_CART, learn_SCM
from grm_tpu_torch.ops import stream
from grm_tpu_torch.ops.popcount import (BitMatrix, StreamingBitMatrix,
                                        u64_matrix_to_u32)
from grm_tpu_torch.parallel import cart_exact as port_ce
from grm_tpu_torch.parallel.cart_exact import cart_frontier_candidates
from grm_tpu_torch.parallel.scm_exact import ExactScmEngine, _make_risk_lookup
from grm_tpu_torch.utils import build_row_mask, pack_binary_bytes_to_ints

from test_torch_cli import REPO, _assert_same_outputs
from test_torch_learn_cart import _cart_fingerprint
from test_torch_learn_scm import _artifact, _s, _scm_fingerprint

CHUNK = 256
SCM_KW = dict(split_name="sp", model_type=["conjunction", "disjunction"],
              p=[0.5, 1.0, 2.0], max_rules=4, max_equiv_rules=100,
              parameter_selection="cv", random_seed=7, bound_delta=0.05,
              bound_max_genome_size=900)
CART_KW = dict(split_name="sp", criterion=["gini"], max_depth=[3],
               min_samples_split=[2],
               class_importance=[{0: 1.0, 1: 1.0}, {0: 0.5, 1: 1.0}],
               parameter_selection="cv")


def _stream_env(monkeypatch):
    monkeypatch.setenv("GRM_HBM_BUDGET_BYTES", "1000")
    monkeypatch.setenv("GRM_STREAM_CHUNK_COLS", str(CHUNK))


def _count_chunks(monkeypatch):
    """Spy on the chunk source: the number of chunks each pass walked."""
    passes = []
    orig = stream.ChunkSource.chunks

    def spy(self):
        passes.append(0)
        for item in orig(self):
            passes[-1] += 1
            yield item

    monkeypatch.setattr(stream.ChunkSource, "chunks", spy)
    return passes


def _scm_dense(seed, n_genomes=28, n_kmers=900):
    """Noisy markers, with exact duplicates and a complement in other
    chunks than their originals (cross-chunk tie sets)."""
    rng = np.random.RandomState(seed)
    dense = (rng.rand(n_genomes, n_kmers) > 0.5).astype(np.uint8)
    labels = (rng.rand(n_genomes) > 0.5).astype(np.uint8)
    for c, noise in [(4, 3), (300, 5), (610, 7)]:
        col = labels.copy()
        col[rng.choice(n_genomes, noise, replace=False)] ^= 1
        dense[:, c] = col
    dense[:, 5] = dense[:, 4]
    dense[:, 520] = dense[:, 4]
    dense[:, 899] = dense[:, 300]
    dense[:, 700] = 1 - dense[:, 4]
    return dense, labels


def _cart_dense(seed=13, n_genomes=36, n_kmers=900):
    """tests/test_cart_exact.py's streamed case: column 430 duplicates
    column 5, in another 256-column chunk."""
    rng = np.random.RandomState(seed)
    dense = (rng.rand(n_genomes, n_kmers) > 0.5).astype(np.uint8)
    labels = (rng.rand(n_genomes) > 0.5).astype(np.uint8)
    for c, noise in [(5, 5), (213, 8), (622, 11)]:
        col = labels.copy()
        col[rng.choice(n_genomes, noise, replace=False)] ^= 1
        dense[:, c] = col
    dense[:, 430] = dense[:, 5]
    return dense, labels


# -- StreamingBitMatrix and the chunk source ----------------------------------

@pytest.mark.parametrize("block_cols", [1024, 4096])
def test_streaming_matches_resident_and_jax(block_cols):
    """After tests/test_streaming.py:10; 5000 columns leave the last block
    ragged at either width."""
    rng = np.random.RandomState(block_cols)
    n_genomes, n_kmers = 90, 5000
    dense = (rng.rand(n_genomes, n_kmers) > 0.5).astype(np.uint8)
    packed = pack_binary_bytes_to_ints(dense, 32)
    resident = BitMatrix(packed, n_genomes, device="cpu")
    streaming = StreamingBitMatrix(packed, n_genomes, block_cols=block_cols,
                                   device="cpu")
    jax = JaxStreaming(packed, n_genomes, block_cols=block_cols)
    assert streaming.source.n_chunks == -(-n_kmers // block_cols)
    assert n_kmers % streaming.block_cols

    rows_a = rng.choice(n_genomes, 30, replace=False)
    rows_b = rng.choice(n_genomes, 11, replace=False)
    got = streaming.presence_counts([rows_a, rows_b])
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, resident.presence_counts(
        [rows_a, rows_b]))
    np.testing.assert_array_equal(got, jax.presence_counts([rows_a, rows_b]))
    for rows in (rows_a, np.arange(n_genomes)):
        sums = streaming.sum_rows(rows)
        assert sums.dtype == jax.sum_rows(rows).dtype
        np.testing.assert_array_equal(sums, resident.sum_rows(rows))
        np.testing.assert_array_equal(sums, jax.sum_rows(rows))
    cols = np.array([0, 1023, 1024, 4999, 7, 7])
    np.testing.assert_array_equal(streaming.get_columns_dense(cols),
                                  jax.get_columns_dense(cols))
    np.testing.assert_array_equal(streaming.get_columns_dense(cols),
                                  dense[:, cols])
    assert streaming.get_columns_dense([]).shape == (n_genomes, 0)
    with pytest.raises(IndexError):
        streaming.get_columns_dense([n_kmers])
    assert streaming.shape == resident.shape == jax.shape


def test_streaming_from_u64_matches_jax():
    """The u64 -> u32 split straight into the chunk layout: 100 genomes (two
    u64 word rows, the last u32 row dropped as padding), 700 columns."""
    rng = np.random.RandomState(3)
    n_genomes, n_kmers = 100, 700
    dense = (rng.rand(n_genomes, n_kmers) > 0.5).astype(np.uint8)
    m64 = pack_binary_bytes_to_ints(dense, 64)
    streaming = StreamingBitMatrix.from_u64(m64, n_genomes, block_cols=CHUNK,
                                            device="cpu")
    jax = JaxStreaming.from_u64(m64, n_genomes, block_cols=CHUNK)
    assert streaming.n_words == 4
    m32 = u64_matrix_to_u32(m64)[:4]
    for ci in range(streaming.source.n_chunks):
        lo = ci * CHUNK
        width = min(CHUNK, n_kmers - lo)
        words = streaming.source.words[ci]
        np.testing.assert_array_equal(words[:, :width],
                                      m32[:, lo:lo + width])
        assert not words[:, width:].any()
    rows = rng.choice(n_genomes, 40, replace=False)
    np.testing.assert_array_equal(streaming.sum_rows(rows), jax.sum_rows(rows))
    np.testing.assert_array_equal(streaming.get_columns_dense([699, 0, 256]),
                                  dense[:, [699, 0, 256]])


@pytest.mark.parametrize("chunk_cols,want", [(None, 1 << 21), (256, 256),
                                             (100, 256), (300, 300),
                                             (10000, 8192),
                                             ((1 << 16) + 5, 1 << 16)])
def test_chunk_width_rounds_to_whole_superblocks(monkeypatch, chunk_cols,
                                                 want):
    """grm_tpu's exact CART stream rounding (cart_exact.py:510-511)."""
    monkeypatch.delenv("GRM_STREAM_CHUNK_COLS", raising=False)
    assert stream.chunk_width(chunk_cols) == want


def test_chunk_source_chunks_columns_and_superblocks():
    rng = np.random.RandomState(8)
    words = rng.randint(0, 2**32, size=(3, 1000), dtype=np.uint64).astype(
        np.uint32)

    def fill(dst, lo, hi):
        dst[...] = words[:, lo:hi]

    src = stream.ChunkSource(3, 1000, fill, chunk_cols=CHUNK, device="cpu")
    seen = []
    for lo, width, chunk in src.chunks():
        assert chunk.shape == (3, CHUNK) and chunk.dtype == torch.int32
        got = chunk.numpy().view(np.uint32)
        np.testing.assert_array_equal(got[:, :width], words[:, lo:lo + width])
        assert not got[:, width:].any()
        seen.append((lo, width))
    assert seen == [(0, 256), (256, 256), (512, 256), (768, 232)]
    cols = np.array([999, 0, 255, 256, 768])
    np.testing.assert_array_equal(src.columns(cols), words[:, cols].T)
    sb = src.superblocks([1, 3], 256, 1024).numpy().view(np.uint32)
    assert sb.shape == (3, 1024)
    np.testing.assert_array_equal(sb[:, :256], words[:, 256:512])
    np.testing.assert_array_equal(sb[:, 256:488], words[:, 768:])
    assert not sb[:, 488:].any()
    assert src.bytes_uploaded == 0  # nothing leaves the CPU


def test_dataset_returns_a_streaming_matrix_past_the_budget(tmp_path,
                                                            monkeypatch):
    """GRM_HBM_BUDGET_BYTES is honoured on the CPU too; 60% of it is the
    line, and the matrix columns come from host memory."""
    dense, labels = _scm_dense(0)
    path, _ = _artifact(tmp_path, dense, labels, "bud", 0)
    device_bytes = 2 * 900 * 4  # one u64 word row -> two u32 rows
    monkeypatch.setenv("GRM_HBM_BUDGET_BYTES", str(device_bytes * 5 // 3 + 2))
    assert isinstance(GrmDataset(path, device="cpu").bit_matrix(), BitMatrix)
    monkeypatch.setenv("GRM_HBM_BUDGET_BYTES", str(device_bytes * 5 // 3 - 2))
    ds = GrmDataset(path, device="cpu")
    bm = ds.bit_matrix()
    assert isinstance(bm, StreamingBitMatrix)
    assert ds.bit_matrix() is bm
    monkeypatch.delenv("GRM_HBM_BUDGET_BYTES")
    cols = np.array([3, 900 + 3, 899, 0])
    np.testing.assert_array_equal(
        ds.get_matrix_columns(cols),
        GrmDataset(path, device="cpu").get_matrix_columns(cols))


# -- the streamed engines against grm_tpu's -----------------------------------

@pytest.mark.parametrize("engine", ["host", "device", "device-argmax"])
def test_forced_streamed_dataset_scm_engines_match_jax(tmp_path, monkeypatch,
                                                       engine):
    """After tests/test_streaming.py:29: every engine learns grm_tpu's model
    on a streamed matrix; device-argmax falls back to host with grm_tpu's
    warning, device warns of nothing."""
    dense, labels = _scm_dense(2)
    path, _ = _artifact(tmp_path, dense, labels, "fs", 2, n_folds=2)
    kw = dict(split_name="sp", model_type="conjunction", p=[1.0],
              max_rules=2, parameter_selection="none", random_seed=0)
    _stream_env(monkeypatch)
    passes = _count_chunks(monkeypatch)
    jax_warn, port_warn = [], []
    want = _scm_fingerprint(jax_learn_SCM(dataset_file=path, engine=engine,
                                          warning_callback=jax_warn.append,
                                          **kw))
    got = _scm_fingerprint(learn_SCM(dataset_file=path, engine=engine,
                                     device="cpu",
                                     warning_callback=port_warn.append, **kw))
    assert got == want
    assert port_warn == jax_warn
    if engine == "device-argmax":
        assert any("falling back to --engine host" in w for w in port_warn)
    else:
        assert not port_warn
    assert passes and max(passes) == 4  # 900 columns, chunks of 256


def test_streamed_exact_scm_cv_with_ties(tmp_path, monkeypatch):
    """After tests/test_scm_exact.py:242: the streamed exact engine's
    fingerprint equals grm_tpu's streamed and host ones and the port's
    resident one; one engine run serves the CV and the full-train fits."""
    dense, labels = _scm_dense(5)
    path, _ = _artifact(tmp_path, dense, labels, "hbm", 5, n_folds=2)
    kw = dict(dataset_file=path, **SCM_KW)
    host = _scm_fingerprint(jax_learn_SCM(engine="host", **kw))
    resident = _scm_fingerprint(learn_SCM(engine="device", device="cpu",
                                          **kw))
    _stream_env(monkeypatch)
    jax_streamed = _scm_fingerprint(jax_learn_SCM(engine="device", **kw))
    runs = []
    orig = ExactScmEngine.run_fits

    def spy(self, *a, **k):
        runs.append(self.source is not None)
        return orig(self, *a, **k)

    monkeypatch.setattr(ExactScmEngine, "run_fits", spy)
    passes = _count_chunks(monkeypatch)
    streamed = _scm_fingerprint(learn_SCM(engine="device", device="cpu",
                                          **kw))
    assert streamed == jax_streamed
    assert streamed == host
    assert streamed == resident
    assert any(len(e) > 1 for e in streamed["equiv"])
    assert runs == [True]
    assert passes and all(n == 4 for n in passes)


def test_streamed_engine_escalations_match_resident():
    """The engine alone, budgets of 1: the hit and candidate escalations run
    on the compacted superblocks, whose rule indices map back to global
    ones; a blacklist rides in each chunk's slice and in pass 2's map."""
    dense, labels = _scm_dense(11, n_genomes=40)
    n_genomes, n_kmers = dense.shape
    packed = pack_binary_bytes_to_ints(dense, 32)
    w = packed.shape[0]
    rng = np.random.RandomState(11)
    mask = lambda rows: build_row_mask(rows, 32 * w, 32)
    fits = []
    for model_type in ("conjunction", "disjunction"):
        for p in (0.5, 1.0, 3.0):
            tr = rng.choice(n_genomes, 30, replace=False)
            pos, neg = tr[labels[tr] == 1], tr[labels[tr] == 0]
            if model_type == "disjunction":
                pos, neg = neg, pos
            te = np.setdiff1d(np.arange(n_genomes), tr)
            fits.append({
                "pos_mask": mask(pos), "neg_mask": mask(neg),
                "test_pos_mask": mask(te[labels[te] == 1]),
                "test_neg_mask": mask(te[labels[te] == 0]),
                "p": p, "model_type": model_type,
                "risk_lookup": _make_risk_lookup(
                    rng.rand(n_kmers), rng.rand(n_kmers), n_kmers)})
    assert all(f["pos_mask"].shape == (w,) for f in fits)
    blacklist = np.array([4, 300, 900 + 610, 899])
    resident = BitMatrix(packed, n_genomes, device="cpu").data
    streamed = StreamingBitMatrix(packed, n_genomes, block_cols=CHUNK,
                                  device="cpu")
    for excl in (None, blacklist):
        want = ExactScmEngine(resident, n_kmers, excl, sb=CHUNK,
                              hit_budget=1, cand_budget=1).run_fits(
            fits, 4, collect_ties=True)
        engine = ExactScmEngine(streamed, n_kmers, excl, hit_budget=1,
                                cand_budget=1)
        assert engine.sb == CHUNK
        got = engine.run_fits(fits, 4, collect_ties=True)
        for g, x in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, x)
        for ties_g, ties_w in zip(got[4], want[4]):
            assert [t.tolist() for t in ties_g] == [t.tolist()
                                                    for t in ties_w]
    with pytest.raises(ValueError, match="does not divide"):
        ExactScmEngine(streamed, n_kmers, sb=100)


def test_streamed_exact_cart_matches_jax_host_and_resident(tmp_path,
                                                           monkeypatch):
    """After tests/test_cart_exact.py:250: the duplicate column 430 = 5 lies
    in another chunk, so the tie sets and occurrences merge across chunks."""
    dense, labels = _cart_dense()
    path, _ = _artifact(tmp_path, dense, labels, "cs", 13, n_folds=2,
                        train_prop=0.75)
    kw = dict(dataset_file=path, **CART_KW)
    host = _cart_fingerprint(jax_learn_CART(engine="host", **kw))
    resident = _cart_fingerprint(learn_CART(engine="device", device="cpu",
                                            **kw))
    _stream_env(monkeypatch)
    jax_streamed = _cart_fingerprint(jax_learn_CART(engine="device", **kw))
    passes = _count_chunks(monkeypatch)
    streamed = _cart_fingerprint(learn_CART(engine="device", device="cpu",
                                            **kw))
    assert streamed == jax_streamed
    assert streamed == host
    assert streamed == resident
    assert any(len(v) > 1 for v in streamed["equiv"].values())
    assert len(passes) >= 2 and all(n == 4 for n in passes)


def test_streamed_cart_argmax_falls_back_to_host(tmp_path, monkeypatch):
    """learn_CART(device-argmax) on a streamed matrix runs the host engine,
    with grm_tpu's warning and grm_tpu's model."""
    dense, labels = _cart_dense()
    path, _ = _artifact(tmp_path, dense, labels, "ca", 13, n_folds=2,
                        train_prop=0.75)
    _stream_env(monkeypatch)
    kw = dict(dataset_file=path, engine="device-argmax", **CART_KW)
    jax_warn, port_warn = [], []
    want = _cart_fingerprint(jax_learn_CART(warning_callback=jax_warn.append,
                                            **kw))
    got = _cart_fingerprint(learn_CART(device="cpu",
                                       warning_callback=port_warn.append,
                                       **kw))
    assert got == want
    assert port_warn == jax_warn
    assert any("falling back to --engine host" in w for w in port_warn)


@pytest.mark.parametrize("learner", ["scm", "tree"])
def test_streaming_under_a_kmer_blacklist(tmp_path, monkeypatch, learner):
    """A k-mer blacklist rides in each chunk's exclusion slice: the streamed
    exact engines give grm_tpu's streamed and the port's resident model."""
    dense, labels = _scm_dense(6) if learner == "scm" else _cart_dense(21)
    path, _ = _artifact(tmp_path, dense, labels, "bl", 6, n_folds=2)
    marker = 300 if learner == "scm" else 5
    with h5py.File(path) as f:
        banned = _s(f["kmer_sequences"][int(
            f["kmer_by_matrix_column"][marker])])
    bl = tmp_path / "bl.txt"
    bl.write_text(banned + "\n")
    learn, jax_learn, fp, kw = (
        (learn_SCM, jax_learn_SCM, _scm_fingerprint, SCM_KW)
        if learner == "scm" else
        (learn_CART, jax_learn_CART, _cart_fingerprint, CART_KW))
    kw = dict(kw, dataset_file=path, kmer_blacklist_file=str(bl),
              engine="device")
    resident = fp(learn(device="cpu", **kw))
    _stream_env(monkeypatch)
    want = fp(jax_learn(**kw))
    got = fp(learn(device="cpu", **kw))
    assert got == want
    assert got == resident
    rules = got["rules"] if learner == "scm" else list(got["importances"])
    assert rules and all(seq != banned for seq, _ in rules)


def test_streamed_gather_regime_three_classes(tmp_path, monkeypatch):
    """Three classes of 60 genomes: the master root's count lattice passes
    S_MAX, so it takes the gather regime over the chunks. The whole
    fingerprint equals the host engines' and the port's resident one."""
    rng = np.random.RandomState(6)
    n_genomes, n_kmers = 180, 600
    dense = (rng.rand(n_genomes, n_kmers) > 0.5).astype(np.uint8)
    labels = (np.arange(n_genomes) % 3).astype(np.uint8)
    for c, cls in [(4, 0), (311, 1), (519, 2)]:
        col = (labels == cls).astype(np.uint8)
        col[rng.choice(n_genomes, 12, replace=False)] ^= 1
        dense[:, c] = col
    dense[:, 400] = dense[:, 4]
    path, _ = _artifact(tmp_path, dense, labels, "tri", 6, n_folds=2,
                        train_prop=0.75)
    kw = dict(dataset_file=path, split_name="sp", criterion=["gini"],
              max_depth=[2],
              min_samples_split=[2],
              class_importance=[{0: 1.0, 1: 1.0, 2: 1.0}],
              parameter_selection="cv")
    host = _cart_fingerprint(jax_learn_CART(engine="host", **kw))
    resident = _cart_fingerprint(learn_CART(engine="device", device="cpu",
                                            **kw))
    _stream_env(monkeypatch)
    modes = []
    orig = port_ce.cart_exact_select

    def spy(*a, **k):
        modes.append(a[7])
        return orig(*a, **k)

    monkeypatch.setattr(port_ce, "cart_exact_select", spy)
    streamed = _cart_fingerprint(learn_CART(engine="device", device="cpu",
                                            **kw))
    assert streamed == host
    assert streamed == resident
    assert modes.count("gather") >= 3  # one per chunk of a gather frontier


def test_streamed_gather_payload_equals_resident_and_covers_jax():
    """The gather regime's pool over three chunks is the resident pool
    exactly (columns ascending, counts, occurrences), and its float64 tie
    set (columns 7 and 520, in two chunks) is grm_tpu's."""
    from grm_tpu.ops.popcount import BitMatrix as JaxBitMatrix

    rng = np.random.RandomState(9)
    n_genomes, n_kmers = 600, 700
    dense = (rng.rand(n_genomes, n_kmers) > 0.5).astype(np.uint8)
    labels = (np.arange(n_genomes) >= 300).astype(np.uint8)
    col = labels.copy()
    col[rng.choice(n_genomes, 30, replace=False)] ^= 1
    dense[:, 7] = col
    dense[:, 520] = col
    idx = np.arange(n_genomes)
    node = {0: idx[labels == 0], 1: idx[labels == 1]}
    priors, totals = {0: 0.5, 1: 0.5}, {0: 300.0, 1: 300.0}
    packed = pack_binary_bytes_to_ints(dense, 32)
    args = ([node], priors, totals, "gini", [idx])
    want = cart_frontier_candidates(BitMatrix(packed, n_genomes, "cpu"),
                                    *args)[0]
    got = cart_frontier_candidates(
        StreamingBitMatrix(packed, n_genomes, block_cols=CHUNK, device="cpu"),
        *args)[0]
    assert set(got) == {"cols", "left", "occ"}
    np.testing.assert_array_equal(got["cols"], want["cols"])
    np.testing.assert_array_equal(got["occ"], want["occ"])
    for cl in (0, 1):
        np.testing.assert_array_equal(got["left"][cl], want["left"][cl])
    jax = jax_candidates(JaxBitMatrix.from_dense(dense), *args)[0]

    def tie_set(p):
        vals = port_cart.score_candidates_f64(
            "gini", priors, totals, {c: len(v) for c, v in node.items()},
            p["left"])
        return list(p["cols"][vals == vals.min()])

    assert tie_set(got) == tie_set(jax) == [7, 520]


# -- the CLI -----------------------------------------------------------------

@pytest.mark.parametrize("learner", ["scm", "tree"])
def test_cli_learns_streamed(tmp_path, monkeypatch, learner):
    """``learn scm`` and ``learn tree`` with ``--engine device --device cpu``
    stream under GRM_HBM_BUDGET_BYTES, and write ``grm``'s reports."""
    dense, labels = _cart_dense(21, n_genomes=30, n_kmers=700)
    _artifact(tmp_path, dense, labels, "ds", 4, n_folds=3)
    common = ["learn", learner, "--dataset", "ds.h5", "--split", "sp",
              "--engine", "device", "--output-dir", "out"]
    common += (["--p", "0.5", "1.0", "--max-rules", "3", "--random-seed", "5"]
               if learner == "scm" else
               ["--criterion", "gini", "--max-depth", "2", "3"])
    env = dict(os.environ, JAX_PLATFORMS="cpu", GRM_PLATFORM="cpu",
               GRM_HBM_BUDGET_BYTES="1000",
               GRM_STREAM_CHUNK_COLS=str(CHUNK),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    r = subprocess.run([sys.executable, "-m", "grm_tpu"] + common,
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    os.rename(tmp_path / "out", tmp_path / "want")
    _stream_env(monkeypatch)
    monkeypatch.chdir(tmp_path)
    passes = _count_chunks(monkeypatch)
    port_cli(common + ["--device", "cpu"])
    assert passes and all(n == 3 for n in passes)
    _assert_same_outputs(tmp_path / "want", tmp_path / "out",
                         {"model.fasta"})
