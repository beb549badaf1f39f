"""grm_tpu_torch imports neither JAX nor any grm_tpu module (nor h5py or
pandas, which the GPU machine may lack: only the functions that write a
file or read a TSV import them; the AMR table, the results site, the
settings and the profiling hooks run without either), and its entry points
default to CUDA and raise without it, the k-mer counter, dataset creation
and the ``dataset create`` command included. Runs in a fresh interpreter, because this test
process has JAX loaded (tests/conftest.py)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "h5py", "pandas"):
    sys.modules[name] = None  # any import of them now fails

import grm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(grm_tpu_torch.__path__,
                                               "grm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "grm_tpu" or m.startswith("grm_tpu."))
assert not leaked, leaked

import numpy as np
import torch
assert not torch.cuda.is_available()
from grm_tpu_torch.dataset import GrmDataset, from_numpy_artifact
from grm_tpu_torch.device import resolve_device
from grm_tpu_torch.learning.experiments import learn_CART, learn_SCM
from grm_tpu_torch.ops.kmer import sorted_kmers_np
from grm_tpu_torch.ops.popcount import BitMatrix
from grm_tpu_torch.parallel.device_build import (
    build_matrix_device, build_matrix_device_batched)
from grm_tpu_torch.pipeline import InMemoryDataset
from grm_tpu_torch.kmer.counter import count_fasta
from grm_tpu_torch.dataset import MemoryArtifact, from_contigs
from grm_tpu_torch.cli import main as cli_main
from grm_tpu_torch.parallel.build import build_presence_matrix_distributed
from grm_tpu_torch.parallel.mesh import make_mesh
from grm_tpu_torch.ops import masked_popcount_colsum

calls = [
    lambda: resolve_device(),
    lambda: BitMatrix(np.zeros((1, 4), np.uint32), 3),
    lambda: GrmDataset("unused.h5"),
    lambda: learn_SCM("unused.h5", "sp", "conjunction", 1.0),
    lambda: learn_CART("unused.h5", "sp", "gini", 3, 2, {0: 1.0, 1: 1.0}),
    lambda: learn_CART("unused.h5", "sp", "gini", 3, 2, {0: 1.0, 1: 1.0},
                       engine="device-argmax"),
    lambda: learn_CART("unused.h5", "sp", "gini", 3, 2, {0: 1.0, 1: 1.0},
                       engine="device"),
    lambda: sorted_kmers_np(np.zeros(40, np.int8), 9),
    lambda: build_matrix_device([np.zeros(40, np.int8)], 9),
    lambda: build_matrix_device_batched([np.zeros(40, np.int8)], 9),
    lambda: InMemoryDataset.from_contigs_device([], {}, 9),
    lambda: InMemoryDataset.from_contigs([], {}, 9),
    lambda: count_fasta("unused.fna", 9),
    lambda: from_contigs("unused.tsv", MemoryArtifact(), 9),
    lambda: cli_main(["dataset", "create", "from-contigs", "--genomic-data",
                      "unused.tsv", "--output", "unused.h5"]),
    lambda: learn_SCM("unused.h5", "sp", "conjunction", 1.0, engine="device",
                      mesh=make_mesh(2, devices=["cpu", "cpu"])),
    lambda: build_presence_matrix_distributed([("g", "unused.fna")], 9),
    lambda: masked_popcount_colsum(np.zeros((1, 4), np.uint32),
                                   np.zeros(1, np.uint32)),
]
for call in calls:
    try:
        call()
    except RuntimeError as e:
        assert "CUDA is not available" in str(e), e
    else:
        raise AssertionError("ran without CUDA")
assert resolve_device("cpu").type == "cpu"
try:  # the default mesh is every CUDA device: none here
    make_mesh()
except ValueError as e:
    assert "0 given" in str(e), e
else:
    raise AssertionError("a mesh without devices")
for module in ("learning.tree", "learning.cart", "ops.cart_sweep",
               "ops.cart_exact", "parallel.cart_device",
               "parallel.cart_exact", "parallel.cart_forest",
               "learning.experiments.cart_experiment", "ops.kmer",
               "ops.device_build", "parallel.device_build", "pipeline",
               "hostmem", "native.bindings", "kmer.counter", "kmer.matrix",
               "dataset.create", "dataset.split", "collect", "collect.amr",
               "collect.patric", "settings", "results_site", "profiling",
               "parallel.mesh", "parallel.scm_device", "parallel.scm_grid",
               "parallel.distributed", "parallel.build"):
    assert "grm_tpu_torch." + module in names, module

# The host modules run with pandas, h5py and JAX blocked.
import os, tempfile
from grm_tpu_torch.collect.amr import AmrDatabase
from grm_tpu_torch.profiling import StageTimer, throughput
from grm_tpu_torch.results_site import _dataset_dims, write_site
from grm_tpu_torch.settings import get_setting, set_setting

with tempfile.TemporaryDirectory() as tmp:
    os.environ["GRM_SETTINGS_PATH"] = os.path.join(tmp, "settings.json")
    amr = os.path.join(tmp, "amr.txt")
    with open(amr, "w") as f:
        f.write("genome_id\tgenome_name\tantibiotic\tresistant_phenotype\t"
                "measurement\tmeasurement_unit\n1.1\tE coli\tamp\tResistant\t"
                "8\tmg/L\n")
    db = AmrDatabase.load(amr)
    db.export(db.select(numeric_phenotypes=True), tmp, "E coli", "amp")
    set_setting("amr_database", amr)
    assert get_setting("amr_database") == amr
    assert _dataset_dims({"data": {"path": amr}}) == (None, None)
    timer = StageTimer()
    with timer.stage("load"):
        throughput(1, 1, 1.0)
    cli_main(["settings", "show"])
print("imported", len(names))
'''


def test_port_imports_no_jax_and_requires_cuda():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 47  # every module was imported
