"""The benchmark's own tests (CPU, small sizes): run them from the root of
the repository with ``python -m pytest benchmark/tests``. Tests that need
the card are marked ``cuda`` and skip without one (``card`` fixture)."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def _job(name):
    """A job module under the name ``jobs_<name>``, for the tests."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jobs_" + name, os.path.join(BENCH, "jobs", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["jobs_" + name] = mod
    spec.loader.exec_module(mod)
    return mod


_job("learn_scm")
_job("learn_cart")
_job("ingest_device")

# Small copies of the configurations, for CPU runs of the real jobs.
SMALL = {
    "mtb-isoniazid-5022": {"dataset": {"n_genomes": 130, "n_kmers": 20000}},
    "kover-median-342": {"genomes": {"n_genomes": 70, "length": 20000,
                                     "n_snps": 90, "snp_pool": 520},
                         "ingest": {"k_budget": 1 << 17,
                                    "batch_budget": 1 << 17}},
}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def small_bench(tmp_path):
    """A copy of the benchmark's folder whose configurations are cut to a
    size the CPU runs in seconds."""
    dst = tmp_path / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for name, changes in SMALL.items():
        path = dst / "configs" / (name + ".json")
        cfg = json.loads(path.read_text())
        for group, values in changes.items():
            cfg[group].update(values)
        path.write_text(json.dumps(cfg))
    return str(dst)
