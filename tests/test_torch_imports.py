"""grm_tpu_torch imports neither JAX nor any grm_tpu module (nor h5py or
pandas, which the GPU machine may lack), and its entry points default to
CUDA and raise without it. Runs in a fresh interpreter, because this test
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
from grm_tpu_torch.ops.popcount import BitMatrix

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
]
for call in calls:
    try:
        call()
    except RuntimeError as e:
        assert "CUDA is not available" in str(e), e
    else:
        raise AssertionError("ran without CUDA")
assert resolve_device("cpu").type == "cpu"
for module in ("learning.tree", "learning.cart", "ops.cart_sweep",
               "ops.cart_exact", "parallel.cart_device",
               "parallel.cart_exact", "parallel.cart_forest",
               "learning.experiments.cart_experiment"):
    assert "grm_tpu_torch." + module in names, module
print("imported", len(names))
'''


def test_port_imports_no_jax_and_requires_cuda():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 32  # every module was imported
