"""No module the benchmark runs has jax, jaxlib, flax, grm_tpu or bench as
its top-level name, compared whole; the references import nothing of the
program."""

import ast
import os
import subprocess
import sys

from harness import runner

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_names_compare_whole(monkeypatch):
    fake = dict(sys.modules)
    for name in ("grm_tpu_torch", "grm_tpu_torch.ops", "benchmark_x",
                 "jax_free", "flaxen"):
        fake.setdefault(name, sys)
    monkeypatch.setattr(sys, "modules", fake)
    assert runner.forbidden_modules() == []
    fake["grm_tpu.ops"] = sys
    fake["bench"] = sys
    fake["jaxlib.xla"] = sys
    assert runner.forbidden_modules() == ["bench", "grm_tpu", "jaxlib"]


def imports_of(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def benchmark_sources():
    for dirpath, dirnames, filenames in os.walk(BENCH):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_names_a_forbidden_module():
    for path in benchmark_sources():
        if os.sep + "tests" + os.sep in path:
            continue  # the tests read chip_smoke, whose recipes they hold
        assert not imports_of(path) & set(runner.FORBIDDEN), path


def test_references_import_nothing_of_the_program():
    for f in os.listdir(os.path.join(BENCH, "reference")):
        if f.endswith(".py"):
            found = imports_of(os.path.join(BENCH, "reference", f))
            assert "grm_tpu_torch" not in found, f


def test_loading_every_benchmark_module_loads_no_forbidden_module():
    code = (
        "import sys, os, glob\n"
        "sys.path[:0] = [%r, %r]\n"
        "from harness import runner\n"
        "cell = runner.load_cell(%r, 'scm.mtb-isoniazid-5022', trace=True)\n"
        "for n in ('ingest.kover-median-342', 'cart.mtb-isoniazid-5022'):\n"
        "    runner.load_cell(%r, n, trace=True); runner.load_cell(%r, n)\n"
        "import controls, spread, grm_tpu_torch.learning.experiments\n"
        "import grm_tpu_torch.pipeline, grm_tpu_torch.reports\n"
        "print(runner.forbidden_modules())\n"
        % (ROOT, BENCH, ROOT, ROOT, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
