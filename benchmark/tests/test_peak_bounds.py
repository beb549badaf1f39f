"""The frozen bound formulas against the bound ms of PERF.md §6 (phase 6
of chip_smoke.py)."""

from types import SimpleNamespace

import pytest

from harness import peaks
import importlib.util
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name, os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Shaped(SimpleNamespace):
    """Stands for a CUDA tensor: a shape, a device, a size."""

    def numel(self):
        n = 1
        for d in self.shape:
            n *= d
        return n


def cuda(*shape):
    return Shaped(shape=shape, device=SimpleNamespace(type="cuda"))


def test_rates_are_frozen():
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.B1_BIT_ANDS_PER_S == 5.14e15
    assert peaks.SFU_PER_S == 4.24e12


@pytest.mark.parametrize("fn,f,block,ms", [
    ("sbmax", 120, 8192, 0.1578),   # scm_sweep_sbmax, W=11 K=9.6M F=120
    ("argmax", 100, 4096, 0.1315),  # scm_sweep_argmax, W=11 K=9.6M F=100
])
def test_scm_sweep_bounds(fn, f, block, ms):
    m = metric("scm_sweep_roofline")
    key = [k for k in m.WRAPS if k.endswith(fn) or k.endswith(fn + "_blocks")]
    args = (cuda(11, 9_600_000), cuda(f, 11), None, None, None, None, None,
            block)
    assert m.WRAPS[key[0]](args, {}) * 1e3 == pytest.approx(ms, abs=5e-5)


@pytest.mark.parametrize("n_pairs,rows,valid,ms", [
    (1, 32 * 1075 * 4096, False, 1.0095),  # one batch of 32 genomes
    (1, 4_400_000, False, 0.0315),         # one genome
    (2, 32 * 1075 * 4096, True, 1.7665),   # a batch at k = 33
])
def test_radix_sort_bounds(n_pairs, rows, valid, ms):
    m = metric("radix_sort_roofline")
    args = (cuda(n_pairs, rows), cuda(rows) if valid else None)
    assert m.record(args, {}) * 1e3 == pytest.approx(ms, abs=5e-5)


def test_a_cpu_call_has_no_bound():
    m = metric("radix_sort_roofline")
    cpu = Shaped(shape=(1, 100), device=SimpleNamespace(type="cpu"))
    assert m.record((cpu, None), {}) == 0.0


def test_roofline_is_silent_without_launches():
    m = metric("radix_sort_roofline")
    run = SimpleNamespace(timeline=SimpleNamespace(
        kernel_s=lambda patterns: (0.0, 0)), calls={})
    assert m.read(run) is None
