"""BENCHMARK.json keeps to the contract's form, and every name it gives
is found as a file."""

import json
import os
import re

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    assert isinstance(spec["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_command_and_paths(spec):
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert len(spec["command"]) <= 32 and all(line(w) for w in
                                              spec["command"])
    for word in spec["command"]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in spec["paths"])


def test_configs(spec):
    names = [c["name"] for c in spec["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    files = set()
    used = {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"] not in files
        files.add(c["file"])
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        assert c["name"] in used
        assert c["file"] == "benchmark/configs/%s.json" % c["name"]


def test_workloads(spec):
    names = [w["name"] for w in spec["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    configs = {c["name"] for c in spec["configs"]}
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert line(w["why"])
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        assert os.path.isfile(os.path.join(BENCH, "jobs",
                                           traffic["job"] + ".py"))


def test_metrics(spec):
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    names = list(e2e) + [m["name"] for m in spec["per_layer"]]
    assert len(names) == len(set(names))
    assert 1 <= len(e2e) <= 16 and 1 <= len(spec["per_layer"]) <= 128
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    for cell in cells:
        reported = [m for m in spec["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in spec["per_layer"])


def test_files_under_paths_are_named_from_name_characters(spec):
    for p in spec["paths"]:
        for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, p)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in filenames:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert PATH.match(rel), rel
