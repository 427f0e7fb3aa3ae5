"""BENCHMARK.json against the benchmark's contract: its keys, names,
units and texts, and every file it names."""
import json
import os
import re

import pytest

from mvsbench import manifest

from conftest import REPO

BENCH = manifest.load(REPO)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


def names_problems(bench: dict) -> list[str]:
    """Every name, unit and one-line text of the manifest that breaks the
    benchmark's character rules."""
    bad = []

    def name(v, where):
        if not isinstance(v, str) or not NAME.match(v):
            bad.append(f"{where}: name {v!r}")

    def line(v, where):
        if (not isinstance(v, str) or not 1 <= len(v) <= 200
                or "\n" in v or "\t" in v):
            bad.append(f"{where}: text {v!r}")

    for c in bench["configs"]:
        name(c["name"], "config")
        line(c["source"], f"config {c['name']} source")
        line(c["why"], f"config {c['name']} why")
        for k in c["reduced"]:
            name(k, f"config {c['name']} reduced")
    for w in bench["workloads"]:
        for key in ("name", "config", "traffic"):
            name(w[key], f"workload {key}")
        line(w["why"], f"workload {w['name']} why")
    for m in bench["end_to_end"] + bench["per_layer"]:
        name(m["name"], "metric")
        if not UNIT.match(m["unit"]):
            bad.append(f"metric {m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            bad.append(f"metric {m['name']}: better {m['better']!r}")
        if "layer" in m:
            line(m["layer"], f"metric {m['name']} layer")
    for word in bench["command"]:
        line(word, "command")
    return bad


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mvsbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 65536
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("mvsbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_texts():
    assert names_problems(BENCH) == []
    names = [x["name"] for x in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    c = manifest.cell(REPO, cell, BENCH)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
    assert set(c.limits) >= {"pyramid_gap", "color_miss", "file_miss"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_each_metric_has_its_reader(metric):
    entry = next(m for m in BENCH["end_to_end"] + BENCH["per_layer"]
                 if m["name"] == metric)
    mod = manifest.reader(REPO, metric)
    assert mod.UNIT == entry["unit"]
    if "layer" in entry:
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])
    assert callable(mod.read)
    assert mod.read({}) is None or metric == "setup_s"


def test_configs_are_unreduced_deployments():
    for c in BENCH["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert (conf["width"], conf["height"]) == (640, 480)
        assert conf["views"] == int(re.search(r"(\d+) views",
                                              c["source"]).group(1))
        assert c["reduced"] == []
