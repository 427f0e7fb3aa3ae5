"""The benchmark's manifest (`BENCHMARK.json` at the checkout's root) and
the files it names.

Everything that belongs to one configuration, one traffic mix, one cell
or one metric is a file of its own, found by its name:

    mvsbench/configs/<config>.json    a deployment's sizes and options
    mvsbench/traffic/<traffic>.json   a job mix: level, what the
                                      check samples
    mvsbench/limits/<cell>.json       the limits of the cell's check
    mvsbench/metrics/<metric>.py      a metric's reader: UNIT, LAYER,
                                      MOVES and read(ctx)

so a cell or a metric is added by adding files and manifest entries.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list     # the manifest's metric entries this cell reports
    per_layer: list


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(root: str, kind: str, name: str) -> dict:
    path = os.path.join(root, "mvsbench", kind, name + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """Whether `cell` reports `metric`: its `workloads` list names the
    cell, or it has none and the cell reports the end-to-end metric it
    `moves` (an end-to-end metric without a list: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_of_cell
    return True


def cell(root: str, workload: str, bench: dict | None = None) -> Cell:
    """The cell `workload` of the manifest under `root`, with its files."""
    bench = bench or load(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    e2e = [m for m in bench["end_to_end"] if reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, workload, names)]
    return Cell(name=workload, config=config,
                traffic=_json(root, "traffic", entry["traffic"]),
                chips=int(entry["chips"]),
                limits=_json(root, "limits", workload),
                end_to_end=e2e, per_layer=per_layer)


def reader(root: str, metric: str):
    """The reader module of `metric` (mvsbench/metrics/<metric>.py)."""
    path = os.path.join(root, "mvsbench", "metrics", metric + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no reader {path} for metric {metric}")
    spec = importlib.util.spec_from_file_location(
        "mvsbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
