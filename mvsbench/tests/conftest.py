"""Shared helpers of the benchmark's CPU tests: a temporary copy of the
benchmark with a tiny cell added as files, run on the CPU."""
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = "tiny.l0"


def copy_benchmark(dst: str) -> str:
    """BENCHMARK.json and mvsbench/ (without its tests) copied to `dst`,
    the port linked beside them; returns `dst`."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(REPO, "mvsbench"),
                    os.path.join(dst, "mvsbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    os.symlink(os.path.join(REPO, "cmvs_pmvs_tpu_torch"),
               os.path.join(dst, "cmvs_pmvs_tpu_torch"))
    return dst


def add_tiny_cell(root: str, views: int = 5, width: int = 96,
                  height: int = 72, focal: float = 105.0):
    """A cell `tiny.l0` of the sparse ring's shapes cut to a few small
    views, added as a config, a traffic mix, a limits file and manifest
    entries (listed wherever `sparse-ring.l0` is)."""
    mv = os.path.join(root, "mvsbench")
    with open(os.path.join(mv, "configs", "temple-sparse-ring.json")) as f:
        conf = json.load(f)
    conf.update(name="tiny", views=views, width=width, height=height)
    conf["assumed"]["focal"] = focal
    with open(os.path.join(mv, "configs", "tiny.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(mv, "traffic", "tiny.json"), "w") as f:
        json.dump({"what": "tiny", "level": 0,
                   "reconstruct": {"p_cap": 4096, "expand_iters": 2,
                                   "max_waves": 4},
                   "check": {"patches": 2000, "pixels_per_image": 300}}, f)
    with open(os.path.join(mv, "limits", TINY + ".json"), "w") as f:
        json.dump({"pyramid_gap": 0, "color_miss": 0.01, "file_miss": 0,
                   "ncc_gap": 1e-3, "cover_miss": 0.4}, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "a test's",
                             "file": "mvsbench/configs/tiny.json",
                             "reduced": ["views", "width", "height"],
                             "why": "a test's"})
    bench["workloads"].append({"name": TINY, "config": "tiny",
                               "traffic": "tiny", "chips": 1,
                               "why": "a test's"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sparse-ring.l0" in m.get("workloads", ()):     # one card's
            m["workloads"].append(TINY)
    with open(path, "w") as f:
        json.dump(bench, f)


@pytest.fixture
def bench_copy(tmp_path):
    return copy_benchmark(str(tmp_path))
