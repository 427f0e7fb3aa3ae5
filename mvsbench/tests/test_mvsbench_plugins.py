"""A configuration, a traffic mix and a metric added as files alone are
found by name: the harness needs no edit for a new cell or metric."""
import json
import os

from mvsbench import manifest

from conftest import TINY, add_tiny_cell


def test_new_cell_and_metric_as_files(bench_copy):
    root = bench_copy
    add_tiny_cell(root)
    mv = os.path.join(root, "mvsbench")
    with open(os.path.join(mv, "metrics", "recons_done.py"), "w") as f:
        f.write('UNIT, LAYER, MOVES = "count", "harness", "recon_s"\n\n\n'
                'def read(ctx):\n    return len(ctx.get("recons") or [])'
                ' or None\n')
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "recons_done", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "recon_s",
                               "workloads": [TINY]})
    with open(path, "w") as f:
        json.dump(bench, f)
    cell = manifest.cell(root, TINY)
    assert cell.config["views"] == 5 and cell.traffic["level"] == 0
    assert "recons_done" in [m["name"] for m in cell.per_layer]
    mod = manifest.reader(root, "recons_done")
    assert mod.read({"recons": [{}, {}]}) == 2
    # the cells already there are untouched
    assert "recons_done" not in [
        m["name"] for m in manifest.cell(root, "sparse-ring.l0").per_layer]
