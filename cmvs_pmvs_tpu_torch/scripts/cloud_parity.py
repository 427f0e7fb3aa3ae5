"""Whether two checkouts of the port give the same cloud, bit for bit, on
the CPU.

Runs `PMVSEngine.run` of each checkout's `cmvs_pmvs_tpu_torch` in its
own process on one scene (tests/test_torch_buckets.py's plane tree: 5
cameras at 192x144, focal 260; level 0, csize 2, wsize 7, minImageNum 3)
with the filters on, and compares every field of the final clouds' alive
prefix and of the grids; prints one JSON line with each run's count and
seconds and the first field that differs (null when none does).

    python -m cmvs_pmvs_tpu_torch.scripts.cloud_parity OTHER_ROOT
        [--expand-iters 2] [--max-waves 4] [--refine-iters 4]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# run in a child whose sys.path starts at the checkout under test; it uses
# only names every checkout of the port has
CHILD = r"""
import dataclasses, json, os, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from cmvs_pmvs_tpu_torch.models.engine import PMVSEngine, load_scene
from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions
from cmvs_pmvs_tpu_torch.utils.synthetic import (make_plane_scene,
                                                 write_pmvs_tree)
tree, out, run = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
write_pmvs_tree(make_plane_scene(num_cameras=5, width=192, height=144,
                                 focal=260.0), tree)
with open(os.path.join(tree, "option.txt"), "w") as f:
    f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
            "CPU 4\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
            "timages -1 0 5\noimages 0\n")
opt = PMVSOptions.parse(os.path.join(tree, "option.txt"))
data = load_scene(tree, opt, device="cpu")
eng = PMVSEngine(data, opt, p_cap=16384, log=lambda *a: None, device="cpu")
t0 = time.perf_counter()
eng.run(**run)
arrays = {"seconds": np.asarray(time.perf_counter() - t0)}
for prefix, obj in (("cloud", eng.cloud), ("grid", eng.grid)):
    for f in dataclasses.fields(obj):
        arrays[prefix + "." + f.name] = getattr(obj, f.name).numpy()
np.savez(out, **arrays)
"""


def run_tree(root: str, work: str, name: str, run: dict) -> dict:
    """The final state of `root`'s engine on the scene, as arrays."""
    tree = os.path.join(work, name)
    out = os.path.join(work, name + ".npz")
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", CHILD, tree, out, json.dumps(run)],
                   check=True, env=env, cwd=work)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def first_difference(a: dict, b: dict) -> str | None:
    """The first field (cloud fields on the alive prefix, then the grid)
    where the two states differ, or None."""
    na, nb = int(a["cloud.alive"].sum()), int(b["cloud.alive"].sum())
    if na != nb:
        return f"alive count {na} against {nb}"
    for k in a:
        if k == "seconds":
            continue
        x, y = a[k], b[k]
        if k.startswith("cloud."):
            x, y = x[:na], y[:nb]
        if x.shape != y.shape or not np.array_equal(x, y):
            return k
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--expand-iters", type=int, default=2)
    ap.add_argument("--max-waves", type=int, default=4)
    ap.add_argument("--refine-iters", type=int, default=4)
    args = ap.parse_args(argv)
    run = dict(expand_iters=args.expand_iters, max_waves=args.max_waves,
               refine_iters=args.refine_iters)
    with tempfile.TemporaryDirectory(prefix="cloud_parity_") as work:
        this = run_tree(ROOT, work, "this", run)
        other = run_tree(os.path.abspath(args.other), work, "other", run)
    diff = first_difference(this, other)
    print(json.dumps({"run": run, "this": {
        "patches": int(this["cloud.alive"].sum()),
        "seconds": float(this["seconds"])}, "other": {
        "patches": int(other["cloud.alive"].sum()),
        "seconds": float(other["seconds"])},
        "bit_equal": diff is None, "first_difference": diff}))
    return 0 if diff is None else 1


if __name__ == "__main__":
    raise SystemExit(main())
