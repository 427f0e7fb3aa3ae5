"""Steady full-protocol runs on the card: eager, graphed with a fresh
graph cache, graphed with one cache kept across runs - of this checkout,
or in turns with another checkout's.

Each checkout runs in a process of its own on one loaded scene (the full
protocol of `profile_e2e.FULL`: 12 views at 640x480, 3 expand rounds,
p_cap 200,000): `--runs` engine runs of each kind (the kept cache
filled by one run before them), each timed to a synchronize, with its
patches, phase seconds, peak allocated memory, K1/K2 launches and, where
the engine counts them, its host reads. With `--against DIR` the
checkouts run in turns (DIR, this, this, DIR), so that both are measured
on one card in one call. One JSON line per process on stdout and, with
`--out`, in that file.

    python -m cmvs_pmvs_tpu_torch.scripts.steady_runs [--runs 3]
        [--against DIR] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# run with PYTHONPATH at the checkout under test; it uses only names every
# checkout of the port since its graphs (models/graphs.RefineGraphs) has
CHILD = r"""
import json, os, sys, time
import torch
from cmvs_pmvs_tpu_torch.models.engine import PMVSEngine, load_scene
from cmvs_pmvs_tpu_torch.models.graphs import RefineGraphs
from cmvs_pmvs_tpu_torch.ops import kernels
from cmvs_pmvs_tpu_torch.scripts.profile_e2e import FULL, write_tree
from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions
root, label, runs = sys.argv[1], sys.argv[2], int(sys.argv[3])
dev = torch.device("cuda")
kernels.lib()
write_tree(root, FULL)
opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
data = load_scene(root, opt, device=dev)
kept = RefineGraphs(dev)
out = {"tree": label, "card": torch.cuda.get_device_name(0)}
def run(graphs):
    entries = kernels.entries()
    before = {k: e.launches for k, e in entries.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = PMVSEngine(data, opt, p_cap=FULL.p_cap, log=lambda m: None,
                     device=dev, graphs=graphs)
    eng.run(**FULL.run_kwargs())
    torch.cuda.synchronize()
    r = {"seconds": time.perf_counter() - t0,
         "patches": int(eng.cloud.count()),
         "phases": {k: round(v.seconds, 4)
                    for k, v in eng.tracer.spans.items()},
         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
         "launches": {k: e.launches - before[k] for k, e in entries.items()
                      if e.launches - before[k]},
         "host_reads": getattr(eng, "host_reads", None),
         "graphs": eng.graphs.stats() if eng.graphs else None}
    del eng
    return r
for kind, graphs in (("eager", lambda: False),
                     ("fresh", lambda: RefineGraphs(dev)),
                     ("kept", lambda: kept)):
    if kind == "kept":
        out["kept_fill"] = run(kept)
    out[kind] = [run(graphs()) for _ in range(runs)]
print(json.dumps(out), flush=True)
"""


def run_tree(tree: str, label: str, runs: int) -> dict:
    """One process's runs of the checkout at `tree`."""
    with tempfile.TemporaryDirectory(prefix="steady_runs_") as work:
        env = dict(os.environ, PYTHONPATH=tree)
        res = subprocess.run(
            [sys.executable, "-c", CHILD, os.path.join(work, "scene"), label,
             str(runs)], env=env, cwd=tree, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"steady runs of {tree} failed "
                           f"({res.returncode}):\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--against", metavar="DIR",
                    help="another checkout, run in turns with this one")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args(argv)
    order = [(ROOT, "this")]
    if args.against:
        other = (os.path.abspath(args.against), "against")
        order = [other, order[0], order[0], other]
    lines = []
    for tree, label in order:
        lines.append(json.dumps(run_tree(tree, label, args.runs)))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
