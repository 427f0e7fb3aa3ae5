"""The full reconstruction protocol, cold then warm, with phase seconds.

Port of scripts/run_full.py: the occluded scene at 12 x 640x480 (mask
border 8, setEdge 0.4), level 0, csize 2, expand_iters 3 to the fixpoint
of 12 waves, 8-iteration refine, p_cap 200,000 (`profile_e2e.FULL`), run
twice in one process through `PMVSEngine.run` on one loaded scene: the
first run pays the process's one-time costs (allocator growth, kernel
library load, the CUDA graphs' warm-ups and captures: it takes a fresh
graph cache of its own, models/graphs.RefineGraphs, whatever the process
captured before), the second is the steady one. The warm engine takes
the cold engine's graph cache (`graphs=`; None on the CPU), so it
replays what the cold run captured, as scripts/run_full.py's warm engine
reuses the programs its cold run compiled (`cold_and_steady`, which the
bench's scene stages run too). Each run's kernel launches are the
counters' difference across it; the counters themselves are left alone.

It prints one JSON line and writes it to `--out` (default
build/run_full.json), and nothing else: the card's name and power limit
(`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, or the
CUDA device's name, marked so, where nvidia-smi is absent), patches,
cold and steady seconds, patches/s, each run's phase seconds, the steady
run's launches of every K1-K4 instantiation that launched (K1 and K2
on the default path), each run's graph cache (`RefineGraphs.stats_since`:
the warm run captures none; None on the CPU), the surface
distance / dscale median and q90, and whether PERF.md section 2's bars
hold: >= 80,000 patches, median < 0.4, q90 < 1.5. Exit code 0 when they
hold, else 1.

    python -m cmvs_pmvs_tpu_torch.scripts.run_full [--out PATH]
        [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.kernels import launch_counts, launches_since
from . import ablate_common
from .profile_e2e import FULL, Setup, write_tree
from .profiling import phase_seconds, sync

MIN_PATCHES, MAX_MEDIAN, MAX_Q90 = 80_000, 0.4, 1.5


def card(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them; without
    nvidia-smi the device's name, marked so; "cpu" on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    try:
        return ablate_common.card()
    except (OSError, subprocess.CalledProcessError):
        return (f"{torch.cuda.get_device_name(dev)} (power limit not read: "
                f"no nvidia-smi)")


def accuracy(scene, cloud) -> tuple:
    """(median, q90) of the alive patches' distance to the scene's true
    surface over their dscale; infinite for an empty cloud."""
    alive = cloud.alive.cpu().numpy()
    coord = cloud.coord.cpu().numpy()[alive][:, :3]
    dscale = cloud.dscale.cpu().numpy()[alive]
    d = scene.surface_distance(coord) / dscale
    if not len(d):
        return float("inf"), float("inf")
    return float(np.median(d)), float(np.quantile(d, 0.9))


def bars(patches: int, med: float, q90: float) -> dict:
    """PERF.md section 2's bars on a full-protocol cloud, and "ok" when
    all hold."""
    b = {"patches": patches >= MIN_PATCHES, "median": med < MAX_MEDIAN,
         "q90": q90 < MAX_Q90}
    return {**b, "ok": all(b.values())}


def timed_run(data, opt, setup: Setup, dev, graphs=None) -> tuple:
    """One engine run of `setup` on the loaded scene `data`, timed to a
    synchronize; `graphs` as PMVSEngine takes it. Returns the engine and
    the run's patches, seconds, phase seconds, kernel launches and graph
    cache (what it captured; None without graphs)."""
    from ..models.engine import PMVSEngine
    before = launch_counts()
    cached = graphs.stats() if graphs is not None else None
    t0 = time.perf_counter()
    eng = PMVSEngine(data, opt, p_cap=setup.p_cap, log=lambda *a: None,
                     device=dev, graphs=graphs)
    eng.run(**setup.run_kwargs())
    sync(dev)
    dt = time.perf_counter() - t0
    return eng, {"patches": int(eng.cloud.count()), "seconds": dt,
                 "phases": phase_seconds(eng),
                 "launches": launches_since(before),
                 "graphs": eng.graphs.stats_since(cached)
                 if eng.graphs is not None else None}


def cold_and_steady(setup: Setup = FULL, device="cuda",
                    budget_s: float = math.inf, log=lambda *a: None) -> dict:
    """`setup` written as a fresh tree under the temp directory (removed once
    loaded), loaded once and run cold on a fresh graph cache of its own
    (on CUDA), then, if the cold run took at most `budget_s`, steady:
    the steady engine takes the cold engine's graph cache, and the cold
    engine is let go before the steady run starts. Returns the load
    seconds, the cold and the steady run's stats (`timed_run`; steady
    None past the budget) and the surface distance / dscale median and
    q90 of the last run's cloud."""
    from ..models.engine import load_scene
    from ..utils.options import PMVSOptions
    dev = resolve_device(device)
    root = tempfile.mkdtemp(prefix="run_full_")
    t00 = time.perf_counter()

    def stamp(name, r):
        log(f"[{time.perf_counter() - t00:8.1f}s] {name}: {r['patches']} "
            f"patches in {r['seconds']:.2f} s "
            f"({r['patches'] / r['seconds']:.1f}/s) "
            f"{ {k: round(v, 3) for k, v in r['phases'].items()} }")

    try:
        scene = write_tree(root, setup)
        opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
        t0 = time.perf_counter()
        data = load_scene(root, opt, device=dev)
        sync(dev)
        load_seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    from ..models.graphs import RefineGraphs
    eng, cold = timed_run(data, opt, setup, dev, RefineGraphs(dev)
                          if dev.type == "cuda" else None)
    stamp("cold", cold)
    steady = None
    if cold["seconds"] <= budget_s:
        graphs = eng.graphs
        del eng
        eng, steady = timed_run(data, opt, setup, dev, graphs)
        stamp("warm", steady)
    med, q90 = accuracy(scene, eng.cloud)
    return {"load_seconds": load_seconds, "cold": cold, "steady": steady,
            "median": med, "q90": q90}


def run(setup: Setup = FULL, device="cuda", log=print) -> dict:
    """Cold then warm runs of `setup` (`cold_and_steady`); the result line
    as a dict."""
    dev = resolve_device(device)
    r = cold_and_steady(setup, dev, log=log)
    cold, warm = r["cold"], r["steady"]
    return {
        "card": card(dev), "device": str(dev),
        "protocol": (f"occluded scene {setup.num_cameras} x {setup.width}x"
                     f"{setup.height}, mask border {setup.mask_border}, "
                     f"setEdge {setup.set_edge:g}, level 0, csize 2, "
                     f"expand_iters {setup.expand_iters}, max_waves "
                     f"{setup.max_waves}, refine_iters "
                     f"{setup.refine_iters}, p_cap {setup.p_cap}"),
        "load_seconds": r["load_seconds"],
        "patches": warm["patches"], "cold_patches": cold["patches"],
        "cold_seconds": cold["seconds"],
        "steady_seconds": warm["seconds"],
        "patches_per_sec": warm["patches"] / warm["seconds"],
        "cold_phase_seconds": cold["phases"],
        "phase_seconds": warm["phases"],
        "launches": warm["launches"],
        "cold_graphs": cold["graphs"], "graphs": warm["graphs"],
        "median": r["median"], "q90": r["q90"],
        "bars": bars(warm["patches"], r["median"], r["q90"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "run_full.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(FULL, device=args.device)
    line = json.dumps(r)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line)
    return 0 if r["bars"]["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
