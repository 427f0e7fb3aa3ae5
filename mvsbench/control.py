"""Readings for the check's limits, over many seeds in one process.

    python3 -m mvsbench.control --workload <cell> --seeds 11 12 13 ... \
        [--fault unchanged --fault-seeds 21 22 23]

For each seed it renders the cell's first scene, reconstructs it with
the cell's per-job callable as the window does (one card, or every rank
of the engine mesh; on the process's graph cache, so only the first
seed captures), and prints one JSON line with the program's
numbers (check.numbers: the lower readings) and the control's
(check.control: the reference computed in bfloat16, the nearest
precision below the float32 the program computes in, put in the
program's place: the upper readings), each with check.verdict's
`correct` under the cell's limits. With `--fault` it then plants that
fault (faults.py) and prints the program's numbers and verdict on each
of `--fault-seeds`. The benchmark's own runs never run it. Needs a card,
as the benchmark does.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import torch

from mvsbench import check, faults, manifest, run


def readings(root: str, workload: str, seeds, device="cuda",
             dtype=torch.bfloat16, fault=None):
    """Yield (seed, program's numbers, control's numbers or None) for
    each seed; with `fault` (a faults.py callable) the program runs
    broken by it and no control is read. Each job is the cell's per-job
    callable (run.runner): on a cell of several cards the ranks live for
    the whole call and the fault is planted in each of them too."""
    from cmvs_pmvs_tpu_torch.models import engine as E
    device = torch.device(device)
    cell = manifest.cell(root, workload)
    level = cell.traffic["level"]
    samples = cell.traffic["check"]
    undo = fault() if fault is not None else None
    store = tempfile.mkdtemp(prefix="mvsbench-control-")
    ranks = None
    try:
        job, ranks = run.runner(cell, E, device, run.quiet,
                                cell.traffic.get("reconstruct", {}), store,
                                fault)
        for seed in seeds:
            workdir = tempfile.mkdtemp(prefix="mvsbench-control-")
            try:
                label, sc, tr = run.render_scenes(cell, seed, device,
                                                  workdir)[0]
                rec, seconds = job(label, tr)
                out = check.outputs(rec.pop("engine"))
                files = check.read_files(tr)
                prog = check.numbers(sc, cell.config, level, out, files,
                                     seed, samples, device)
                ctrl = None if fault is not None else check.control(
                    sc, cell.config, level, files, seed, samples, device,
                    dtype)
                yield seed, {**prog, "seconds": seconds}, ctrl
            finally:
                shutil.rmtree(workdir, ignore_errors=True)
    finally:
        if ranks is not None:
            ranks.stop()
        shutil.rmtree(store, ignore_errors=True)
        if undo is not None:
            undo()


def judged(nums: dict, limits: dict) -> dict:
    """The numbers with check.verdict's `correct` under `limits`."""
    return {**nums, "correct": check.verdict([nums], limits)[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=())
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mvsbench.control: no CUDA device", file=sys.stderr)
        return 2
    run.cache_env(run.ROOT)
    limits = manifest.cell(run.ROOT, args.workload).limits
    t0 = time.time()
    runs = [(None, args.seeds)]
    if args.fault:
        runs.append((args.fault, args.fault_seeds))
    for name, seeds in runs:
        fault = faults.FAULTS[name] if name else None
        for seed, prog, ctrl in readings(run.ROOT, args.workload, seeds,
                                         fault=fault):
            line = {"workload": args.workload, "seed": seed,
                    "program": judged(prog, limits),
                    "elapsed_s": time.time() - t0}
            if name:
                line["fault"] = name
            else:
                line["control"] = judged(ctrl, limits)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
