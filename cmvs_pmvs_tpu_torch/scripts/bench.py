"""Per-card benchmark: the refine kernel's throughput and the end-to-end
reconstruction, one JSON line per finished stage.

Port of the repository's root bench.py. Its stages:

1. kernel (`bench_kernel`), the headline: patch refinements/s. The plane
   scene (6 views, 640x480, focal 800), a 3-level pyramid and B = 8192
   points on the plane perturbed by +-2 dscale along the reference ray
   (`profile_wave.make_wave`: default_rng(0), drawn in bench.py's
   order); `nwave` = 4 refinements of `num_iters` = 8 LM iterations
   chained, wave k+1 starting from wave k's (coord, normal), all with
   the one problem built from the perturbed start (bench.py:176-188, one
   `jax.jit` of a `lax.scan`). Its counterpart here is one CUDA graph of
   the chain (`chain`, a models/graphs program), captured once after an
   eager warm-up and replayed: refinements/s = B x nwave over the best
   of 5 replays, each ended by a scalar read of the ncc sum (bench.py:
   195-204). The same chain run op by op (`graphs=None`) is timed the
   same way beside it; the replay's output is compared with the op-by-op
   chain's bit for bit; K1's launches are counted per replay (nwave x
   (1 + num_iters): fan 4 on the Jacobian refreshes, fan 1 on Broyden's
   iterations). On the CPU there is no graph: the op-by-op chain is the
   headline and the central-difference LM runs.
2. baseline (`measure_baseline`), the CPU divisor: native/cpu_baseline.cpp
   built with `g++ -O3 -march=native -funroll-loops -std=c++17 -pthread`
   into the build directory at first use and run on 1 thread for 4 s;
   its evals/s x 16 cores / 100 evals a BOBYQA patch, floored at the
   recorded 30,895 patches/s. That constant is a 16-core Xeon estimate
   (BASELINE.md): a CPU's figure, not the card's. `baseline_source` says
   whether the divisor was measured on this host or is the constant.
   `vs_baseline` divides refinements/s by it; `vs_baseline_equal_work`
   divides objective evaluations/s (24 a refinement) by the recorded
   16-core rate.
3. e2e and full (`bench_e2e`, `bench_e2e_full`, `_bench_scene`):
   bench.py's scenes, option text and run arguments (e2e: 8 cameras at
   192x144, focal 300, expand_iters 1, max_waves 2, p_cap 30,000; full:
   `profile_e2e.FULL`, 12 x 640x480, mask border 8, setEdge 0.4,
   expand_iters 3, max_waves 12, p_cap 200,000), each loaded once and
   run twice (`run_full.cold_and_steady`, run_full's own protocol): a
   cold run on a fresh graph cache of its own (not the process's, which
   may hold the scene's graphs already), then a steady run whose engine
   shares the cold engine's CUDA graphs (`graphs=`, as bench.py's two
   engines share the programs jax compiled), unless the cold run
   overran its budget: then the cold run is reported alone
   (`{tag}_steady` false). Keys
   `{tag}_patches`, `_seconds`, `_patches_per_sec`, `_steady`,
   `_phase_seconds` as bench.py's, with the cold run's seconds and
   patches, each run's graph cache (the steady run captures none) and
   the steady run's kernel launches; the surface distance / dscale
   median and q90, and for the full protocol PERF.md section 2's bars
   (`run_full.bars`). The full stage always runs live: bench.py's
   `BENCH_FULL.json` artifact path has no counterpart.
4. scaling: `python -m cmvs_pmvs_tpu_torch.scripts.scaling_curve
   --device cpu` (its own batch of 1024 patches) started as a
   subprocess after the kernel stage, beside
   the scene stages (bench.py:282-327), joined at the end; its curve
   goes into the last line and into `scaling_latest.json` in the build
   directory.

`main` prints the headline line first, then the line again after each
stage with `extra` grown; every line carries the card's name and power
limit. A stage's error is recorded in its line (`{stage}_error`,
compact) and its traceback appended to `bench_errors.log`; the kernel
stage's error ends the run. Partial results go to `bench_partial.json`.
All three files live in the build directory (default build/ at the
checkout's root); the bench writes nothing else. Switches, as bench.py's
(an environment variable or its flag): BENCH_SKIP_E2E (stop after the
headline), BENCH_SKIP_FULL, BENCH_SKIP_SCALING.

bench.py's `enable_compile_cache` (jax's persistent compilation cache)
has no counterpart: the kernel library is built once, named by a hash
of its sources, into build/torch_kernels/ and loaded from there after
(ops/kernels), and a CUDA graph lives as long as its process.

    python -m cmvs_pmvs_tpu_torch.scripts.bench [--device cuda]
        [--build-dir DIR] [--skip-e2e] [--skip-full] [--skip-scaling]
        [--scaling-ranks 1 2 4]

Needs a CUDA device unless `--device cpu` is passed.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from ..device import resolve_device
from ..models.graphs import program
from ..ops.kernels import launch_counts, launches_since
from . import run_full
from .profile_e2e import FULL, Setup
from .scaling_curve import B as SCALING_BATCH

ROOT = Path(__file__).resolve().parents[2]
BUILD = ROOT / "build"
BASELINE_SOURCE = ROOT / "native" / "cpu_baseline.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-std=c++17",
             "-pthread")

# bench.py's constants: 193,092 evals/s a core x 16 cores / 100 evals per
# BOBYQA-converged patch (BASELINE.md)
BASELINE_PATCHES_PER_SEC = 30895.0
BASELINE_CORES = 16
BOBYQA_EVALS_PER_PATCH = 100.0
BASELINE_EVALS_PER_SEC = 193092.0 * BASELINE_CORES
BASELINE_THREADS, BASELINE_SECONDS = 1, 4.0
RECORDED = ("recorded constant: 193,092 evals/s a core x 16 cores / 100 "
            "evals a patch, a 16-core Xeon estimate from BASELINE.md (a "
            "CPU's figure)")
BATCH, NWAVE, NUM_ITERS, REPEATS = 8192, 4, 8, 5
# objective evaluations per refinement at the engine schedule (8 LM
# iterations, BROYDEN_REFRESH 2): the initial 4-probe fan, 4 full fans
# and 4 candidate-only evaluations
EVALS_PER_REFINEMENT = 24.0
# bench.py's scenes: the truncated protocol and the full one
E2E = Setup(8, 192, 144, 300.0, 0, 0.0, 1, 2, 8, 30_000)
BUDGET_S = 420.0   # a scene stage's default budget for its cold run
# main's clock: the full stage's budget is what is left of TOTAL_S less
# a minute; the scaling curve is waited for until SCALING_S
TOTAL_S, SCALING_S = 1500.0, 1680.0

_ANSI_RE = re.compile(r"\x1b\[[0-9;]*[A-Za-z]|\x1b\].*?(\x07|\x1b\\\\)")


def short_error(exc: BaseException, stage: str, build_dir) -> str:
    """`exc` as a compact, escape-free string of at most 200 characters
    for the JSON line; its traceback is appended to bench_errors.log in
    `build_dir`."""
    try:
        with open(os.path.join(build_dir, "bench_errors.log"), "a") as f:
            f.write(f"\n=== {stage} @ {time.strftime('%F %T')} ===\n")
            f.write("".join(traceback.format_exception(exc)))
    except OSError:
        pass
    msg = _ANSI_RE.sub("", f"{type(exc).__name__}: {exc}")
    return "".join(c if c.isprintable() else " " for c in msg)[:200]


def write_json(path, obj):
    """Write `obj` to `path` whole (through a temporary file)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def build_baseline(build_dir) -> str:
    """native/cpu_baseline.cpp built into `build_dir` (again when the
    source is newer); the executable's path."""
    exe = os.path.join(build_dir, "cpu_baseline")
    if (os.path.exists(exe)
            and os.path.getmtime(exe) >= os.path.getmtime(BASELINE_SOURCE)):
        return exe
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ is not on the PATH")
    tmp = f"{exe}.{os.getpid()}.tmp"
    subprocess.run([gxx, *GXX_FLAGS, str(BASELINE_SOURCE), "-o", tmp],
                   check=True, capture_output=True, text=True, timeout=300)
    os.replace(tmp, exe)
    return exe


def measure_baseline(build_dir=BUILD) -> dict:
    """The 16-core CPU divisor: cpu_baseline's single-core evals/s on
    this host x 16 / 100, floored at the recorded constant (a busy host
    must not shrink the divisor), with its source; the recorded constant
    when the microbench cannot be built or run (the reason logged in
    bench_errors.log)."""
    try:
        out = subprocess.run(
            [build_baseline(build_dir), str(BASELINE_THREADS),
             str(BASELINE_SECONDS)], capture_output=True, text=True,
            timeout=60 + BASELINE_SECONDS, check=True)
        eps = float(json.loads(out.stdout)["evals_per_sec"])
    except (OSError, ValueError, KeyError,
            subprocess.SubprocessError) as e:
        return {"baseline_patches_per_sec_16core": BASELINE_PATCHES_PER_SEC,
                "baseline_source": f"{RECORDED}; cpu_baseline not run: "
                                   f"{short_error(e, 'baseline', build_dir)}",
                "baseline_host_evals_per_sec": None}
    pps = eps * BASELINE_CORES / BOBYQA_EVALS_PER_PATCH
    if pps < BASELINE_PATCHES_PER_SEC:
        source = (f"{RECORDED}; this host measured {pps:.1f} patches/s, "
                  f"below it")
    else:
        source = (f"measured on this host: cpu_baseline, "
                  f"{BASELINE_THREADS} thread, {eps:.1f} evals/s x "
                  f"{BASELINE_CORES} cores / {BOBYQA_EVALS_PER_PATCH:g} "
                  f"evals a patch")
    return {"baseline_patches_per_sec_16core": max(
                pps, BASELINE_PATCHES_PER_SEC),
            "baseline_source": source, "baseline_host_evals_per_sec": eps}


@program(scene=3, static=("nwave", "num_iters"))
def chain(cams, pyr, prob, coord, normal, nwave: int = NWAVE,
          num_iters: int = NUM_ITERS):
    """`nwave` refinements chained, each from the last one's (coord,
    normal), all of one problem: (coord, normal, ncc [nwave, B])."""
    from ..ops.refine import refine_patches
    nccs = []
    for _ in range(nwave):
        coord, normal, ncc, _ = refine_patches(cams, pyr, 0, 7, prob, coord,
                                               normal, num_iters=num_iters)
        nccs.append(ncc)
    return coord, normal, torch.stack(nccs)


def best_of(call, repeats: int):
    """(fastest seconds of `repeats` calls, each ended by a scalar read
    of its ncc sum, the last call's output)."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = call()
        float(out[2].sum())
        best = min(best, time.perf_counter() - t0)
    return best, out


def bench_kernel(batch: int = BATCH, nwave: int = NWAVE,
                 num_iters: int = NUM_ITERS, device="cuda", wave=None,
                 repeats: int = REPEATS) -> dict:
    """The chained refinements' rates, graphed (CUDA) and op by op, K1's
    launches and the replay's agreement with the op-by-op chain."""
    from ..models.graphs import RefineGraphs
    from ..ops.fan2 import incc_fan
    from .profile_wave import make_wave
    dev = resolve_device(device)
    w = wave if wave is not None else make_wave(batch, device=dev)
    batch = w.coord0.shape[0]
    k1 = incc_fan.entries[w.pyr.atlas_k.dtype].name

    def run(graphs=None):
        return chain(w.cams, w.pyr, w.prob, w.coord0, w.normal, nwave=nwave,
                     num_iters=num_iters, graphs=graphs)

    float(run()[2].sum())                        # warm-up
    before = launch_counts()
    eager_s, eager = best_of(run, repeats)
    out = {"batch": batch, "nwave": nwave, "num_iters": num_iters,
           "k1_expected": nwave * (1 + num_iters),
           "eager_refinements_per_sec": batch * nwave / eager_s,
           "eager_seconds": eager_s,
           "k1_launches_per_eager_chain":
               launches_since(before).get(k1, 0) / repeats,
           "graphed_refinements_per_sec": None, "graph_seconds": None,
           "k1_launches_first_graph_call": None,
           "k1_launches_per_replay": None, "replay_equals_eager": None,
           "graph": None}
    if dev.type == "cuda":
        graphs = RefineGraphs(dev)
        before = launch_counts()
        float(run(graphs)[2].sum())              # warm-up, then capture
        first = launches_since(before).get(k1, 0)
        before = launch_counts()
        graph_s, replayed = best_of(lambda: run(graphs), repeats)
        out.update(
            graphed_refinements_per_sec=batch * nwave / graph_s,
            graph_seconds=graph_s, k1_launches_first_graph_call=first,
            k1_launches_per_replay=launches_since(before).get(k1, 0)
            / repeats,
            replay_equals_eager=all(torch.equal(a, b)
                                    for a, b in zip(replayed, eager)),
            graph=graphs.stats())
    out["refinements_per_sec"] = (out["graphed_refinements_per_sec"]
                                  or out["eager_refinements_per_sec"])
    return out


def _bench_scene(tag: str, setup: Setup, budget_s: float, device="cuda"
                 ) -> dict:
    """A cold run, then, if it took at most `budget_s`, a steady run on
    the same loaded scene sharing the cold engine's graph cache
    (`run_full.cold_and_steady`); the {tag}_* stats."""
    r = run_full.cold_and_steady(setup, device, budget_s)
    cold, steady = r["cold"], r["steady"]
    out = {f"{tag}_cold_patches": cold["patches"],
           f"{tag}_cold_seconds": cold["seconds"],
           f"{tag}_cold_graphs": cold["graphs"]}
    if steady is not None:
        out.update({
            f"{tag}_patches_per_sec": steady["patches"] / steady["seconds"],
            f"{tag}_phase_seconds": steady["phases"],
            f"{tag}_graphs": steady["graphs"],
            f"{tag}_launches": steady["launches"]})
    rep = steady if steady is not None else cold  # past the budget: cold
    return {**out, f"{tag}_patches": rep["patches"],
            f"{tag}_seconds": rep["seconds"],
            f"{tag}_steady": steady is not None,
            f"{tag}_median": r["median"], f"{tag}_q90": r["q90"]}


def bench_e2e(budget_s: float = BUDGET_S, device="cuda") -> dict:
    """The truncated-protocol scene (bench.py's e2e stage)."""
    return _bench_scene("e2e", E2E, budget_s, device)


def bench_e2e_full(budget_s: float = BUDGET_S, device="cuda") -> dict:
    """The full reference protocol (bench.py's full stage), with PERF.md
    section 2's bars on the reported run."""
    r = _bench_scene("full", FULL, budget_s, device)
    r["full_bars"] = run_full.bars(r["full_patches"], r["full_median"],
                                   r["full_q90"])
    return r


def launch_scaling(ranks, build_dir):
    """Start scaling_curve on the CPU in a process of its own, at
    SCALING_BATCH patches; None (the reason logged) if it cannot start."""
    cmd = [sys.executable, "-m", "cmvs_pmvs_tpu_torch.scripts.scaling_curve",
           "--device", "cpu", "--ranks", *map(str, ranks),
           "--batch", str(SCALING_BATCH)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    try:
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
    except OSError as e:
        short_error(e, "scaling-launch", build_dir)
        return None


def collect_scaling(proc, timeout_s: float, build_dir) -> dict:
    """Join the scaling subprocess: {"scaling": its curve}, also written
    to scaling_latest.json in `build_dir`, or {"scaling_error": ...}."""
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        proc.kill()
        proc.communicate()
        return {"scaling_error": short_error(e, "scaling", build_dir)}
    for ln in reversed(out.strip().splitlines()):
        try:
            res = json.loads(ln)
        except ValueError:
            continue
        write_json(os.path.join(build_dir, "scaling_latest.json"),
                   {"timestamp": time.strftime("%F %T"), **res})
        return {"scaling": res}
    return {"scaling_error": short_error(
        RuntimeError(f"scaling_curve exited {proc.returncode} with no JSON "
                     f"line: {err.strip()[-400:]}"), "scaling", build_dir)}


def bench(device="cuda", build_dir=BUILD, skip_e2e: bool = False,
          skip_full: bool = False, skip_scaling: bool = False,
          scaling_ranks=(1, 2, 4), emit=print) -> dict:
    """Every stage in bench.py's order, the kernel stage at BATCH, NWAVE
    and NUM_ITERS as bench.py's; `emit` gets the headline line, then the
    line again after each stage. Returns the last line."""
    dev = resolve_device(device)
    build_dir = str(build_dir)
    os.makedirs(build_dir, exist_ok=True)
    partial = os.path.join(build_dir, "bench_partial.json")
    t_start = time.perf_counter()
    baseline = measure_baseline(build_dir)
    k = bench_kernel(BATCH, NWAVE, NUM_ITERS, dev)
    pps, base = k.pop("refinements_per_sec"), \
        baseline["baseline_patches_per_sec_16core"]
    line = {"metric": "patch_refinements_per_sec_per_chip", "value": pps,
            "unit": "patches/s", "vs_baseline": pps / base,
            # both bases: refinements (crediting the LM schedule's 24
            # evaluations against BOBYQA's ~100) and equal work
            "vs_baseline_equal_work": pps * EVALS_PER_REFINEMENT
            / BASELINE_EVALS_PER_SEC,
            **baseline, "card": run_full.card(dev), "device": str(dev),
            "kernel": k}

    def publish(obj):
        emit(obj)
        write_json(partial, obj)
        return obj

    last = publish(line)
    if skip_e2e:
        return last
    # the curve runs on the host's CPU, beside the scene stages
    scaling = None if skip_scaling else launch_scaling(
        scaling_ranks, build_dir)
    extra: dict = {}
    try:
        extra.update(bench_e2e(device=dev))
    except Exception as e:       # the headline is never lost
        extra["e2e_error"] = short_error(e, "e2e", build_dir)
    last = publish({**line, "extra": dict(extra)})
    if not skip_full:
        budget = TOTAL_S - (time.perf_counter() - t_start) - 60.0
        try:
            extra.update(bench_e2e_full(budget_s=budget, device=dev))
        except Exception as e:
            extra["full_error"] = short_error(e, "full", build_dir)
        last = publish({**line, "extra": dict(extra)})
    if scaling is not None:
        extra.update(collect_scaling(
            scaling, max(30.0, SCALING_S - (time.perf_counter() - t_start)),
            build_dir))
        last = publish({**line, "extra": dict(extra)})
    return last


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--build-dir", default=str(BUILD),
                    help="where the bench writes (default: build/)")
    env = os.environ.get
    ap.add_argument("--skip-e2e", action="store_true",
                    default=bool(env("BENCH_SKIP_E2E")),
                    help="stop after the headline (BENCH_SKIP_E2E)")
    ap.add_argument("--skip-full", action="store_true",
                    default=bool(env("BENCH_SKIP_FULL")),
                    help="no full-protocol stage (BENCH_SKIP_FULL)")
    ap.add_argument("--skip-scaling", action="store_true",
                    default=bool(env("BENCH_SKIP_SCALING")),
                    help="no scaling curve (BENCH_SKIP_SCALING)")
    ap.add_argument("--scaling-ranks", type=int, nargs="+",
                    default=[1, 2, 4])
    args = ap.parse_args(argv)
    bench(args.device, args.build_dir, args.skip_e2e, args.skip_full,
          args.skip_scaling, args.scaling_ranks,
          emit=lambda obj: print(json.dumps(obj), flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
