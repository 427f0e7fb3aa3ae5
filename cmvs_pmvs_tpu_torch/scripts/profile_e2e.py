"""Per-function and per-filter-sub-pass timing of a whole run.

Port of scripts/profile_e2e.py. Reconstructs a synthetic scene with the
engine (small by default: `make_occluded_scene(8, 192, 144, focal 300)`,
expand_iters 1, max_waves 2, p_cap 30,000, the second of two runs kept;
`--full`: the full protocol of chip_smoke's phase 5, 12 x 640x480, mask
border 8, setEdge 0.4, expand_iters 3, max_waves 12, p_cap 200,000, one
run) with these functions wrapped and timed, each call ending in a
synchronize: seed.seed_discover / seed_commit, expand.expand_discover /
expand_commit, filter.refresh_visibility / run_filters_pre /
run_filters_post / run_filters_tail / count_neighbor_pairs (and the
engine module's own bindings of all but the seed's), as
scripts/profile_e2e.py:66-76 wraps the JAX engine's programs. Because of
those synchronizes the per-function seconds are not the run's: they show
where a run's time goes, not what it costs. A call made while a CUDA
graph is captured (a function inside a program, e.g. refresh_visibility
inside run_filters_pre) is neither timed nor counted: the graph's
replays do not call it. Then it times each filter sub-pass once warm on
the final cloud's alive prefix: refresh_visibility, filter_outside,
filter_exact, filter_neighbor (at the counted pair budget, as
scripts/profile_e2e.py:125-128), filter_small_groups.

`--profile-phase {seed,expand,filter} [...]` captures torch.profiler
around the first instance of each of those engine spans only, and
`--profile-phase run` around the whole run (every instance of every
span; ~340k launches on the full protocol), and prints
`profiling.summarize`'s device ops and busy shares, per nested range:
the timed functions above and process.process_candidates,
process.refine_patches, process.set_vimages and views.grab_masked, which
are marked (record_function) but not timed.

    python -m cmvs_pmvs_tpu_torch.scripts.profile_e2e [--full]
        [--profile-phase seed expand filter | run] [--top 30]
        [--trace-out PREFIX]
        [--device cuda]
"""
from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import shutil
import tempfile
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass

import torch

from ..device import resolve_device
from . import profiling


@dataclass(frozen=True)
class Setup:
    """A synthetic reconstruction: the occluded scene's size, its tree's
    options and the engine's run."""

    num_cameras: int
    width: int
    height: int
    focal: float
    mask_border: int
    set_edge: float
    expand_iters: int
    max_waves: int
    refine_iters: int
    p_cap: int

    def run_kwargs(self) -> dict:
        return dict(expand_iters=self.expand_iters,
                    max_waves=self.max_waves,
                    refine_iters=self.refine_iters)


SMALL = Setup(8, 192, 144, 300.0, 0, 0.0, 1, 2, 8, 30_000)
# the full protocol (PERF.md section 4; bench.py's full stage)
FULL = Setup(12, 640, 480, 700.0, 8, 0.4, 3, 12, 8, 200_000)

# (module, functions) timed: each call synchronized, its seconds summed
FILTER_PROGRAMS = ("refresh_visibility", "run_filters_pre",
                   "run_filters_post", "run_filters_tail",
                   "count_neighbor_pairs")
TIMED = (("models.seed", ("seed_discover", "seed_commit")),
         ("models.expand", ("expand_discover", "expand_commit")),
         ("models.filter", FILTER_PROGRAMS),
         # the engine binds these at import
         ("models.engine", ("expand_discover", "expand_commit",
                            *FILTER_PROGRAMS)))
# (module, functions) marked as profiler ranges only
MARKED = (("models.process", ("process_candidates", "refine_patches",
                              "set_vimages")),
          ("models.views", ("grab_masked",)))


def write_tree(root: str, setup: Setup):
    """The setup's occluded scene as a PMVS tree at `root` with its
    option.txt; returns the scene (its surface_distance is the truth)."""
    from ..utils.synthetic import make_occluded_scene, write_pmvs_tree
    scene = make_occluded_scene(num_cameras=setup.num_cameras,
                                width=setup.width, height=setup.height,
                                focal=setup.focal)
    write_pmvs_tree(scene, root, mask_border=setup.mask_border)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write(f"level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                f"CPU 4\nsetEdge {setup.set_edge:g}\nuseBound 0\n"
                f"useVisData 0\nsequence -1\n"
                f"timages -1 0 {setup.num_cameras}\noimages 0\n")
    return scene


@contextmanager
def wrapped(times: dict, dev: torch.device):
    """Wrap TIMED (seconds and calls into `times[name] = [s, n]`, each
    call synchronized on `dev`) and MARKED (profiler ranges) for the
    duration; restored on exit."""
    saved = []

    def patch(mod, name, timed: bool):
        fn = getattr(mod, name)

        @functools.wraps(fn)
        def wrapper(*a, **k):
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                return fn(*a, **k)
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*a, **k)
                if timed:
                    profiling.sync(dev)
            if timed:
                t = times.setdefault(name, [0.0, 0])
                t[0] += time.perf_counter() - t0
                t[1] += 1
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, wrapper)

    try:
        for group, timed in ((TIMED, True), (MARKED, False)):
            for modname, names in group:
                mod = importlib.import_module(f"..{modname}", __package__)
                for name in names:
                    patch(mod, name, timed)
        yield times
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def filter_subpasses(eng, dev: torch.device) -> dict:
    """Seconds of each filter sub-pass on the engine's final cloud's
    alive prefix, each called once to warm up and then timed
    (synchronized); filter_neighbor at the counted pair budget."""
    from ..models import filter as F
    from ..models.engine import _bucket15
    cams, pyr = eng.scene.cams, eng.scene.pyr
    cfg, thr = eng.cfg, eng.thr
    out = {}

    def timeit(name, fn, *a):
        fn(*a)
        profiling.sync(dev)
        t0 = time.perf_counter()
        res = fn(*a)
        profiling.sync(dev)
        out[name] = time.perf_counter() - t0
        return res

    cl = eng._slice(eng._cap_bucket(int(eng.cloud.count())))
    cloud, grid = timeit("refresh_visibility", F.refresh_visibility, cams,
                         pyr, cfg, thr, cl, eng.grid)
    timeit("filter_outside", F.filter_outside, cams, cfg, thr, cloud, grid)
    timeit("filter_exact", F.filter_exact, cams, pyr, cfg, thr, cloud, grid)
    need = int(F.count_neighbor_pairs(cfg, cloud))
    timeit("filter_neighbor", F.filter_neighbor, cams, cfg, thr, cloud,
           grid, _bucket15(max(need, 1024), 1 << 28))
    timeit("filter_small_groups", F.filter_small_groups, cams, cfg, thr,
           cloud, grid)
    return out


def profile(root: str, setup: Setup, device="cuda", trials: int = 1,
            profile_phases=(), trace_out: str | None = None,
            graphs=None) -> dict:
    """Run the engine on the tree at `root` `trials` times (the last one
    kept), wrapped, with `graphs` as PMVSEngine takes it (None: the
    process's CUDA graphs on the card; a RefineGraphs of the caller's
    own for a fresh cache); then the filter sub-passes. With
    `profile_phases`, the last run captures torch.profiler around each
    such span's first instance, or, for "run" (named alone), around the
    whole run with every span; summaries in ["profile"][phase] and, with
    `trace_out`, chrome traces at <trace_out>.<phase>.json."""
    from ..models.engine import PMVSEngine, load_scene
    from ..utils.options import PMVSOptions
    whole = "run" in profile_phases
    if whole and len(profile_phases) > 1:
        raise ValueError("the 'run' profile holds every span: name it alone")
    dev = resolve_device(device)
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    data = load_scene(root, opt, device=dev)
    for trial in range(trials):
        last = trial == trials - 1
        tracer = profiling.PhaseTracer(profile_phases) \
            if profile_phases and last and not whole else None
        capture = torch.profiler.profile(
            activities=profiling.activities()) if whole and last \
            else nullcontext()
        times = {}
        with wrapped(times, dev), capture as prof:
            t0 = time.perf_counter()
            eng = PMVSEngine(data, opt, p_cap=setup.p_cap,
                             log=lambda *a: None, tracer=tracer,
                             device=dev, graphs=graphs)
            eng.run(**setup.run_kwargs())
            profiling.sync(dev)
            total = time.perf_counter() - t0
    n = int(eng.cloud.count())
    phases = profiling.phase_seconds(eng)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else "cpu", "seconds": total, "patches": n,
           "patches_per_sec": n / total, "functions": times,
           "phases": phases,
           "phase_counts": {k: v.count for k, v in eng.tracer.spans.items()},
           "graphs": eng.graphs.stats() if eng.graphs else None,
           "subpasses": filter_subpasses(eng, dev)}
    if profile_phases:
        if whole:
            profs, evts = {"run": prof}, {"run": profiling.events(prof)}
        else:
            profs, evts = eng.tracer.profs, eng.tracer.events
        missing = set(profile_phases) - set(evts)
        if missing:
            raise RuntimeError(f"the run had no {sorted(missing)} span")
        if trace_out:
            for phase, pr in profs.items():
                pr.export_chrome_trace(f"{trace_out}.{phase}.json")
        out["profile"] = {p: profiling.summarize(evts[p])
                          for p in profile_phases}
    return out


def report(r: dict, top: int = 30) -> str:
    """The run's figures as text."""
    lines = [f"total {r['seconds']:.2f} s, {r['patches']} patches -> "
             f"{r['patches_per_sec']:.0f}/s on {r['device']} (per-function "
             f"seconds below include a synchronize after every call; they "
             f"are not the run's)"]
    for name in sorted(r["functions"]):
        s, n = r["functions"][name]
        lines.append(f"  {name:24s} {s:8.3f} s  x{n}")
    lines.append("phases: " + json.dumps(
        {k: round(v, 3) for k, v in r["phases"].items()}))
    for name, s in r["subpasses"].items():
        lines.append(f"  sub {name:22s} {s * 1000:9.2f} ms")
    for phase, summary in r.get("profile", {}).items():
        lines.append("--- profile of the whole run" if phase == "run"
                     else f"--- profile of the first {phase} span")
        lines.append(profiling.format_summary(summary, top))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="the full protocol scene and run")
    ap.add_argument("--profile-phase", nargs="+", default=(),
                    choices=("seed", "expand", "filter", "run"),
                    help="profile the first span of each phase named, or "
                         "(run, alone) the whole run")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--trace-out", default=None,
                    help="write each phase's chrome trace to "
                         "TRACE_OUT.<phase>.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    setup = FULL if args.full else SMALL
    root = tempfile.mkdtemp(prefix="profile_e2e_")
    try:
        write_tree(root, setup)
        r = profile(root, setup, dev, trials=1 if args.full else 2,
                    profile_phases=args.profile_phase,
                    trace_out=args.trace_out)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(report(r, args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
