"""Run one cell of the benchmark once.

    python3 -m mvsbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up renders the cell's two scenes on the
card from the seed (scene.py), writes them as PMVS trees under a
temporary directory (tree.py) and reconstructs each once, cold, as a
fresh `pmvs3` process does (the CUDA graphs are captured then). The
window then runs whole jobs back to back, alternating the scenes, until
the job running at `--seconds` completes (with the traffic's
`whole_pairs`, until the first A/B pair that completes at or after it).
After the window the last job of each scene is checked against the
plain reference (check.py, reference.py).

A job is the cell's per-job callable, `job(label, tree) -> (record,
seconds)`, the one place where a launch shape plugs in: on one card
`one_reconstruction`, a whole
`cmvs_pmvs_tpu_torch.models.engine.reconstruct` call ending in a device
synchronize; on a cell of several cards `mesh.Ranks.job`, the same call
on every rank of the port's engine mesh, this process rank 0. Set-up,
the window, the outputs, the check and the result line are the same
for both.

With `--trace 1` the window runs under torch.profiler (on a mesh every
rank profiles its window jobs), `load_scene` and `PMVSEngine.write` are
timed from here, and on one card, after the window, one more
reconstruction runs op by op (`graphs=False`) with the K1 and K2
wrappers' launch capture hooked to count each launch's work
(roofline.Counter). Every metric is read by its own reader
(mvsbench/metrics/<name>.py) from the run's context.

The last line of standard output is the result: `correct`, `attempted`,
`failed`, `metrics`, `device` (with `--trace 1` also `busy_s`,
`window_s`), with `--trace 1` a `breakdown`, `diagnostics` (the window's
length, graph captures and drops inside it, the checked jobs' patch
counts; traced: what bounds K1 and K2) and last `compared`, each
compared number beside its limit, which the last lines of standard
error repeat. Without a card, or with fewer
than the cell needs, it exits 2 and prints no result; it exits 3 if the
JAX package or JAX is loaded once the window has closed.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "cmvs_pmvs_tpu")


def cache_env(root: str):
    """Keep every build and kernel cache at a fixed path inside the
    checkout (the port's kernels build into build/torch_kernels/ there
    by themselves)."""
    base = os.path.join(root, "build", "mvsbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


import torch  # noqa: E402

from mvsbench import (check, manifest, profiling, readers,  # noqa: E402
                      roofline, tree)
from mvsbench import scene as S  # noqa: E402

K1 = "incc_fan"       # ops/fan2.incc_fan on a byte atlas
K2 = "windows"        # ops/windows.windows, blocked, byte atlas


def loaded_forbidden() -> list[str]:
    """Top-level names of the loaded modules that are JAX's or the JAX
    package's (compared whole: the port's name begins with the JAX
    package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> str | None:
    """The first card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def quiet(*parts):
    """The engine's log: its lines are not printed (the last line of
    standard output is the result)."""


@contextlib.contextmanager
def timed_layers(engine_mod, spans: dict):
    """Time `load_scene` and `PMVSEngine.write` from here: each call's
    seconds (ending in a device synchronize) are added to spans["load"]
    / spans["write"] and run inside a record_function range of that
    name."""
    load, write = engine_mod.load_scene, engine_mod.PMVSEngine.write

    def wrap(fn, name):
        def call(*args, **kwargs):
            t = time.perf_counter()
            with torch.profiler.record_function("mvsbench." + name):
                out = fn(*args, **kwargs)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t
            return out
        return call

    engine_mod.load_scene = wrap(load, "load")
    engine_mod.PMVSEngine.write = wrap(write, "write")
    try:
        yield
    finally:
        engine_mod.load_scene = load
        engine_mod.PMVSEngine.write = write


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_scenes(cell, seed: int, device, workdir: str) -> list:
    """The cell's two scenes (the seed's textures and another's, the
    same cameras and object), each written as a PMVS tree under
    `workdir`: [(label, scene, tree root)]."""
    c, a = cell.config, cell.config["assumed"]
    out = []
    for label, tex in (("A", seed), ("B", seed + S.SECOND_TEXTURES)):
        sc = S.render(c["views"], c["width"], c["height"], a["focal"],
                      a["ring_radius"], a["ring_height"], tex, device,
                      boxes=a["boxes"])
        root = os.path.join(workdir, label)
        tree.write_tree(root, sc.P, sc.images, c["options"],
                        cell.traffic["level"])
        out.append((label, sc, root))
    return out


def one_reconstruction(engine_mod, root: str, device, log, **kwargs):
    """One whole pmvs3 job: `reconstruct` on the tree (`kwargs` the
    traffic's `reconstruct` arguments; none: its defaults), then a device
    synchronize; returns (engine, seconds)."""
    t = time.perf_counter()
    eng = engine_mod.reconstruct(root, tree.OPTION, log=log, device=device,
                                 **kwargs)
    sync(device)
    return eng, time.perf_counter() - t


def one_job(engine_mod, device, log, args: dict):
    """The one-card cells' per-job callable: `one_reconstruction` of a
    scene's tree; the record holds the engine."""
    def job(label: str, root: str):
        eng, seconds = one_reconstruction(engine_mod, root, device, log,
                                          **args)
        return {"engine": eng}, seconds
    return job


def runner(cell, engine_mod, device, log, args: dict, workdir: str,
           faults=None, lost=None):
    """(the cell's per-job callable, its mesh.Ranks or None): one card,
    or the harness as rank 0 of `cell.chips` ranks (`faults` planted in
    each spawned rank, `lost` as mesh.Ranks takes it)."""
    if cell.chips == 1:
        return one_job(engine_mod, device, log, args), None
    from mvsbench import mesh
    ranks = mesh.Ranks(cell.chips, device, workdir, args, fault=faults,
                       lost=lost)
    return ranks.job, ranks


def lost_result(cell, device):
    """`lost` for mesh.Ranks: print the result line of a run whose ranks
    fell out of step inside a job (`correct` false, no metrics)."""
    def report(reason: str, attempted: int, failed: int):
        info = device_info(device, cell.chips)
        info["memory_peak_bytes"] = torch.cuda.max_memory_reserved(device) \
            if device.type == "cuda" else 0
        print(json.dumps({"correct": False, "attempted": attempted,
                          "failed": failed, "metrics": {}, "device": info,
                          "diagnostics": {"lost": reason},
                          "compared": {}}), flush=True)
    return report


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", t0: float | None = None,
             faults=None) -> dict:
    """One run of the cell `workload`: set-up, the window, the check;
    returns the result object. `faults`, for the benchmark's own tests,
    is a callable run once set-up has loaded the program (it may break
    the program underneath, and returns an undo callable); on a mesh it
    also runs in every spawned rank."""
    t0 = T0 if t0 is None else t0
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    cuda = device.type == "cuda"
    bench = manifest.load(root)
    cell = manifest.cell(root, workload, bench)
    torch.set_num_threads(4)
    from cmvs_pmvs_tpu_torch.models import engine as E
    from cmvs_pmvs_tpu_torch.models import graphs as G
    from cmvs_pmvs_tpu_torch.ops import kernels

    undo = faults() if faults is not None else None
    args = cell.traffic.get("reconstruct", {})
    pairs = bool(cell.traffic.get("whole_pairs"))
    workdir = tempfile.mkdtemp(prefix="mvsbench-")
    log = quiet
    ctx = {"cell": cell.name, "trace": trace}
    ranks = None
    try:
        scenes = render_scenes(cell, seed, device, workdir)
        job, ranks = runner(cell, E, device, log, args, workdir, faults,
                            lost_result(cell, device))
        cold, setup_peak = {}, 0
        for label, _, tr in scenes:
            try:
                rec, cold[label] = job(label, tr)
                setup_peak = max(setup_peak, rec.get("peak", 0))
            except Exception as err:    # set-up failed: not correct
                ctx["setup_failed"] = True
                print(f"cold reconstruction {label} failed: {err!r}",
                      file=sys.stderr)
        rec = None
        if "A" in cold:
            ctx["cold_recon_s"] = cold["A"]
        cache = G.shared(device) if cuda else None
        stats0 = cache.stats() if cache is not None else None
        setup_peak = max(setup_peak, torch.cuda.max_memory_reserved(device)
                         if cuda else 0)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)

        # ---- the window ----
        spans: dict = {}
        recs, kept, failed = [], {}, 0
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) \
            if trace and cuda else None
        layers = timed_layers(E, spans) if trace \
            else contextlib.nullcontext()
        window = ranks.window(trace) if ranks is not None \
            else contextlib.nullcontext()
        ctx["setup_s"] = time.time() - t0
        with layers, window, (prof if prof is not None
                              else contextlib.nullcontext()):
            with torch.profiler.record_function("mvsbench.window"):
                start = time.perf_counter()
                i = 0
                while True:
                    label, _, tr = scenes[i % 2]
                    before = dict(spans)
                    i += 1
                    try:
                        with torch.profiler.record_function(
                                "mvsbench.recon." + label):
                            rec, s = job(label, tr)
                        eng = rec.pop("engine")
                        kept[label] = eng
                        recs.append({
                            "scene": label, "seconds": s,
                            "engine_spans": eng.tracer.report(),
                            **{k: spans.get(k, 0.0) - before.get(k, 0.0)
                               for k in ("load", "write")}, **rec})
                    except Exception as err:   # a failed job: counted
                        failed += 1
                        print(f"reconstruction {i - 1} failed: {err!r}",
                              file=sys.stderr)
                        if getattr(err, "final", False):
                            break
                    if time.perf_counter() - start >= seconds and \
                            not (pairs and i % 2):
                        break
                end = time.perf_counter()
        ctx.update(window_s=end - start, attempted=i, failed=failed,
                   recons=recs)
        ctx["peak_reserved"] = max(
            [torch.cuda.max_memory_reserved(device) if cuda else 0]
            + [r.get("peak", 0) for r in recs])
        ctx["memory_peak_bytes"] = max(setup_peak, ctx["peak_reserved"])
        if cache is not None:
            st = cache.stats_since(stats0)
            ctx["window_captures"] = st["captured"]
            ctx["window_drops"] = st["dropped"] - stats0["dropped"]
        if prof is not None:
            ctx["events"] = profiling.events(prof)
            del prof
        if ranks is not None:
            ctx["rank_busy_us"] = ranks.busy_us()
            ranks.stop()

        # ---- the outputs, then the program's state freed ----
        marks = [("window", time.perf_counter())]
        outs = {label: check.outputs(eng) for label, eng in kept.items()}
        files = {label: check.read_files(tr) for label, _, tr in scenes
                 if label in outs}
        kept.clear()
        eng = rec = None
        gc.collect()
        if cache is not None:
            cache.clear()
        if trace and cuda and cell.chips == 1:
            ctx["kernel_work"] = count_work(E, kernels, scenes[0][2],
                                            device, log, args)
            gc.collect()
            torch.cuda.empty_cache()
        marks.append(("outputs_and_work", time.perf_counter()))
        if undo is not None:
            undo()
            undo = None

        # ---- the check ----
        nums = [check.numbers(sc, cell.config, cell.traffic["level"],
                              outs[label], files[label], seed,
                              cell.traffic["check"], device)
                for label, sc, _ in scenes if label in outs]
        correct, compared = check.verdict(nums, cell.limits) if nums \
            else (False, {})
        ctx["checked"] = nums
        marks.append(("check", time.perf_counter()))
        ctx["phase_s"] = {name: round(t - marks[i][1], 3)
                          for i, (name, t) in enumerate(marks[1:])}
    finally:
        if ranks is not None:
            ranks.stop()
        shutil.rmtree(workdir, ignore_errors=True)
        if undo is not None:
            undo()

    return assemble(root, cell, ctx, trace, device, cell.chips, correct,
                    compared)


def assemble(root: str, cell, ctx: dict, trace: bool, device, count: int,
             correct: bool, compared: dict) -> dict:
    """The result object of a run from its context: each metric of the
    cell read by its reader, the device, the traced window's breakdown,
    and the compared numbers last."""
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(root, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct and ctx["failed"] == 0
                              and not ctx.get("setup_failed")
                              and ctx["recons"]),
              "attempted": ctx["attempted"], "failed": ctx["failed"],
              "metrics": metrics, "device": device_info(device, count)}
    result["device"]["memory_peak_bytes"] = ctx["memory_peak_bytes"]
    span = readers.window(ctx)
    if trace and span is not None:
        lo, hi = span
        # averaged over the cards: rank 0's busy time, the other ranks'
        busy = profiling.busy_us(ctx["events"], lo, hi)
        others = ctx.get("rank_busy_us", [])
        busy = (busy + sum(others)) / (1 + len(others))
        result["device"].update(busy_s=busy / 1e6, window_s=(hi - lo) / 1e6)
        result["breakdown"] = {
            "device_ops": profiling.top_ops(ctx["events"], lo, hi),
            "idle_gaps": profiling.idle_gaps(ctx["events"], lo, hi)}
    result["diagnostics"] = {
        k: ctx[k] for k in ("window_s", "cold_recon_s", "window_captures",
                            "window_drops", "phase_s") if k in ctx}
    result["diagnostics"]["patches"] = [n["patches"]
                                        for n in ctx.get("checked", [])]
    if "kernel_work" in ctx:
        result["diagnostics"]["bound_by"] = {
            k: c.bound_by() for k, c in ctx["kernel_work"].items()}
    result["compared"] = compared
    return result


def count_work(engine_mod, kernels, root: str, device, log,
               args: dict) -> dict:
    """One op-by-op reconstruction of the tree under `root` with K1's
    and K2's launch capture hooked: each launch's bound (roofline.Counter)
    by kernel."""
    kernels.entries()
    counters = {K1: roofline.Counter(K1), K2: roofline.Counter(K2)}
    saved = {k: kernels.ENTRIES[k].capture for k in counters}
    try:
        for k, c in counters.items():
            kernels.ENTRIES[k].capture = c
        eng, _ = one_reconstruction(engine_mod, root, device, log,
                                    **{**args, "graphs": False})
        del eng
    finally:
        for k, c in saved.items():
            kernels.ENTRIES[k].capture = c
    return counters


def device_info(device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "power_limit": power_limit()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    if not torch.cuda.is_available():
        print("mvsbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    cell = manifest.cell(ROOT, args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"mvsbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"mvsbench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
