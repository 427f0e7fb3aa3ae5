"""Rank jobs for `launch.RankPool`: the port's multi-rank paths driven
from a parent process (the tests on the CPU, chip_smoke.py on the card).

Each job is a module-level function `job(device, ...)` that runs on
every rank of a fresh process group and returns picklable results
(numpy arrays, numbers, dicts). Jobs count the kernels they launch: the
wrappers' counters are zeroed just before the work and read just after.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import importlib.util
import os
import sys
import time

import torch
import torch.distributed as dist

_QUIET = dict(log=lambda *a: None)
PORT = __name__.rsplit(".", 2)[0]


def port(tree: str | None = None):
    """The port's package: this one, or with `tree` the copy in that
    checkout, imported under a name of its own (the port's modules import
    one another relatively), so that one rank process can run two
    checkouts' engines one after the other."""
    if tree is None or os.path.samefile(tree, os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))))):
        return importlib.import_module(PORT)
    path = os.path.join(os.path.abspath(tree), PORT)
    name = f"{PORT}_{hashlib.sha256(path.encode()).hexdigest()[:8]}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(path, "__init__.py"),
            submodule_search_locations=[path])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return sys.modules[name]


def _mod(pkg, name: str):
    """The module `name` (dotted, under the package) of `pkg` (None:
    this port)."""
    return importlib.import_module(f"{(pkg or port()).__name__}.{name}")


def _wrappers(pkg=None):
    return _mod(pkg, "ops.kernels").entries()


def _zero_launches(pkg=None, peak: bool = True):
    for w in _wrappers(pkg).values():
        w.launches = 0
    _mod(pkg, "parallel.comm").STAGED.clear()
    if peak and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def _report(dev, t0, pkg=None) -> dict:
    peak = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
    return {"seconds": time.time() - t0, "backend": dist.get_backend(),
            "staged": dict(_mod(pkg, "parallel.comm").STAGED),
            "peak_gb": peak,
            "launches": {k: w.launches for k, w in _wrappers(pkg).items()}}


@contextlib.contextmanager
def engine_probe(pkg=None):
    """While open, `PMVSEngine.run` and `PMVSEngine._filter_round` of
    `pkg` (None: this port) are wrapped so that the dict this yields
    records each run's wall seconds ("run_seconds") and each filter
    round's prefix rows and kernel launches ("filter_rounds"); both are
    restored on exit. The rank processes are the job's own, so the wrap
    reaches every engine the job makes, `reconstruct`'s included."""
    cls = _mod(pkg, "models.engine").PMVSEngine
    kernels = _mod(pkg, "ops.kernels")
    run, filter_round = cls.run, cls._filter_round
    rec = {"run_seconds": [], "filter_rounds": []}

    def timed_run(self, *args, **kwargs):
        t0 = time.time()
        try:
            return run(self, *args, **kwargs)
        finally:
            rec["run_seconds"].append(time.time() - t0)

    def counted_round(self, it, n_alive, stats):
        before = kernels.launch_counts()
        filter_round(self, it, n_alive, stats)
        rec["filter_rounds"].append(
            {"rows": self._cap_bucket(n_alive),
             "launches": kernels.launches_since(before)})

    cls.run, cls._filter_round = timed_run, counted_round
    try:
        yield rec
    finally:
        cls.run, cls._filter_round = run, filter_round


def cloud_digest(cloud) -> str:
    """sha256 over every field of a PatchCloud, all rows."""
    h = hashlib.sha256()
    for f in dataclasses.fields(cloud):
        h.update(getattr(cloud, f.name).cpu().contiguous().numpy()
                 .tobytes())
    return h.hexdigest()


def state_digests(eng) -> dict:
    """sha256 of each field of an engine's cloud and grid, all rows, by
    "cloud.<field>" / "grid.<field>"."""
    return {f"{label}.{f.name}": hashlib.sha256(
        getattr(o, f.name).cpu().contiguous().numpy().tobytes()).hexdigest()
        for label, o in (("cloud", eng.cloud), ("grid", eng.grid))
        for f in dataclasses.fields(o)}


def resume_job(dev, root: str, option: str, ckpt: str, p_cap: int,
               run_kwargs: dict) -> dict:
    """A checkpoint (`PMVSEngine.save_checkpoint`, one rank's or a
    mesh's) resumed by the data-parallel engine: on every rank a
    PMVSEngine on the scene at `root` under `make_engine_mesh()` loads
    `ckpt` and runs `run_kwargs` from the checkpoint's iteration, on the
    process's graph cache (given back after). Returns the iteration, the
    state's field digests (`state_digests`), count, capacity, stats,
    launches and seconds; rank 0 also the alive rows' coord and
    dscale."""
    from ..models.engine import PMVSEngine, load_scene
    from ..models.graphs import shared
    from ..utils.options import PMVSOptions
    from .engine_shard import make_engine_mesh
    mesh = make_engine_mesh()
    opt = PMVSOptions.parse(os.path.join(root, option))
    eng = PMVSEngine(load_scene(root, opt, device=dev), opt, p_cap=p_cap,
                     device=dev, mesh=mesh, **_QUIET)
    try:
        it = eng.load_checkpoint(ckpt)
        _zero_launches()
        t0 = time.time()
        eng.run(start_iter=it, **run_kwargs)
        out = _report(dev, t0)
        alive = eng.cloud.alive.cpu().numpy()
        out.update(iteration=it, state=state_digests(eng),
                   count=int(alive.sum()), p_cap=eng.p_cap, stats=eng.stats)
        if mesh.patch == 0:
            out.update(coord=eng.cloud.coord.cpu().numpy()[alive],
                       dscale=eng.cloud.dscale.cpu().numpy()[alive])
        return out
    finally:
        if dev.type == "cuda":
            shared(dev).clear()


def mesh_job(dev, view_parallel: int) -> dict:
    """This rank's (patch, view) mesh place and its groups' ranks."""
    from .sharding import make_mesh
    m = make_mesh(view_parallel)
    return {"shape": m.shape, "patch": m.patch, "view": m.view,
            "patch_ranks": dist.get_process_group_ranks(m.patch_group),
            "view_ranks": dist.get_process_group_ranks(m.view_group)}


def refine_step_job(dev, scene: dict, batch: dict, view_parallel: int,
                    step_args: dict) -> dict:
    """`sharding.sharded_refine_step` on a (world / view_parallel,
    view_parallel) mesh: cameras and pyramids built here from `scene`'s
    projections and images, the full batch on every rank."""
    from ..geom.cameras import build_camera_set
    from ..image.pyramid import build_pyramids
    from .sharding import make_mesh, shard_views, sharded_refine_step
    cams = build_camera_set(scene["P"], device=dev)
    pyr = build_pyramids(list(scene["images"]), None,
                         num_levels=scene["num_levels"], device=dev)
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    mesh = make_mesh(view_parallel)
    step = sharded_refine_step(mesh, cams, pyr, **step_args)
    vs, vv = shard_views(b["views"], b["valid"], view_parallel)
    _zero_launches()
    t0 = time.time()
    coord, normal, ncc, dmap = step(b["coord"], b["normal"], vs, vv,
                                    b["dscale"], b["active"])
    out = _report(dev, t0)
    out.update(coord=coord.cpu().numpy(), normal=normal.cpu().numpy(),
               ncc=ncc.cpu().numpy(), dmap=dmap.cpu().numpy())
    return out


def engine_job(dev, root: str, option: str, p_cap: int, run_kwargs: dict,
               runs: tuple = ("cold",), tree: str | None = None) -> dict:
    """The data-parallel engine, `reconstruct(root, option, mesh=
    make_engine_mesh())`, on every rank, once for each of `runs`: "cold"
    on an emptied process graph cache, "steady" on the cache the runs
    before it kept, "profiled" on that cache under torch.profiler.
    `tree`: another checkout's port runs (`port`). Rank 0 writes the
    outputs. Every rank returns, of the last run, its cloud's digest,
    count, capacity, stats, kernel launches, phase seconds and each
    filter round's prefix rows and launches (`engine_probe`), rank 0 the
    alive rows' coord and dscale; and in "runs", for each run, its
    `PMVSEngine.run` seconds, phase seconds and each filter round's K2
    launches, and a profiled run's device busy and wall ms by phase,
    busy share and launch calls. The peak memory is over every run. The
    process's graph cache gives its memory back after the last run."""
    from ..scripts import profiling
    pkg = port(tree)
    E = _mod(pkg, "models.engine")
    shared = _mod(pkg, "models.graphs").shared
    mesh = _mod(pkg, "parallel.engine_shard").make_engine_mesh()
    timed = []
    _zero_launches(pkg)
    try:
        for kind in runs:
            if kind == "cold" and dev.type == "cuda":
                shared(dev).clear()
            _zero_launches(pkg, peak=False)
            prof = torch.profiler.profile(
                activities=profiling.activities()) \
                if kind == "profiled" else contextlib.nullcontext()
            t0 = time.time()
            with engine_probe(pkg) as rec, prof:
                eng = E.reconstruct(root, option, p_cap=p_cap, device=dev,
                                    mesh=mesh, **_QUIET, **run_kwargs)
                out = _report(dev, t0, pkg)
            phases = {k: v.seconds for k, v in eng.tracer.spans.items()}
            r = {"kind": kind, "seconds": rec["run_seconds"][0],
                 "phases": phases, "filter_k2": [
                     rd["launches"].get("windows", 0)
                     for rd in rec["filter_rounds"]]}
            if kind == "profiled":
                s = profiling.summarize(profiling.events(prof))
                r.update(busy_share=s["busy_share"],
                         launch_calls=s["launch_calls"],
                         device={ph: {"busy_ms": s["spans"][ph]["busy_ms"],
                                      "wall_ms": s["spans"][ph]["wall_ms"]}
                                 for ph in ("seed", "expand", "filter")
                                 if ph in s["spans"]})
            timed.append(r)
    finally:
        if dev.type == "cuda":
            shared(dev).clear()
    alive = eng.cloud.alive.cpu().numpy()
    out.update(digest=cloud_digest(eng.cloud), count=int(alive.sum()),
               p_cap=eng.p_cap, stats=eng.stats,
               filter_rounds=rec["filter_rounds"], phases=phases, runs=timed)
    if mesh.patch == 0:
        out.update(coord=eng.cloud.coord.cpu().numpy()[alive],
                   dscale=eng.cloud.dscale.cpu().numpy()[alive])
    return out


def halo_job(dev, root: str, names: list, fused: bool, k_frontier: int,
             p_cap: int, first: dict, rest: dict) -> dict:
    """Rank r reconstructs cluster names[r % 2]: the `first` rounds, then
    (ranks 0 and 1, when `fused`) one `exchange_halo` between them, then
    the `rest` (run kwargs with start_iter); ranks 2 and 3, when present,
    run the same pair without the exchange (the file-mediated baseline).
    Returns the alive rows' coord and dscale, the injected count and the
    launches."""
    from ..models.engine import PMVSEngine, load_scene
    from ..utils.options import PMVSOptions
    from .cross_cluster import exchange_halo, make_cluster_mesh
    mesh = make_cluster_mesh()
    opt = PMVSOptions.parse(os.path.join(root, names[dist.get_rank() % 2]))
    eng = PMVSEngine(load_scene(root, opt, device=dev), opt, p_cap=p_cap,
                     device=dev, **_QUIET)
    _zero_launches()
    t0 = time.time()
    eng.run(**first)
    injected = exchange_halo(eng, mesh, k_frontier) \
        if fused and mesh.c >= 0 else 0
    eng.run(**rest)
    out = _report(dev, t0)
    alive = eng.cloud.alive.cpu().numpy()
    out.update(injected=injected, coord=eng.cloud.coord.cpu().numpy()[alive],
               dscale=eng.cloud.dscale.cpu().numpy()[alive])
    return out


def exchange_program_job(dev, depth, occ, share, bp) -> tuple:
    """`cross_cluster._exchange_program` on rank c's slice [c] of the
    given [2, ...] arrays; its outputs as numpy."""
    from .cross_cluster import _exchange_program, make_cluster_mesh
    mesh = make_cluster_mesh()
    c = mesh.c
    out = _exchange_program(
        mesh.group, torch.as_tensor(depth[c], device=dev),
        torch.as_tensor(occ[c], device=dev),
        torch.as_tensor(share[c], device=dev),
        torch.as_tensor(bp[c], device=dev))
    return tuple(o.cpu().numpy() for o in out)
