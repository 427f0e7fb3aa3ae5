"""Rank jobs for `launch.RankPool`: the port's multi-rank paths driven
from a parent process (the tests on the CPU, chip_smoke.py on the card).

Each job is a module-level function `job(device, ...)` that runs on
every rank of a fresh process group and returns picklable results
(numpy arrays, numbers, dicts). Jobs count the kernels they launch: the
wrappers' counters are zeroed just before the work and read just after.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time

import torch
import torch.distributed as dist

from . import comm

_QUIET = dict(log=lambda *a: None)


def _wrappers():
    from ..ops.fan import incc_fan_v1
    from ..ops.fan2 import incc_fan
    from ..ops.incc import incc_blocks
    from ..ops.windows import windows
    return {"incc_fan": incc_fan, "windows": windows,
            "incc_fan_v1": incc_fan_v1, "incc_blocks": incc_blocks}


def _zero_launches():
    for w in _wrappers().values():
        w.launches = 0
    comm.STAGED.clear()


def _report(dev, t0) -> dict:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"seconds": time.time() - t0, "backend": dist.get_backend(),
            "staged": dict(comm.STAGED),
            "launches": {k: w.launches for k, w in _wrappers().items()}}


def cloud_digest(cloud) -> str:
    """sha256 over every field of a PatchCloud, all rows."""
    h = hashlib.sha256()
    for f in dataclasses.fields(cloud):
        h.update(getattr(cloud, f.name).cpu().contiguous().numpy()
                 .tobytes())
    return h.hexdigest()


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


def engine_job(dev, root: str, option: str, p_cap: int,
               run_kwargs: dict) -> dict:
    """The data-parallel engine (`reconstruct(..., mesh=
    make_engine_mesh())`) on every rank; rank 0 writes the outputs and
    returns the alive rows' coord and dscale, every rank its cloud's
    digest, count, capacity and launches."""
    from ..models.engine import reconstruct
    from .engine_shard import make_engine_mesh
    mesh = make_engine_mesh()
    _zero_launches()
    t0 = time.time()
    eng = reconstruct(root, option, p_cap=p_cap, device=dev, mesh=mesh,
                      **_QUIET, **run_kwargs)
    out = _report(dev, t0)
    alive = eng.cloud.alive.cpu().numpy()
    out.update(digest=cloud_digest(eng.cloud), count=int(alive.sum()),
               p_cap=eng.p_cap, stats=eng.stats)
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
