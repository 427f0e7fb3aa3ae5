"""In-engine cross-cluster halo exchange over collectives (prototype).

Counterpart of cmvs_pmvs_tpu/parallel/cross_cluster.py. The reference's
clusters share nothing at runtime: one pmvs2 process per option-%04d
file (reference source/genOption.cpp:58-74), with CMVS's `oimages`
overlap as the halo each cluster re-reads from disk. Here two ranks,
each reconstructing one cluster with its own engine, meet between
expand/filter rounds:

  * the clusters' per-image depth-map minima and cell-occupancy counts
    for SHARED images are combined by all-reduce MIN / MAX over a
    2-rank `c` group, so the next expansion sees the other cluster's
    surfaces as occlusion and occupancy;
  * up to K boundary frontier patches (alive patches observing a
    shared image) are swapped with the other rank and injected into
    its cloud, where the next visibility rebuild integrates them;
    duplicates die in the filters like any other co-cell patch.

The combined depth/occupancy is transient (the engine's own
refresh_visibility rebuilds from the local cloud); the injected patches
persist. The JAX package runs the combine as one shard_map program over
both engines; here each rank calls `exchange_halo` with its own engine.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.distributed as dist

from .comm import MAX, MIN, all_reduce_, exchange_pair


@dataclass(frozen=True)
class ClusterMesh:
    """This rank's place on the 2-rank cluster axis `c`."""

    c: int
    group: object


def make_cluster_mesh() -> ClusterMesh:
    """The `c` group of ranks 0 and 1 (collective: every rank calls it);
    other ranks get c = -1 and take no part in the exchange."""
    group = dist.new_group([0, 1])
    rank = dist.get_rank()
    return ClusterMesh(c=rank if rank < 2 else -1, group=group)


def _exchange_program(group, depth, occ, share, bp):
    """Collective halo combine on the `c` group, for this rank's
    depth [NG, GH, GW] f32 (+inf where the cluster has no data), occ
    [NG, GH, GW] i32, share [NG] bool (images shared with the other
    cluster) and bp [K, 11] boundary patch rows (coord4 | normal4 | ncc
    | dscale | valid). Returns (depth', occ', the other rank's bp)."""
    dmin = all_reduce_(depth.clone(), MIN, group)
    omax = all_reduce_(occ.clone(), MAX, group)
    gate = share[:, None, None]
    depth2 = torch.where(gate, dmin, depth)
    occ2 = torch.where(gate, torch.maximum(occ, omax), occ)
    return depth2, occ2, exchange_pair(bp, group)


def _boundary_patches(eng, shared_local, k: int) -> np.ndarray:
    """Up to `k` alive patches that observe a shared image, as [k, 11]
    rows (coord4 | normal4 | ncc | dscale | valid), strongest first when
    there are more."""
    cloud = eng.cloud
    alive = cloud.alive.cpu().numpy()
    images = cloud.images.cpu().numpy()
    shared_set = set(int(i) for i in shared_local)
    obs = np.isin(images, list(shared_set) or [-2]).any(axis=1)
    rows = np.nonzero(alive & obs)[0]
    if len(rows) > k:
        ncc = cloud.ncc.cpu().numpy()[rows]
        rows = rows[np.argsort(-ncc)[:k]]
    out = np.zeros((k, 11), np.float32)
    n = len(rows)
    if n:
        out[:n, 0:4] = cloud.coord.cpu().numpy()[rows]
        out[:n, 4:8] = cloud.normal.cpu().numpy()[rows]
        out[:n, 8] = cloud.ncc.cpu().numpy()[rows]
        out[:n, 9] = cloud.dscale.cpu().numpy()[rows]
        out[:n, 10] = 1.0
    return out


def _inject_patches(eng, bp: np.ndarray, id_map: dict) -> int:
    """Append foreign frontier patches to `eng`'s cloud: image slots from
    fresh projections into the local views that see each patch (in
    bounds, facing; the reference's preProcess at its cheapest), grids
    from those projections, vimages left for the next
    refresh_visibility. Returns the number injected."""
    bp = bp[bp[:, 10] > 0.5]
    if not len(bp):
        return 0
    coord = bp[:, 0:4]
    cams, cfg = eng.scene.cams, eng.cfg
    P_all = cams.P.cpu().numpy()
    centers = cams.center.cpu().numpy()
    t = eng.cloud.max_views
    n_new = len(bp)
    images = np.full((n_new, t), -1, np.int32)
    grids = np.zeros((n_new, t, 2), np.int32)
    keep = np.zeros(n_new, bool)
    widths = eng.scene.pyr.widths[cfg.level].cpu().numpy()
    heights = eng.scene.pyr.heights[cfg.level].cpu().numpy()
    scale = 2.0 ** cfg.level
    for r in range(n_new):
        slots = 0
        for li in range(cfg.tn):
            q = P_all[li] @ coord[r]
            if q[2] <= 0:
                continue
            x, y = q[0] / q[2] / scale, q[1] / q[2] / scale
            if not (0 <= x < widths[li] and 0 <= y < heights[li]):
                continue
            ray = centers[li, :3] - coord[r, :3]
            ray = ray / np.linalg.norm(ray)
            if ray @ bp[r, 4:7] < 0.5:
                continue
            if slots < t:
                images[r, slots] = li
                grids[r, slots] = (int(x + 0.5) // cfg.csize,
                                   int(y + 0.5) // cfg.csize)
                slots += 1
        keep[r] = slots >= cfg.min_image_num
    images, grids, bp = images[keep], grids[keep], bp[keep]
    n_new = len(bp)
    if not n_new:
        return 0

    n_alive = int(eng.cloud.count())
    if n_alive + n_new > eng.p_cap:
        eng._grow(n_alive + n_new)
    eng._compact()
    cloud = eng.cloud
    sl = slice(n_alive, n_alive + n_new)

    def put(a, value):
        a = a.clone()
        a[sl] = torch.as_tensor(np.asarray(value), dtype=a.dtype,
                                device=a.device)
        return a

    eng.cloud = replace(
        cloud,
        coord=put(cloud.coord, bp[:, 0:4]),
        normal=put(cloud.normal, bp[:, 4:8]),
        ncc=put(cloud.ncc, bp[:, 8]),
        dscale=put(cloud.dscale, bp[:, 9]),
        ascale=put(cloud.ascale, np.full(n_new, 0.5, np.float32)),
        images=put(cloud.images, images),
        grids=put(cloud.grids, grids),
        vimages=put(cloud.vimages, -1),
        timages=put(cloud.timages, (images >= 0).sum(1)),
        dflag=put(cloud.dflag, 0),
        alive=put(cloud.alive, True))
    return n_new


def exchange_halo(engine, mesh: ClusterMesh, k_frontier: int = 256) -> int:
    """One cross-cluster exchange between this rank's live engine and the
    other rank's: shared-image depth minima and occupancy combined over
    the `c` group, each side's boundary frontier injected into the
    other. Returns the number of patches injected into this engine."""
    ids = list(engine.scene.image_ids)
    cfg = engine.cfg
    both = [None, None]
    dist.all_gather_object(both, (ids, cfg.gh, cfg.gw), group=mesh.group)
    if (both[0][1:]) != (both[1][1:]):
        raise ValueError("prototype requires equal grid shapes")
    gids = sorted(set(both[0][0]) | set(both[1][0]))
    g_of = {g: i for i, g in enumerate(gids)}
    shared = set(both[0][0]) & set(both[1][0])

    tn, dev = cfg.tn, engine.device
    loc2g = torch.as_tensor([g_of[g] for g in ids[:tn]], device=dev)
    depth = torch.full((len(gids), cfg.gh, cfg.gw), float("inf"),
                       device=dev)
    occ = torch.zeros((len(gids), cfg.gh, cfg.gw), dtype=torch.int32,
                      device=dev)
    depth[loc2g] = engine.grid.depth[:tn]
    occ[loc2g] = engine.grid.occ[:tn].to(torch.int32)
    share = torch.zeros(len(gids), dtype=torch.bool, device=dev)
    share[torch.as_tensor([g_of[g] for g in shared], dtype=torch.int64,
                          device=dev)] = True
    shared_local = [li for li, g in enumerate(ids[:tn]) if g in shared]
    bp = torch.as_tensor(_boundary_patches(engine, shared_local, k_frontier),
                         device=dev)
    depth2, occ2, other = _exchange_program(mesh.group, depth, occ, share,
                                            bp)
    grid = engine.grid
    gdepth, gocc = grid.depth.clone(), grid.occ.clone()
    gdepth[:tn] = depth2[loc2g]
    gocc[:tn] = occ2[loc2g].to(gocc.dtype)
    engine.grid = replace(grid, depth=gdepth, occ=gocc)
    return _inject_patches(engine, other.cpu().numpy(),
                           {g: li for li, g in enumerate(ids)})
