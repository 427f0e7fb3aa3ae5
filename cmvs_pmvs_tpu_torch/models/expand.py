"""Patch expansion as vectorized frontier waves.

Counterpart of cmvs_pmvs_tpu/models/expand.py (reference expand.cpp):
each wave every frontier patch proposes up to 6 tangent-plane candidates
(findEmptyBlocks, expand.cpp:108-180); candidates are gated, deduplicated
per cell, batch-refined, and the successes form the next frontier.
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import NamedTuple

import torch

from ..device import device_constant
from ..geom.cameras import CameraSet, get_unit
from ..image.pyramid import PyramidSet
from ..image.sample import inside_bimages, mask_all
from ..ops.refine import compute_units
from .config import EngineConfig, Thresholds
from .grid import (CellTable, GridState, build_cell_table, cell_of,
                   count_cells, flat_cell_key, is_neighbor_idx,
                   rebuild_depth_maps, rebuild_occupancy)
from .graphs import program
from .patches import PatchCloud, append_patches, sized_nonzero
from .process import ProcessResult, process_candidates_chunked
from . import views as V

# 3x3 cell window offsets (findNeighbors margin 1)
OFFS9 = [(-1, -1), (0, -1), (1, -1), (-1, 0), (0, 0), (1, 0),
         (-1, 1), (0, 1), (1, 1)]


def _ortho(normal):
    """Tangent basis from a normal (numeric/vec4.hpp:303-322)."""
    z = normal[..., :3]
    ax, ay = z[..., 0].abs(), z[..., 1].abs()
    zero = torch.zeros_like(ax)
    x0 = torch.stack([z[..., 1], -z[..., 0], zero], -1)
    x1 = torch.stack([zero, z[..., 2], -z[..., 1]], -1)
    x2 = torch.stack([-z[..., 2], zero, z[..., 0]], -1)
    x = torch.where((ax > 0.5)[..., None], x0,
                    torch.where((ay > 0.5)[..., None], x1, x2))
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x)
    zeros = torch.zeros_like(x[..., :1])
    return torch.cat([x, zeros], -1), torch.cat([y, zeros], -1)


def compute_radius(cams: CameraSet, cfg: EngineConfig, coord, normal,
                   images, ivalid):
    """2nd-smallest per-view fineness unit x csize (expand.cpp:182-198)."""
    units = compute_units(cams, cfg.level, coord, normal, images, ivalid)
    two = torch.sort(units, dim=1).values[:, :2]
    return two[:, 1] * cfg.csize


def patch_unit(cams: CameraSet, cfg: EngineConfig, coord, images, ivalid):
    """Mean getUnit over the patch's views x csize
    (patchOrganizerS.cpp:653-661)."""
    u = get_unit(cams, images.clamp(min=0).long(), coord[:, None, :],
                 cfg.level)
    cnt = ivalid.sum(1).clamp(min=1)
    return torch.where(ivalid, u, torch.zeros_like(u)).sum(1) / cnt \
        * cfg.csize


def window_keys(cfg: EngineConfig, images, grids, offsets, sentinel: int):
    """Flat cell keys [P, T*W] of a window of offsets around every stored
    slot's cell, plus their validity mask."""
    w = len(offsets)
    off = device_constant(tuple(offsets), torch.int64, images.device)
    t = images.shape[1]
    cx = grids[..., 0].long().repeat_interleave(w, -1) + off[:, 0].repeat(t)
    cy = grids[..., 1].long().repeat_interleave(w, -1) + off[:, 1].repeat(t)
    io = images.repeat_interleave(w, -1)
    key, ok = flat_cell_key(io, cx, cy, cfg.tn, cfg.gh, cfg.gw)
    return torch.where(ok, key, torch.full_like(key, sentinel)), ok


class WaveStats(NamedTuple):
    accepted: torch.Tensor
    dropped: torch.Tensor      # successes lost to capacity overflow
    view_drops: torch.Tensor   # views lost to the t_store cap


def find_empty_blocks(cams, cfg: EngineConfig, thr: Thresholds,
                      cloud: PatchCloud, tab: CellTable, fsel, fok):
    """Per frontier row `fsel` [F] (those with `fok` set; the rest are
    padding), which of the 6 sectors lack neighbours (expand.cpp:108-180),
    against the merged pgrids+vpgrids table. Returns (cand_coord
    [F, 6, 4], cand_ok [F, 6])."""
    fcoord = cloud.coord[fsel]
    fnormal = cloud.normal[fsel]
    fimages = cloud.images[fsel]
    ivalid = fimages >= 0
    radius = compute_radius(cams, cfg, fcoord, fnormal, fimages, ivalid)
    unit = patch_unit(cams, cfg, fcoord, fimages, ivalid)
    xdir, ydir = _ortho(fnormal)
    f = fsel.shape[0]

    key, ok9 = window_keys(cfg, fimages, cloud.grids[fsel], OFFS9,
                           tab.sentinel)
    pids, hit = tab.lookup_flat(key, cfg.cell_k)          # [F, T*9*K]
    hit = hit & ok9.repeat_interleave(cfg.cell_k, -1) & (pids >= 0)
    q = pids.clamp(min=0)
    neigh = is_neighbor_idx(cloud.coord, cloud.normal, cloud.dscale,
                            fsel[:, None], q, unit[:, None],
                            thr.neighbor * 4.0,
                            radius=(1.5 * radius)[:, None])
    m = hit & neigh & (q != fsel[:, None])
    d = cloud.coord[q][..., :3] - fcoord[:, None, :3]
    f2x = (d * xdir[:, None, :3]).sum(-1)
    f2y = (d * ydir[:, None, :3]).sum(-1)
    ln = torch.sqrt(f2x * f2x + f2y * f2y)
    rl = radius[:, None]
    m = m & (ln >= rl / 6.0) & (ln <= rl * 2.5)
    ang = torch.atan2(f2y, f2x)
    ang = torch.where(ang < 0.0, ang + 2 * math.pi, ang)
    findex = ang / (2 * math.pi / 6.0)
    lo = torch.floor(findex).long()
    wlo = (lo + 1) - findex
    whi = findex - lo
    fills = torch.zeros((f, 7), device=fcoord.device)
    row = torch.arange(f, device=fcoord.device)[:, None].expand_as(m)
    zero = torch.zeros_like(wlo)
    fills.index_put_((row, torch.where(m, lo % 6, torch.full_like(lo, 6))),
                     torch.where(m, wlo, zero), accumulate=True)
    fills.index_put_((row, torch.where(m, (lo + 1) % 6,
                                       torch.full_like(lo, 6))),
                     torch.where(m, whi, zero), accumulate=True)
    sector = torch.arange(6, device=fcoord.device)
    bit = (cloud.dflag[fsel][:, None] >> sector[None]) & 1
    ok = (fills[:, :6] <= 0.0) & (bit == 0) & fok[:, None]
    a = 2 * math.pi * sector.to(fcoord.dtype) / 6.0
    cand = fcoord[:, None, :] + (torch.cos(a)[None, :, None]
                                 * xdir[:, None, :]
                                 + torch.sin(a)[None, :, None]
                                 * ydir[:, None, :]) * radius[:, None, None]
    return cand, ok


class DiscoverResult(NamedTuple):
    """Gated, per-cell-deduped expansion candidates, best-score-first
    (row order = (frontier score2 rank, sector), the reference queue's
    best-first order, expand.cpp:80-88). `ncand` is the one value the
    host reads to size the commit batch."""

    coord: torch.Tensor     # [F6, 4]
    normal: torch.Tensor    # [F6, 4]
    vmask: torch.Tensor     # [F6, N]
    ref: torch.Tensor       # [F6]
    parent: torch.Tensor    # [F6] parent row in the cloud slice
    sector: torch.Tensor    # [F6]
    sval: torch.Tensor      # [F6] candidate survives all gates
    overflow: torch.Tensor  # [P] frontier rows past the budget (retry)
    ncand: torch.Tensor     # [] int32, sval.sum()


class DiscoverRows(NamedTuple):
    """Discovery's per-candidate rows before the per-cell dedupe: `sval`
    holds the gates up to checkCounts, `ckey` each candidate's (ref
    image, cell) key (the sentinel where `sval` is False)."""

    coord: torch.Tensor
    normal: torch.Tensor
    vmask: torch.Tensor
    ref: torch.Tensor
    parent: torch.Tensor
    sector: torch.Tensor
    sval: torch.Tensor
    ckey: torch.Tensor


def discover_rows(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
                  thr: Thresholds, cloud: PatchCloud, grid: GridState,
                  frontier, slack: int, fbudget: int, lo: int = 0,
                  hi: int | None = None):
    """Discovery up to the dedupe for frontier slots [lo, hi) of the best
    `fbudget` alive frontier rows by score2 (ties to the lower row, as
    lax.top_k): sector discovery and every gate of expandSub
    (expand.cpp:108-256) but the per-cell dedupe, which spans the whole
    batch. The selection itself is over the whole slice, so the rows
    past the budget come back whole in `overflow`. Returns
    (DiscoverRows of 6 * (hi - lo) rows, overflow [P])."""
    dev = cloud.coord.device
    p = cloud.capacity
    tab = build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw, merged=True)
    live = frontier & cloud.alive
    fscore = torch.where(live, cloud.score2(thr.ncc),
                         torch.full_like(cloud.ncc, -math.inf))
    fsel = torch.argsort(fscore, descending=True, stable=True)[:fbudget]
    fok = fscore[fsel] > -math.inf
    taken = torch.zeros(p, dtype=torch.bool, device=dev)
    taken.scatter_(0, fsel, fok)
    overflow = live & ~taken
    fsel, fok = fsel[lo:hi], fok[lo:hi]

    cand, cok = find_empty_blocks(cams, cfg, thr, cloud, tab, fsel, fok)
    sval = cok.reshape(-1)
    coord = cand.reshape(-1, 4)
    parent = fsel.repeat_interleave(6)
    sector = torch.arange(6, device=dev).repeat(fsel.shape[0])
    pimgs = cloud.images[parent]                             # [F6, T]
    pval = pimgs >= 0
    ix, iy = cell_of(cams, cfg.level, cfg.csize, coord[:, None, :], pimgs)
    in_grid = pval & (ix >= 0) & (ix < cfg.gw) & (iy >= 0) & (iy < cfg.gh)
    sval = sval & in_grid.any(1)
    sval = sval & mask_all(pyr, cams.P, coord, cfg.level)
    sval = sval & inside_bimages(pyr, cams.P, coord, cfg.level,
                                 cfg.bindexes)

    # checkCounts (expand.cpp:258-323) over target-image cells
    tgt = in_grid & (pimgs < cfg.tn)
    ci = pimgs.long().clamp(0, cfg.tn - 1)
    cx = ix.long().clamp(0, cfg.gw - 1)
    cy = iy.long().clamp(0, cfg.gh - 1)
    busy = (grid.occ[ci, cy, cx] > 0) | (grid.counts[ci, cy, cx]
                                         >= thr.count1)
    full = (tgt & busy).sum(1)
    empty = (tgt & ~busy).sum(1)
    sval = sval & ~((empty < cfg.min_image_num - slack) & (full != 0))

    ref = pimgs[:, 0].clamp(min=0)
    rix, riy = cell_of(cams, cfg.level, cfg.csize, coord, ref)
    sentinel = cfg.tn * cfg.gh * cfg.gw
    ckey = (ref.long() * cfg.gh + riy.long().clamp(0, cfg.gh - 1)) * cfg.gw \
        + rix.long().clamp(0, cfg.gw - 1)
    ckey = torch.where(sval, ckey, torch.full_like(ckey, sentinel))

    normal = cloud.normal[parent]
    vmask = torch.zeros((coord.shape[0], cfg.n), dtype=torch.uint8,
                        device=dev)
    vmask.scatter_reduce_(1, pimgs.clamp(min=0).long(),
                          pval.to(torch.uint8), "amax")
    vmask = V.remove_images_edge(pyr, cams, cfg.level, coord, vmask.bool())
    return DiscoverRows(coord=coord, normal=normal, vmask=vmask, ref=ref,
                        parent=parent, sector=sector, sval=sval,
                        ckey=ckey), overflow


def discover_dedupe(cfg: EngineConfig, rows: DiscoverRows, overflow
                    ) -> DiscoverResult:
    """One candidate per (ref image, cell) per wave over the whole
    batch: rows are best-first, so the lowest row per cell wins; then the
    candidates left with no view after the edge test go."""
    f6 = rows.sval.shape[0]
    dev = rows.sval.device
    sentinel = cfg.tn * cfg.gh * cfg.gw
    idx = torch.arange(f6, device=dev)
    firstmap = torch.full((sentinel + 1,), f6, dtype=torch.int64,
                          device=dev)
    firstmap.scatter_reduce_(0, rows.ckey, idx, "amin")
    sval = rows.sval & (firstmap[rows.ckey] == idx)
    sval = sval & rows.vmask.any(1)
    return DiscoverResult(coord=rows.coord, normal=rows.normal,
                          vmask=rows.vmask, ref=rows.ref,
                          parent=rows.parent, sector=rows.sector,
                          sval=sval, overflow=overflow,
                          ncand=sval.sum().to(torch.int32))


@program(scene=3, static=("slack", "fbudget"))
def expand_discover(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
                    thr: Thresholds, cloud: PatchCloud, grid: GridState,
                    frontier, slack: int, fbudget: int) -> DiscoverResult:
    """Wave stage 1 (reference expand.py:194-281): the best `fbudget`
    alive frontier rows by score2, sector discovery and every
    pre-refinement gate of expandSub (expand.cpp:108-256), at F6 =
    fbudget * 6 rows (`discover_rows`), then the per-cell dedupe
    (`discover_dedupe`). Frontier rows past the budget come back in
    `overflow`; padding rows (a budget above the frontier) have `sval`
    False. `slack` is checkCounts' leniency: 0 on the first expand
    iteration, 1 after (expand.cpp:276)."""
    rows, overflow = discover_rows(cams, pyr, cfg, thr, cloud, grid,
                                   frontier, slack, fbudget)
    return discover_dedupe(cfg, rows, overflow)


@program(scene=3, static=("slack", "fbudget", "lo", "hi"))
def _discover_rows(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
                   thr: Thresholds, cloud: PatchCloud, grid: GridState,
                   frontier, slack: int, fbudget: int, lo: int, hi: int):
    return discover_rows(cams, pyr, cfg, thr, cloud, grid, frontier, slack,
                         fbudget, lo, hi)


@program(scene=1)
def _discover_dedupe(cfg: EngineConfig, rows: DiscoverRows, overflow):
    return discover_dedupe(cfg, rows, overflow)


def expand_discover_sharded(cams: CameraSet, pyr: PyramidSet,
                            cfg: EngineConfig, thr: Thresholds,
                            cloud: PatchCloud, grid: GridState, frontier,
                            slack: int, fbudget: int, mesh, graphs=None
                            ) -> DiscoverResult:
    """expand_discover under an engine mesh (parallel/engine_shard),
    equal to it bit for bit: each rank discovers and gates the candidates
    of its slice of the frontier budget's slots, one all-gather gives
    every rank the whole batch, and the dedupe runs replicated on it."""
    from ..parallel.engine_shard import gather_rows, own_rows
    lo, hi = own_rows(mesh, fbudget)
    part, overflow = _discover_rows(cams, pyr, cfg, thr, cloud, grid,
                                    frontier, slack, fbudget, lo, hi,
                                    graphs=graphs)
    rows = DiscoverRows(*gather_rows(mesh, list(part)))
    return _discover_dedupe(cfg, rows, overflow, graphs=graphs)


def _bump(grid: GridState, cfg: EngineConfig, thr: Thresholds, images,
          grids, mask):
    """Attempt-counter increments for successes' cells (updateCounts,
    expand.cpp:325-406) and whether some cell was under count1."""
    key, okc = flat_cell_key(images, grids[..., 0], grids[..., 1], cfg.tn,
                             cfg.gh, cfg.gw)
    okc = okc & mask[:, None]
    ncell = cfg.tn * cfg.gh * cfg.gw
    key = torch.where(okc, key, torch.full_like(key, ncell))
    under = (grid.counts.reshape(-1)[key.clamp(max=ncell - 1)]
             < thr.count1) & okc
    return count_cells(key, cfg.tn, cfg.gh, cfg.gw), under.any(1)


class CommitBatch(NamedTuple):
    """A commit's refine batch (the first `cbudget` surviving candidates,
    inactive rows after them) and what the apply half needs of it."""

    coord: torch.Tensor            # [C, 4]
    normal: torch.Tensor           # [C, 4]
    vmask: torch.Tensor            # [C, N]
    ref: torch.Tensor              # [C]
    active: torch.Tensor           # [C]
    parent: torch.Tensor           # [C] parent row; p where inactive
    sector: torch.Tensor           # [C]
    overflow_parent: torch.Tensor  # [P] rows to requeue


@program(static=("p", "cbudget"))
def commit_select(disc: DiscoverResult, p: int, cbudget: int
                  ) -> CommitBatch:
    """Commit's select half (reference expand.py:299-316): the first
    `cbudget` surviving candidates as the batch (jnp.nonzero(size=
    cbudget)), padded with inactive rows that are never appended, bump
    no count and mark no parent; the parents of candidates past the
    budget and the discover stage's `overflow` rows (sized to the cloud
    slice's `p` rows by the caller) are requeued."""
    f6 = disc.sval.shape[0]
    dev = disc.sval.device
    pos = sized_nonzero(disc.sval, cbudget, f6)
    active = pos < f6
    posc = pos.clamp(max=f6 - 1)
    taken = torch.zeros(f6 + 1, dtype=torch.bool, device=dev)
    taken.scatter_(0, pos, True)
    leftover = disc.sval & ~taken[:f6]
    overflow_parent = torch.zeros(p + 1, dtype=torch.bool, device=dev)
    overflow_parent.scatter_(0, torch.where(leftover, disc.parent, p), True)
    return CommitBatch(
        coord=disc.coord[posc], normal=disc.normal[posc],
        vmask=disc.vmask[posc] & active[:, None], ref=disc.ref[posc],
        active=active, parent=torch.where(active, disc.parent[posc], p),
        sector=disc.sector[posc],
        overflow_parent=overflow_parent[:p] | disc.overflow)


@program(scene=2, static=("cbudget",))
def commit_apply(cams: CameraSet, cfg: EngineConfig, thr: Thresholds,
                 cloud: PatchCloud, grid: GridState, active, parent, sector,
                 overflow_parent, res: ProcessResult, cbudget: int):
    """Commit's apply half (reference expand.py:323-390): failed sectors
    mark their parents' dflag, successes bump their cells' counters and
    are appended, and the new frontier is the appended rows that some
    under-count cell requeues plus the requeued parents; then occupancy
    and depth maps. Returns (cloud, grid, new_frontier [P], stats)."""
    p = cloud.capacity
    dev = cloud.coord.device
    success = res.success & active

    # parent dflag |= sector bit on failure (expand.cpp:98-103); a
    # (parent, sector) pair occurs at most once per wave, so add == or
    fail = active & ~success
    bits = torch.zeros(p + 1, dtype=cloud.dflag.dtype, device=dev)
    bits.index_add_(0, torch.where(fail, parent, p),
                    torch.where(fail, 1 << sector, 0).to(bits.dtype))
    cloud = replace(cloud, dflag=cloud.dflag | bits[:p])

    c1, under1 = _bump(grid, cfg, thr, res.images, res.grids, success)
    c2, under2 = _bump(grid, cfg, thr, res.vimages, res.vgrids, success)
    grid = replace(grid, counts=grid.counts + c1 + c2)
    requeue = success & (under1 | under2)

    new = PatchCloud(
        coord=res.coord, normal=res.normal, ncc=res.ncc, images=res.images,
        grids=res.grids, vimages=res.vimages, vgrids=res.vgrids,
        timages=res.timages, dscale=res.dscale, ascale=res.ascale,
        dflag=torch.zeros(cbudget, dtype=torch.int32, device=dev),
        alive=success)
    before = cloud.alive
    cloud2, dropped = append_patches(cloud, new, success)
    # appended slots are filled in the order of the success rows
    app_idx = sized_nonzero(cloud2.alive & ~before, cbudget, p)
    src_idx = sized_nonzero(success, cbudget, cbudget)
    req = torch.cat([requeue, torch.zeros(1, dtype=torch.bool,
                                          device=dev)])[src_idx]
    new_frontier = torch.zeros(p + 1, dtype=torch.bool, device=dev)
    new_frontier.scatter_(0, app_idx, req & (app_idx < p))
    new_frontier = new_frontier[:p] | (overflow_parent & cloud2.alive)

    occ, vocc = rebuild_occupancy(cloud2, cfg.tn, cfg.gh, cfg.gw)
    dmin, didx = rebuild_depth_maps(cams, cloud2, cfg.level, cfg.csize,
                                    cfg.tn, cfg.gh, cfg.gw)
    grid = replace(grid, occ=occ, vocc=vocc, depth=dmin, depth_idx=didx)
    stats = WaveStats(accepted=success.sum(),
                      dropped=dropped, view_drops=res.view_drops)
    return cloud2, grid, new_frontier, stats


def expand_commit(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
                  thr: Thresholds, visdata, cloud: PatchCloud,
                  grid: GridState, disc: DiscoverResult, cbudget: int,
                  refine_iters: int = 10, mesh=None, graphs=None):
    """Wave stage 2: refine + postProcess the first `cbudget` surviving
    candidates (best-first) and commit the successes: `commit_select`,
    process_candidates over the batch's chunks, `commit_apply`. Returns
    (cloud, grid, new_frontier [P], stats). `mesh`: an engine mesh
    splitting the refine batch over ranks; `graphs`: a
    models/graphs.RefineGraphs that runs the two halves and the chunks
    as CUDA graphs."""
    b = commit_select(disc, cloud.capacity, cbudget, graphs=graphs)
    res = process_candidates_chunked(cams, pyr, cfg, thr, visdata, b.coord,
                                     b.normal, b.vmask, b.ref, depth=1,
                                     grid=grid, cloud=cloud, active=b.active,
                                     refine_iters=refine_iters, mesh=mesh,
                                     graphs=graphs)
    return commit_apply(cams, cfg, thr, cloud, grid, b.active, b.parent,
                        b.sector, b.overflow_parent, res, cbudget,
                        graphs=graphs)


def expand_wave(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
                thr: Thresholds, visdata, cloud: PatchCloud,
                grid: GridState, frontier, depth: int, budget: int,
                fbudget: int, refine_iters: int = 10, mesh=None,
                graphs=None):
    """One expansion wave, discover + commit, at a fixed commit `budget`
    and frontier budget `fbudget` (reference expand.py:393-407): the
    frontier rows past `fbudget` and the parents of candidates past
    `budget` stay on the returned frontier."""
    slack = 0 if depth <= 1 else 1
    disc = expand_discover(cams, pyr, cfg, thr, cloud, grid, frontier,
                           slack, fbudget, graphs=graphs)
    return expand_commit(cams, pyr, cfg, thr, visdata, cloud, grid, disc,
                         budget, refine_iters=refine_iters, mesh=mesh,
                         graphs=graphs)
