"""The per-candidate pipeline: preProcess -> refine -> postProcess.

Counterpart of cmvs_pmvs_tpu/models/process.py, shared by seeding and
expansion (reference seed.cpp:387-414, expand.cpp:200-256 via COptim
preProcess / refinePatch / postProcess, optim.cpp:95-190): [B] batches
of candidates with dense view masks; the final `success` mask says which
candidates became patches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom.cameras import CameraSet, project
from ..image.pyramid import PyramidSet
from ..image.sample import edge_at, inside_bimages, mask_all
from ..ops.refine import compute_units, make_problem, refine_patches, \
    set_scales
from ..ops.texture import robustincc, unrobustincc
from .config import EngineConfig, Thresholds
from .grid import GridState, cell_of, is_visible
from .patches import PatchCloud
from . import views as V


class ProcessResult(NamedTuple):
    success: torch.Tensor    # [B] bool
    coord: torch.Tensor      # [B, 4]
    normal: torch.Tensor     # [B, 4]
    ncc: torch.Tensor        # [B]
    images: torch.Tensor     # [B, T_store] int32, slot 0 = reference
    grids: torch.Tensor      # [B, T_store, 2]
    vimages: torch.Tensor    # [B, T_store]
    vgrids: torch.Tensor     # [B, T_store, 2]
    timages: torch.Tensor    # [B]
    dscale: torch.Tensor     # [B]
    ascale: torch.Tensor     # [B]
    view_drops: torch.Tensor  # [] views lost to the t_store cap


# Candidates per process_candidates call: bounds the texture buffers of
# the postProcess passes and matches the refine kernel's batch shape.
PROCESS_CHUNK = 8192


def _mask_from_views(views, vvalid, n: int):
    """[B, N] bool with vmask[b, views[b, t]] set where vvalid."""
    m = torch.zeros((views.shape[0], n), dtype=torch.uint8,
                    device=views.device)
    m.scatter_reduce_(1, views.clamp(min=0).long(), vvalid.to(torch.uint8),
                      "amax")
    return m.bool()


def process_candidates_chunked(cams: CameraSet, pyr: PyramidSet,
                               cfg: EngineConfig, thr: Thresholds,
                               visdata, coord, normal, vmask, ref,
                               depth: int, grid: GridState | None = None,
                               cloud: PatchCloud | None = None,
                               active=None, refine_iters: int = 12,
                               chunk: int = PROCESS_CHUNK,
                               mesh=None, graphs=None) -> ProcessResult:
    """process_candidates over consecutive `chunk`-row slices; rows whose
    `active` is False (the padding of a bucketed batch) take no part in
    any decision and come back with success False. With an engine `mesh`
    (parallel/engine_shard) each rank runs its equal slice of the batch
    and the slices' results are gathered on every rank. With `graphs` (a
    models/graphs.RefineGraphs) each chunk runs as a replayed CUDA graph
    of its row count."""
    b = coord.shape[0]
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=coord.device)
    if mesh is not None:
        from ..parallel.engine_shard import gather_result, shard_rows
        rows, act = shard_rows(mesh, b, active)
        part = process_candidates_chunked(
            cams, pyr, cfg, thr, visdata, coord[rows], normal[rows],
            vmask[rows], ref[rows], depth=depth, grid=grid, cloud=cloud,
            active=act, refine_iters=refine_iters, chunk=chunk,
            graphs=graphs)
        return gather_result(mesh, part, b)
    run = process_candidates if graphs is None else graphs.process
    parts = [run(cams, pyr, cfg, thr, visdata, coord[s:s + chunk],
                 normal[s:s + chunk], vmask[s:s + chunk], ref[s:s + chunk],
                 depth=depth, grid=grid, cloud=cloud,
                 active=active[s:s + chunk], refine_iters=refine_iters)
             for s in range(0, max(b, 1), chunk)]
    if len(parts) == 1:
        return parts[0]
    return ProcessResult(*[
        torch.stack(f).sum() if name == "view_drops" else torch.cat(f)
        for name, f in zip(ProcessResult._fields, zip(*parts))])


def process_candidates(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
                       thr: Thresholds, visdata, coord, normal, vmask, ref,
                       depth: int, grid: GridState | None = None,
                       cloud: PatchCloud | None = None, active=None,
                       refine_iters: int = 12) -> ProcessResult:
    """The full candidate pipeline on a [B] batch. depth >= 1 enables
    vimages through the depth maps in `grid`/`cloud`."""
    b = coord.shape[0]
    dev = coord.device
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=dev)
    n = vmask.shape[1]
    rows = torch.arange(b, device=dev)

    # ---- preProcess (optim.cpp:95-122) ----
    vmask = V.add_images(cams, pyr, visdata, cfg.level, coord, normal,
                         vmask, ref)
    vmask = V.constraint_images(cams, pyr, cfg.level, cfg.wsize, coord,
                                normal, ref, vmask, thr.ncc_before)
    views, vvalid = V.sort_images(cams, cfg.level, coord, normal, ref,
                                  vmask, cfg.t_store)
    ok = active & (vvalid.sum(1) >= cfg.min_image_num)
    dscale, ascale = set_scales(cams, cfg.level, cfg.wsize, coord,
                                views[:, :cfg.tau], vvalid[:, :cfg.tau])
    ok = ok & V.check_angles(cams, coord, views, vvalid, thr.max_angle,
                             thr.angle1)

    # ---- refine (optim.cpp:496-658); the score comes from D below ----
    prob = make_problem(cams, cfg.level, coord, normal, views[:, :cfg.tau],
                        vvalid[:, :cfg.tau], dscale, cfg.min_image_num)
    coord, normal, _, _ = refine_patches(
        cams, pyr, cfg.level, cfg.wsize, prob, coord, normal,
        num_iters=refine_iters, active=ok, with_ncc=False)

    # ---- postProcess (optim.cpp:150-190) ----
    vmask = _mask_from_views(views, vvalid, n)
    ok = ok & mask_all(pyr, cams.P, coord, cfg.level)
    ok = ok & inside_bimages(pyr, cams.P, coord, cfg.level, cfg.bindexes)
    vmask = V.add_images(cams, pyr, visdata, cfg.level, coord, normal,
                         vmask, ref)

    # one masked grab + one pairwise NCC matrix serve the constraint
    # pass, the reference re-pick, the second constraint pass and the
    # final score (the reference re-grabs identical windows each time)
    texs, gok = V.grab_masked(cams, pyr, cfg.level, cfg.wsize, coord,
                              normal, ref, vmask)
    D = V.pairwise_dots(texs)
    pair_ok = gok[:, :, None] & gok[:, None, :]

    def constraint(vm, r):
        r = r.long()
        okp = gok & gok[rows, r][:, None]
        incc = torch.where(okp, 1.0 - D[rows, r], torch.full_like(okp, 2.0,
                                                                  dtype=D.dtype))
        keep = vm & (incc < 1.0 - thr.ncc)
        keep[rows, r] = vm[rows, r]
        return keep

    vmask = constraint(vmask, ref)
    vmask = V.filter_images_by_angle(cams, coord, normal, ref, vmask,
                                     thr.angle1)
    ok = ok & (vmask.sum(1) >= cfg.min_image_num)

    rincc = torch.where(pair_ok, robustincc(1.0 - D), torch.full_like(D, 2.0))
    rincc = rincc * (1.0 - torch.eye(n, device=dev))[None]
    sums = torch.where(vmask[:, None, :], rincc,
                       torch.zeros_like(rincc)).sum(2)
    cand_r = vmask & (torch.arange(n, device=dev) < cfg.tn)[None]
    sums = torch.where(cand_r, sums, torch.full_like(sums, float("inf")))
    ref_ok = cand_r.any(1)
    ref = torch.where(ref_ok, torch.argmin(sums, 1).to(ref.dtype), ref)
    ok = ok & ref_ok
    vmask = constraint(vmask, ref)
    ok = ok & (vmask.sum(1) >= cfg.min_image_num)

    view_drops = torch.where(ok, (vmask.sum(1) - cfg.t_store).clamp(min=0),
                             torch.zeros_like(ok, dtype=torch.int64)).sum()
    views, vvalid = V.sort_images(cams, cfg.level, coord, normal, ref,
                                  vmask, cfg.t_store)
    ix, iy = cell_of(cams, cfg.level, cfg.csize, coord[:, None, :], views)
    grids = torch.stack([ix, iy], -1)
    views = torch.where(vvalid, views, torch.full_like(views, -1))
    timages = (vvalid & (views >= 0) & (views < cfg.tn)).sum(1).to(
        torch.int32)

    # final score: weighted robust INCC over the first tau views
    # (optim.cpp:652 + computeINCC :875-938), again from D
    tviews = views[:, :cfg.tau]
    tvalid = vvalid[:, :cfg.tau]
    vid = tviews.clamp(min=0).long()
    units = compute_units(cams, cfg.level, coord, normal, tviews, tvalid)
    w = (units[:, 0:1] / units.clamp(min=1e-30)).clamp(max=1.0)
    w[:, 0] = 1.0
    dref = D[rows[:, None], vid[:, 0:1], vid]
    ref_gok = gok[rows, vid[:, 0]]
    p_ok = gok[rows[:, None], vid] & ref_gok[:, None] & tvalid
    p_ok[:, 0] = False
    w = torch.where(p_ok, w, torch.zeros_like(w))
    incc_t = torch.where(p_ok, robustincc(1.0 - dref),
                         torch.full_like(dref, 2.0))
    total = w.sum(-1)
    zero = total == 0.0
    score = (incc_t * w).sum(-1) / torch.where(zero, torch.ones_like(total),
                                               total)
    score = torch.where(zero | ~ref_gok, torch.full_like(score, 2.0), score)
    ncc = 1.0 - unrobustincc(score)

    vimages = torch.full_like(views, -1)
    vgrids = torch.zeros_like(grids)
    if depth >= 1 and grid is not None and cloud is not None:
        vimages, vgrids = set_vimages(cams, pyr, cfg, thr, grid, cloud,
                                      coord, normal, views, cfg.t_store)
    return ProcessResult(success=ok, coord=coord, normal=normal, ncc=ncc,
                         images=views, grids=grids, vimages=vimages,
                         vgrids=vgrids, timages=timages, dscale=dscale,
                         ascale=ascale, view_drops=view_drops)


def set_vimages(cams, pyr, cfg: EngineConfig, thr: Thresholds,
                grid: GridState, cloud: PatchCloud, coord, normal, views,
                cap: int):
    """Depth-visible target views not already in the view list
    (patchOrganizerS.cpp:420-450): depth test at strict = 0.5 plus an
    edge-map pass. Returns -1-padded [B, cap] vimages and their cells."""
    b = coord.shape[0]
    tn = cfg.tn
    dev = coord.device
    in_tn = (views >= 0) & (views < tn)
    used = torch.zeros((b, tn), dtype=torch.uint8, device=dev)
    used.scatter_reduce_(1, torch.where(in_tn, views, torch.zeros_like(
        views)).long(), in_tn.to(torch.uint8), "amax")
    tgt = torch.arange(tn, device=dev)
    tgtb = tgt[None].expand(b, tn)
    ix, iy = cell_of(cams, cfg.level, cfg.csize, coord[:, None, :], tgtb)
    vis = is_visible(cams, cloud, grid, cfg.level, cfg.csize,
                     coord[:, None, :], normal[:, None, :], tgtb, ix, iy,
                     thr.neighbor)
    ic = project(cams.P[tgt][None], coord[:, None, :], cfg.level)
    edge = edge_at(pyr, tgt[None], cfg.level, ic[..., 0], ic[..., 1]) > 0.0
    cand = vis & edge & ~used.bool()
    order = torch.argsort((~cand).to(torch.uint8), dim=1,
                          stable=True)[:, :cap]
    got = torch.gather(cand, 1, order)
    vimages = torch.where(got, order, torch.full_like(order, -1)).to(
        torch.int32)
    vgrids = torch.stack([torch.gather(ix, 1, order),
                          torch.gather(iy, 1, order)], -1)
    if vimages.shape[1] < cap:
        pad = cap - vimages.shape[1]
        vimages = torch.nn.functional.pad(vimages, (0, pad), value=-1)
        vgrids = torch.nn.functional.pad(vgrids, (0, 0, 0, pad))
    return vimages, vgrids
